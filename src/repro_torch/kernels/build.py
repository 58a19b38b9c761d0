"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exports one C function ``<name>`` and compiles on
its own into ``_build/<name>-<hash>.so`` for Hopper (``sm_90a``).  The hash
covers the source, every header under ``csrc/`` that it includes (with
``#include "..."``, at any depth) and the flags, so an edited kernel or
header is rebuilt and an unchanged one is not.  Kernels are built at first use, never at import:
the CPU-only test machines have no ``nvcc``.  ``build()`` starts one
``nvcc`` per source, all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = ("segment_aggregate", "cloud_aggregate", "weighted_mean",
           "segment_sum", "flash_attention", "flash_attention_bf16",
           "rglru_scan", "decode_attention", "decode_attention_bf16")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_FUNCTIONS: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{cuda_home}/bin); the CUDA kernels cannot be "
                           "built")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _with_headers(path: Path) -> list:
    """``path`` and the headers it includes with quotes, at any depth,
    each once, in the order they are first included."""
    files = [path]
    for f in files:
        for name in _INCLUDE.findall(f.read_bytes()):
            header = f.parent / name.decode()
            if header not in files:
                files.append(header)
    return files


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is (to be) built."""
    h = hashlib.sha256()
    for f in _with_headers(CSRC / f"{name}.cu"):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source that is not built yet, in parallel.

    Returns ``{name: path of its .so}``.  The compiler's output (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel) is kept
    beside each library as ``.log``.  Raises ``RuntimeError`` with that
    output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: library_path(n) for n in names}
    jobs = []
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, target, tmp, proc in jobs:
        log = proc.communicate()[0]
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)       # atomic: a concurrent loader never
                                      # sees a half-written library
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def load(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``name`` of ``csrc/<name>.cu``, built if needed,
    with ``argtypes`` declared and an ``int`` (``cudaError_t``) result."""
    fn = _FUNCTIONS.get(name)
    if fn is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[name] = fn
    return fn
