"""The run's environment: cache directories inside the checkout, the
seed's forms, the chips a cell asks for, and the modules a run must not
load."""
from __future__ import annotations

import os
import sys

from harness.bench import HERE

#: Top-level module names that no run may load: JAX, its libraries and
#: the JAX package the port was made from.  Compared whole, so
#: ``repro_torch`` (the program) is not ``repro``.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: Fixed cache directories inside the checkout, so that only the first run
#: of a cell there compiles.  The program's own nvcc output stays where
#: the program puts it, ``src/repro_torch/kernels/_build/``, also inside
#: the checkout.
CACHE = HERE / ".cache"


def set_environment() -> None:
    """Point every build and kernel cache at fixed directories inside the
    checkout, and keep libraries from loading JAX by themselves.  Called
    before ``torch`` is imported."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in modules}
    return sorted(tops.intersection(FORBIDDEN))


def seed_forms(seed: int) -> dict:
    """The seed as each generator takes it: ``torch`` wants 0 .. 2**64-1,
    numpy any non-negative integer, the simulator's resampling a 32-bit
    one.  Any whole number maps onto them, the large ones too."""
    s = int(seed) % (2 ** 63)
    return {"torch": s, "numpy": s, "u32": s % (2 ** 32)}


def check_chips(need: int) -> str:
    """An empty string if CUDA shows at least ``need`` devices, else why
    not."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    n = torch.cuda.device_count()
    if n < need:
        return f"the cell asks for {need} CUDA devices, {n} found"
    return ""


def set_precision(tf32: bool) -> None:
    """Matrix products and convolutions in fp32 (TF32 off) unless the
    configuration states TF32."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
