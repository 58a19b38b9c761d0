"""Checkpointing: pytree <-> npz, ported from the JAX package's
``repro/checkpoint/npz.py`` with the on-disk format kept key for key.

Flat key encoding: path segments joined with '/'; list indices appear as
'[i]'; a ``None`` leaf is an int8 zero under ``<path>#none``.  Torch
leaves are written as ``t.detach().cpu().numpy()``, so a file written by
either package loads in the other.  Restoring rebuilds the exact tree
structure from the keys, then (optionally) places each leaf on its
``target`` tensor's device and dtype, matched by key.

Durability: ``save_pytree`` is ATOMIC — it writes ``path + ".tmp"``, fsyncs
it and ``os.replace``s it over the final name, so a crash (or ``kill -9``)
mid-save can never destroy the previous checkpoint: readers see either the
old complete file or the new complete file, never a torn one.
``load_pytree`` raises ``CheckpointError`` with a clear message on a
corrupted/truncated file instead of surfacing a zipfile traceback, and
``latest_checkpoint``/``list_checkpoints`` discover cadence-numbered
checkpoints (``<prefix><n>.npz``) so a resuming service can fall back to
the newest VALID file.

Service checkpoint schema (``repro_torch.launch.service``, version 2, the
same as the JAX package's) — a nested pytree saved through this module:

    flat        (N, F) f32           UE-replica flat buffer
    g           (F,) f32             published cloud model vector
    engine/...                       ``events.AsyncEngine.snapshot()``
                                     (heap_t/edge/cycle, completed,
                                     dep_version, dep_time, version,
                                     delivered, gated, pending_*,
                                     max_staleness, version_tag)
    queue/...                        pending merge jobs (t_arr, t_dep,
                                     edge, cycle, stale, applied_at_arr,
                                     mass, rows)
    dep/...                          departure times of cycles in flight
    dead/...                         in-flight cycles whose cohort died
    svc/...                          scalar control-plane state (clock,
                                     busy_until, counters, degraded flag,
                                     announced segment, checkpoint count)
    metrics/...                      latency/backlog accumulators
    trace_json  0-d unicode          service trace records (JSON)

with ``__meta__/schema`` carrying the service schema version and
``__meta__/config`` the full JSON config echo (validated on resume).
"""
from __future__ import annotations

import os
import re
import zipfile
from typing import Any, List, Optional

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint file exists but cannot be read (corrupt/truncated)."""


def _host(node) -> np.ndarray:
    """A leaf as a host array; a tensor whose dtype numpy lacks raises."""
    if torch.is_tensor(node):
        try:
            return node.detach().cpu().numpy()
        except TypeError as e:
            raise TypeError(
                f"cannot checkpoint a {node.dtype} tensor: numpy has no such "
                f"dtype and the npz format keeps leaves as numpy arrays; "
                f"convert it first (e.g. .float())") from e
    return np.asarray(node)


def _walk(tree, leaf):
    """``{flat key: leaf(node)}`` in the key encoding above: dict keys in
    sorted order, list and tuple items by index, ``None`` under
    ``#none``."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}[{i}]", v)
        elif node is None:
            flat[prefix + "#none"] = np.zeros((), np.int8)
        else:
            flat[prefix] = leaf(node)

    rec("", tree)
    return flat


def save_pytree(path: str, tree, metadata: Optional[dict] = None) -> str:
    """Atomically write ``tree`` (+ optional metadata) as an npz.

    The payload lands in ``path + ".tmp"`` first and is fsync'd, then
    ``os.replace``d over the final name — on any crash the previous
    checkpoint survives intact and at most a ``*.tmp`` orphan is left
    behind (never a torn ``.npz``).  Returns the final path.
    """
    flat = _walk(tree, _host)
    if metadata:
        for k, v in metadata.items():
            flat[f"__meta__/{k}"] = _host(v)
    final = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(final)), exist_ok=True)
    tmp = final + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return final


_IDX = re.compile(r"^(.*)\[(\d+)\]$")


def _insert(root, key: str, value):
    """Insert value at the '/'-and-'[i]' encoded path."""
    parts = key.split("/")

    def ensure(container, k, nxt):
        if isinstance(container, dict):
            if k not in container:
                container[k] = nxt
            return container[k]
        while len(container) <= k:
            container.append(None)
        if container[k] is None:
            container[k] = nxt
        return container[k]

    cur = root
    for i, part in enumerate(parts):
        last = i == len(parts) - 1
        steps = []
        rest = part
        while (m := _IDX.match(rest)):
            rest, idx = m.group(1), int(m.group(2))
            steps.append(idx)
        steps = steps[::-1]
        # rest is the dict key (may be '' if pure index chain)
        chain = ([("d", rest)] if rest else []) + [("l", s) for s in steps]
        for j, (kind, k) in enumerate(chain):
            leaf_here = last and j == len(chain) - 1
            if leaf_here:
                if kind == "d":
                    cur[k] = value
                else:
                    while len(cur) <= k:
                        cur.append(None)
                    cur[k] = value
            else:
                if j + 1 < len(chain):
                    nxt_kind = chain[j + 1][0]
                else:
                    after = parts[i + 1]
                    nxt_kind = ("l" if _IDX.match(after)
                                and not after[0].isalpha() else "d")
                nxt = [] if nxt_kind == "l" else {}
                cur = ensure(cur, k, nxt)
    return root


def _place(tree, flat: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``flat``'s array of
    the same key: on the target tensor's device and dtype, or a host
    array where the target leaf is not a tensor."""
    if isinstance(tree, dict):
        return {k: _place(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_place(v, flat, f"{prefix}[{i}]") for i, v in enumerate(tree)]
        return type(tree)(out)
    if tree is None:
        return None
    arr = flat[prefix]
    if torch.is_tensor(tree):
        return torch.as_tensor(np.array(arr)).to(device=tree.device,
                                                 dtype=tree.dtype)
    return arr


def load_pytree(path: str, target: Any = None):
    """Load an npz checkpoint; returns ``(tree, metadata)``.

    With ``target`` (a tree of tensors or arrays with the checkpoint's
    keys), the structure is taken from ``target`` and each leaf is matched
    to it by key and placed on the target tensor's device and dtype; a
    target with other keys than the file raises ``ValueError``."""
    p = path if path.endswith(".npz") else path + ".npz"
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    try:
        # np.load on an npz is lazy per entry; force every member through
        # so truncation anywhere in the archive surfaces HERE, as one
        # clear CheckpointError, not as a zipfile traceback at first use.
        data = np.load(p, allow_pickle=False)
        flat = {k: data[k] for k in data.files
                if not k.startswith("__meta__/")}
        meta = {k[len("__meta__/"):]: data[k] for k in data.files
                if k.startswith("__meta__/")}
    except (zipfile.BadZipFile, ValueError, EOFError, OSError, KeyError) as e:
        raise CheckpointError(
            f"checkpoint {p} is corrupted or truncated ({e}).  Saves are "
            f"atomic (tmp+rename), so this file was damaged after the "
            f"write — or predates the atomic writer; fall back to an "
            f"earlier checkpoint (see list_checkpoints).") from e

    if target is not None:
        want = set(_walk(target, lambda node: None))
        if want != set(flat):
            raise ValueError(
                f"target's keys do not match checkpoint {p}: missing from "
                f"the file {sorted(want - set(flat))}, not in the target "
                f"{sorted(set(flat) - want)}")
        return _place(target, flat), meta

    root: dict = {}
    for k, v in sorted(flat.items()):
        if k.endswith("#none"):
            _insert(root, k[:-5], None)
        else:
            _insert(root, k, v)
    return root, meta


# ---------------------------------------------------------------------------
# Cadence-numbered checkpoint discovery (the always-on service).
# ---------------------------------------------------------------------------

_CKPT = re.compile(r"^(?P<prefix>.*?)(?P<num>\d+)\.npz$")


def list_checkpoints(ckpt_dir: str, prefix: str = "ckpt-") -> List[str]:
    """Paths of ``<prefix><n>.npz`` files in ``ckpt_dir``, ascending by
    ``n``.  ``*.tmp`` orphans (crashed mid-save) are ignored.  Returns
    ``[]`` for a missing or empty directory."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT.match(name)
        if m and m.group("prefix") == prefix:
            found.append((int(m.group("num")), name))
    return [os.path.join(ckpt_dir, name) for _, name in sorted(found)]


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt-") -> Optional[str]:
    """Newest cadence-numbered checkpoint path, or None.

    Purely name-based — pair with ``load_pytree``'s ``CheckpointError``
    and fall back through ``list_checkpoints`` when the newest file turns
    out to be damaged."""
    paths = list_checkpoints(ckpt_dir, prefix)
    return paths[-1] if paths else None


def gc_checkpoints(ckpt_dir: str, keep_last_k: int,
                   prefix: str = "ckpt-") -> List[str]:
    """Compact the cadence directory down to the newest ``keep_last_k``
    checkpoints.  Returns the paths it deleted (oldest first).

    Crash safety rests on the DELETION ORDER: victims are removed oldest
    first (delete-newest-last), so a crash at ANY point of the delete
    sequence leaves the surviving files as a suffix of the cadence — the
    newest ``keep_last_k`` generations are intact and every gap sits
    strictly BELOW the oldest survivor.  ``restore_latest``-style readers
    (newest first, falling back on ``CheckpointError``) therefore always
    find the same restore frontier they would have found had the GC
    completed; an interrupted GC only means the next GC pass has more
    old files to collect.

    A missing victim (already collected by a concurrent/previous pass)
    is skipped, not an error.  ``keep_last_k`` must be >= 1 — a GC that
    could delete the newest checkpoint would defeat the whole durability
    story; disable GC by not calling this instead.
    """
    if keep_last_k < 1:
        raise ValueError(f"keep_last_k must be >= 1 to garbage-collect "
                         f"(the newest checkpoint is never deletable), "
                         f"got {keep_last_k}")
    paths = list_checkpoints(ckpt_dir, prefix)
    deleted: List[str] = []
    for path in paths[:-keep_last_k]:     # ascending: oldest deleted first
        try:
            os.remove(path)
        except FileNotFoundError:
            continue
        deleted.append(path)
    return deleted
