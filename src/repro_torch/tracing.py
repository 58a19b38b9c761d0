"""Spans and counters of the port, on the profiler's clock, in one
registry.

**Spans.**  ``span(name)`` marks a stretch of the program's work at a
layer boundary (``PERF.md`` §3 lists each with its reader):

* ``fl/sim.py``: ``hfl.round`` (one sync round and its evaluation),
  ``hfl.local_gd`` (an edge iteration's local steps on every row),
  ``hfl.aggregate`` (eq. 6 and eq. 10), ``hfl.eval``;
* ``models/moe.py``: ``moe`` (``apply_moe``) and its stages
  ``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``,
  ``moe.shared``;
* ``models/transformer.py``: ``attn`` (a block's self-attention) and
  ``decode.cache_copy`` (the scanned stack's copy of its ring cache);
* ``models/model.py``: ``model.prefill`` and ``model.decode_step``.

A span is active only while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``); otherwise ``span`` returns one
shared no-op context and nothing is recorded.  An active span records
into two sinks:

* a range of its name on the profiler's host timeline (the clock of the
  device trace), nested as an aten op's range is, so a trace sees which
  layer the host was in, and which device operations the host queued
  inside it;
* the registry, one record a name: occurrences, host seconds
  (``perf_counter``, the spans' own bookkeeping kept out) and the
  enclosing spans' names.

A span queues nothing on the device: no timing event, no synchronise.  A
queued event would change where the host blocks on a full launch queue,
and with it how the profiler attributes kernels to host ranges.

**Counters.**  Kernel launches count always, in the dicts the
registry hands the wrappers (each wrapper's ``launch_counts``).  The MoE's
``moe.rows_computed`` (E·C a call), ``moe.picks`` (T·k) and
``moe.picks_kept`` count only while a profiler records; the last keeps
each call's ``keep`` mask and sums it when the registry is read
(``counters()``), so a traced step queues no device work of its own.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

#: ``keep`` masks waiting to be summed, at most: past it the oldest are
#: summed at once (on their device).
MAX_PENDING = 4096

#: Whether a profiler session records: the spans' and traced counters'
#: gate (a module global, so a test can force it off).
recording = torch.autograd._profiler_enabled

_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class SpanStats:
    count: int = 0
    host_s: float = 0.0
    parents: tuple = ()         # enclosing spans' names, in order seen


class Registry:
    """Span records, counters and kernel launch counts of one process.
    Spans open and close on the thread that runs the program's layers."""

    def __init__(self):
        self.launch_dicts: list = []          # each wrapper's launch_counts
        self.stack: list = []                 # names of the open spans
        self.own_s = 0.0                      # the spans' own host seconds
        self._counts: dict = {}
        self._spans: dict = {}
        self._masks = collections.deque()    # (name, bool tensor)

    def reset(self) -> None:
        """Every count and span record to nothing (launch names kept)."""
        for d in self.launch_dicts:
            d.update(dict.fromkeys(d, 0))
        self._counts.clear()
        self._spans.clear()
        self._masks.clear()

    def close(self, name: str, parent, host_s: float) -> None:
        st = self._spans.get(name)
        if st is None:
            st = self._spans[name] = SpanStats()
        st.count += 1
        st.host_s += host_s
        if parent not in st.parents:
            st.parents += (parent,)

    def add(self, name: str, n: int) -> None:
        self._counts[name] = self._counts.get(name, 0) + n

    def add_true(self, name: str, mask: torch.Tensor) -> None:
        self._masks.append((name, mask))
        while len(self._masks) > MAX_PENDING:
            self._sum_masks(1)

    def _sum_masks(self, n=None) -> None:
        for _ in range(len(self._masks) if n is None else n):
            name, mask = self._masks.popleft()
            self._counts[name] = (self._counts.get(name, 0)
                                  + int(mask.count_nonzero()))

    def spans(self) -> dict:
        """{name: {count, host_s, parents}}."""
        return {k: dataclasses.asdict(v) for k, v in self._spans.items()}

    def counters(self) -> dict:
        """{name: count} of the traced counters, every pending mask
        summed."""
        self._sum_masks()
        return dict(self._counts)


REGISTRY = Registry()


class _Span:
    __slots__ = ("name", "parent", "rf", "t0", "own0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        t = time.perf_counter()
        reg = REGISTRY
        self.parent = reg.stack[-1] if reg.stack else None
        reg.stack.append(self.name)
        # a function-scope range, as an aten op's: a ``record_function``
        # (user scope) range would also be laid on the device timeline,
        # where a trace would read it as a device operation
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        # the spans' own host time (this entry, the nested spans' entries
        # and exits) is kept out of every enclosing span's host seconds
        reg.own_s += self.t0 - t
        self.own0 = reg.own_s
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        reg = REGISTRY
        host_s = t1 - self.t0 - (reg.own_s - self.own0)
        self.rf.__exit__(*exc)
        reg.stack.pop()
        reg.close(self.name, self.parent, host_s)
        reg.own_s += time.perf_counter() - t1
        return False


def span(name: str):
    """A context marking the program's work ``name``: recorded while a
    profiler session records, else the shared no-op."""
    if not recording():
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the traced counter ``name`` while a profiler
    records."""
    if recording():
        REGISTRY.add(name, n)


def count_true(name: str, mask: torch.Tensor) -> None:
    """Add the true elements of ``mask`` to the traced counter ``name``
    while a profiler records; summed when the registry is read.  A mask
    inside a ``torch.func`` transform is not counted."""
    if recording() and \
            not torch._C._functorch.is_functorch_wrapped_tensor(mask):
        REGISTRY.add_true(name, mask)


def launch_counts(*names: str) -> dict:
    """A wrapper's ``launch_counts``: {kernel: launches} of its kernels,
    held by the registry (``launches``, ``reset``) and counted always."""
    counts = dict.fromkeys(names, 0)
    REGISTRY.launch_dicts.append(counts)
    return counts


def launches() -> dict:
    """{kernel: launches} of every wrapper's kernels."""
    out = {}
    for d in REGISTRY.launch_dicts:
        out.update(d)
    return out


def spans() -> dict:
    return REGISTRY.spans()


def counters() -> dict:
    return REGISTRY.counters()


def reset() -> None:
    REGISTRY.reset()
