"""The metrics that read the program's own spans and counters
(``repro_torch.tracing``): at the smoke sizes with ``--trace 1`` each
registry reader reads a float in its cell and the spans that the device
readers read are ranges of the profiled slice, the harness's own route
record still records, the device readers take the operations queued
inside a span's ranges, and on a program without those spans every
reader returns None."""
import functools
import sys

import pytest

from _cells import smoke_run
from harness import bench

#: The readers of device time (``harness.program.device_per_unit``), with
#: the span and unit ranges each reads: on the CPU the slice holds no
#: device operation, so these read only on a card.
DEVICE = {"local_gd_s.round": ("hfl.local_gd", "hfl.round"),
          "eval_s.round": ("hfl.eval", "hfl.round"),
          "dispatch_ms.prefill": ("moe.dispatch", "model.prefill"),
          "experts_ms.prefill": ("moe.experts", "model.prefill"),
          "cache_copy_ms.decode": ("decode.cache_copy", "model.decode_step")}
NEW = {"lenet-sync-paper": ("local_gd_s.round", "eval_s.round"),
       "qwen-moe-prefill-4k": ("dispatch_ms.prefill", "experts_ms.prefill",
                               "moe_fill.prefill"),
       "qwen-moe-decode-b32": ("moe_issue_ms.decode", "moe_issue_share.decode",
                               "launches.decode", "cache_copy_ms.decode")}


def _keep_rec(into: dict):
    """An entry hook that keeps the window's record in ``into``."""
    def hook(entry):
        window = entry.window

        def kept(seconds):
            rec = window(seconds)
            into.update(rec)
            return rec
        entry.window = kept
    return hook


@pytest.mark.parametrize("cell", sorted(NEW))
def test_program_span_metrics_read_in_their_cells(capsys, monkeypatch, cell):
    """On the CPU no device operation is recorded, so the harness would
    profile its slice again and again (it does so on a card only when the
    profiler drops a session), and a smoke batch has no decode step left
    by the third slice: here the slice is profiled once, as on a card."""
    from harness import trace
    from repro_torch import tracing
    monkeypatch.setattr(trace, "profile_slice",
                        functools.partial(trace.profile_slice, attempts=1))
    tracing.reset()
    rec = {}
    # a window long enough to pass a decode boundary where the profiled
    # slice fits in the batch, on a loaded host too
    line = smoke_run(capsys, cell, trace=1, seconds=3.0, hook=_keep_rec(rec))
    ranges = {n for _, _, n in rec["trace"]["host"]}
    for name in NEW[cell]:
        if name in DEVICE:
            assert set(DEVICE[name]) <= ranges, name
        else:
            assert isinstance(line["metrics"][name]["value"], float), name
    if cell == "qwen-moe-decode-b32":
        # the harness's patched ``moe._route`` still sees every call
        assert rec["experts_picked"] is not None
        assert "mfu.decode" in line["metrics"]
        assert 0 < line["metrics"]["moe_issue_share.decode"]["value"] < 100
    if cell == "qwen-moe-prefill-4k":
        assert 0 < line["metrics"]["moe_fill.prefill"]["value"] <= 100
    assert line["correct"] is True


def test_every_new_metric_is_declared_for_its_cell():
    b = bench.load_benchmark()
    for cell, names in NEW.items():
        c = bench.resolve(b, cell)
        assert set(names) <= {m["name"] for m in c.per_layer}


def test_readers_find_nothing_in_a_program_without_spans(monkeypatch):
    """A tree of the program without ``repro_torch.tracing``: no reader
    raises, each returns None."""
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    rec = {"trace": {"host": [(0.0, 5.0, "aten::mm"),
                              (1.0, 2.0, "cudaLaunchKernel")]},
           "slice_counted": [40, 41]}
    for names in NEW.values():
        for name in names:
            assert bench.metric_module(name).read(rec) is None, name


def test_launches_count_the_calls_inside_decode_steps():
    """Kernel launches, copies and fills inside the ``model.decode_step``
    ranges, over the profiled steps; other runtime calls and calls
    between steps are not counted."""
    host = [(0.0, 10.0, "model.decode_step"), (1.0, 1.1, "cudaLaunchKernel"),
            (2.0, 2.1, "cuLaunchKernelEx"), (3.0, 3.1, "cudaMemcpyAsync"),
            (4.0, 4.1, "cudaMemsetAsync"), (5.0, 5.1, "cudaEventRecord"),
            (6.0, 6.1, "cudaLaunchCooperativeKernel"),
            (11.0, 11.1, "cudaLaunchKernel"),
            (20.0, 30.0, "model.decode_step"), (21.0, 21.1, "cudaGraphLaunch"),
            (22.0, 22.1, "aten::mm")]
    rec = {"trace": {"host": host}, "slice_counted": [7, 8]}
    assert bench.metric_module("launches.decode").read(rec) == 3.0


def test_device_readers_take_the_operations_queued_inside_the_spans():
    """The i-th queuing call of the slice started its i-th device
    operation: a span's device time is that of the operations whose calls
    lie inside its ranges (any thread), the union of their intervals in a
    range, over the unit's ranges; calls that queue nothing (an event
    record) are not counted."""
    host = [(0.0, 100.0, "model.prefill"),
            (1.0, 1.1, "cudaLaunchKernel"),               # op 0, outside
            (10.0, 20.0, "moe.dispatch"),
            (11.0, 11.1, "cudaLaunchKernel"),             # op 1
            (12.0, 12.1, "cudaEventRecord"),
            (13.0, 13.1, "cuLaunchKernelEx"),             # op 2
            (30.0, 40.0, "moe.dispatch"),
            (31.0, 31.1, "cudaMemcpyAsync"),              # op 3
            (50.0, 50.1, "cudaMemsetAsync"),              # op 4, outside
            (200.0, 300.0, "model.prefill")]
    # k1 and k2 run at once on two streams: their union counts
    ops = [("k0", 5.0, 6.0), ("k1", 20.0, 24.0), ("k2", 22.0, 30.0),
           ("copy", 40.0, 41.0), ("fill", 60.0, 64.0)]
    rec = {"trace": {"host": host, "kernels": ops}}
    got = bench.metric_module("dispatch_ms.prefill").read(rec)
    assert got == pytest.approx(1e3 * (10.0 + 1.0) / 1e6 / 2)
    assert bench.metric_module("experts_ms.prefill").read(rec) is None
