"""The port's spans and counters (``repro_torch.tracing``) on the CPU.

A span records only while a ``torch.profiler`` session records; then it
is a function-scope profiler range nested in its enclosing span's and
one occurrence in the registry.  Tracing changes no output bit and queues no
operation of its own.  The MoE's counters equal a plain count from the
same routes, and the registry holds the wrappers' ``launch_counts``."""
import collections
import dataclasses
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.lenet_mnist import SMOKE_CONFIG  # noqa: E402
from repro_torch.core.problem import HFLProblem  # noqa: E402
from repro_torch.core.schedule import plan  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.fl.sim import HFLSimulator  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.models import lenet, moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

#: Every span the program opens, and the span it opens inside.
PARENT = {"hfl.round": None, "hfl.local_gd": "hfl.round",
          "hfl.aggregate": "hfl.round", "hfl.eval": "hfl.round",
          "model.prefill": None, "model.decode_step": None,
          "moe.route": "moe", "moe.dispatch": "moe", "moe.experts": "moe",
          "moe.combine": "moe", "moe.shared": "moe",
          "decode.cache_copy": "model.decode_step"}
UNDER_MODEL = ("moe", "attn")       # inside a prefill or a decode step
B, S, EDGES_B = 2, 12, 2


@pytest.fixture(autouse=True)
def _fresh_registry():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.reset()
    yield
    tracing.reset()
    torch.set_num_threads(n)


def _profiled(fn):
    """(fn(), the profiler's events) with a CPU profiler recording."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


# -- the three paths -------------------------------------------------------

# Each path sets up on the CPU and returns the call a test profiles, which
# returns the path's outputs.

def _lenet_round():
    """One sync cloud round of smoke LeNet (a=2, b=2): the final
    parameters, leaf by leaf, and the losses."""
    prob = HFLProblem(num_edges=2, num_ues=6, epsilon=0.25, seed=0)
    sch = dataclasses.replace(plan(prob), a=2, b=EDGES_B)
    train, test = synthetic.synthetic_mnist(seed=0, n_train=240, n_test=32)
    parts = partition.size_partition(np.random.default_rng(0), 240,
                                     sch.problem.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    params = lenet.lenet_init(torch.Generator().manual_seed(0), SMOKE_CONFIG,
                              device="cpu")
    sim = HFLSimulator(sch, lenet.lenet_loss, params, ue_data, lr=0.05,
                       samples_per_ue=8, seed=3, device="cpu")

    def run():
        res = sim.run(test, rounds=1)
        return [res.final_params[k][kk] for k in sorted(res.final_params)
                for kk in sorted(res.final_params[k])] + \
            [torch.tensor(res.train_loss), torch.tensor(res.test_loss)]
    return run


def _moe_model(cf=None):
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    model = Model(cfg, device="cpu", decode_margin=4)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    return model, model.init(0), tokens


def _moe_prefill():
    """A smoke Qwen1.5-MoE prefill: its last logits and K/V cache."""
    model, params, tokens = _moe_model()

    def run():
        logits, state = model.prefill(params, {"tokens": tokens})
        return [logits] + [state["scanned"][k] for k in ("k", "v")]
    return run


def _decode_step():
    """One decode step after a smoke prefill: its logits and new state."""
    model, params, tokens = _moe_model()
    _, state = model.prefill(params, {"tokens": tokens})

    def run():
        logits, new = model.decode_step(params, state, tokens[:, -1:])
        return [logits] + [new["scanned"][k]
                           for k in ("k", "v", "slot_pos")]
    return run


PATHS = {"lenet_round": _lenet_round, "moe_prefill": _moe_prefill,
         "decode_step": _decode_step}


# -- spans -------------------------------------------------------------------

def test_an_inactive_span_is_the_shared_noop_and_records_nothing():
    first, second = tracing.span("moe"), tracing.span("hfl.round")
    assert first is second is tracing._OFF
    with first, second:
        tracing.count("moe.picks", 3)
        tracing.count_true("moe.picks_kept", torch.ones(4, dtype=torch.bool))
    assert tracing.spans() == {} and tracing.counters() == {}
    _moe_prefill()()
    assert tracing.spans() == {} and tracing.counters() == {}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_in_their_parents_and_count_the_calls(path):
    """Every span the path opens is a profiler range whose enclosing range
    is its parent span, and the registry counts each as often as the
    path calls it, under the same parent."""
    _, events = _profiled(PATHS[path]())
    got = tracing.spans()
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    L = cfg.num_layers
    want = {
        "lenet_round": {"hfl.round": 1, "hfl.local_gd": EDGES_B,
                        "hfl.aggregate": EDGES_B + 1, "hfl.eval": 1},
        "moe_prefill": {"model.prefill": 1, "moe": L, "attn": L,
                        **{f"moe.{s}": L for s in ("route", "dispatch",
                                                   "experts", "combine",
                                                   "shared")}},
        "decode_step": {"model.decode_step": 1, "decode.cache_copy": 1,
                        "moe": L, "attn": L,
                        **{f"moe.{s}": L for s in ("route", "dispatch",
                                                   "experts", "combine",
                                                   "shared")}},
    }[path]
    assert {k: v["count"] for k, v in got.items()} == want
    unit = "model.prefill" if path == "moe_prefill" else "model.decode_step"
    seen = collections.Counter()
    for e in events:
        if e.name not in want:
            continue
        parent = e.cpu_parent.name if e.cpu_parent is not None else None
        expect = unit if e.name in UNDER_MODEL else PARENT[e.name]
        assert parent == expect, (e.name, parent)
        # function scope, as an aten op's: no user annotation that a
        # device trace would lay on its timeline
        assert e.scope == int(torch._C._profiler.RecordScope.FUNCTION)
        assert got[e.name]["parents"] == (expect,)
        seen[e.name] += 1
    assert dict(seen) == want
    for v in got.values():
        assert v["host_s"] > 0


@pytest.mark.parametrize("path", sorted(PATHS))
def test_tracing_leaves_every_output_bit_equal(path):
    plain = PATHS[path]()()
    traced, _ = _profiled(PATHS[path]())
    assert tracing.spans()
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_traced_path_adds_no_operation_of_its_own(path, monkeypatch):
    """The aten operations a profiled path runs are the same, one for one
    and in order, with its spans and counters recording and with them
    forced off."""
    def ops(events):
        return [e.name for e in events if e.name.startswith("aten::")]
    _, on = _profiled(PATHS[path]())
    assert tracing.spans()
    monkeypatch.setattr(tracing, "recording", lambda: False)
    tracing.reset()
    _, off = _profiled(PATHS[path]())
    assert tracing.spans() == {}
    assert ops(on) == ops(off) and ops(on)


def test_registry_reads_count_spans_across_sessions():
    """Occurrences and seconds add up over profiler sessions until
    ``reset``."""
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("moe"):
                pass
    assert tracing.spans()["moe"]["count"] == 3
    tracing.reset()
    assert tracing.spans() == {}


def test_host_seconds_leave_out_the_spans_own_time(monkeypatch):
    """A span's host seconds are its body's: the time its nested spans
    take to open and close themselves is kept out.  On a clock that ticks
    a second a reading, each stretch between two readings is one second of
    work: the outer span's body holds five, each inner one's one."""
    clock = itertools.count()
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(clock))))
    monkeypatch.setattr(tracing, "recording", lambda: True)
    with tracing.span("moe"):
        for _ in range(2):
            with tracing.span("moe.route"):
                pass
    got = tracing.spans()
    assert got["moe"]["host_s"] == 5.0
    assert got["moe.route"]["host_s"] == 2.0
    assert got["moe.route"]["count"] == 2


def test_an_active_span_queues_nothing_on_the_device(monkeypatch):
    """With CUDA in use, an active span makes no timing event and
    synchronises nothing: what a span adds to a trace is host ranges."""
    def refuse(*a, **k):
        raise AssertionError("a span touched the device")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with tracing.span("moe"):
                with tracing.span("moe.route"):
                    pass
    got = tracing.spans()
    assert got["moe"]["count"] == got["moe.route"]["count"] == 3
    assert set(got["moe"]) == {"count", "host_s", "parents"}


# -- counters ----------------------------------------------------------------

@pytest.mark.parametrize("cf", [None, 0.5])
def test_moe_counters_equal_a_plain_count_from_the_same_routes(
        cf, monkeypatch):
    """``moe.rows_computed`` is E·C a call and ``moe.picks`` T·k;
    ``moe.picks_kept`` equals the picks each expert keeps (the first C
    dealt to it) counted from the routes the same calls took."""
    model, params, tokens = _moe_model(cf)
    cfg = model.cfg
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    routes, route = [], moe._route

    def recorded(*a, **kw):
        out = route(*a, **kw)
        routes.append(out[1])
        return out
    monkeypatch.setattr(moe, "_route", recorded)
    _profiled(lambda: model.prefill(params, {"tokens": tokens}))
    T = B * S
    C = moe._capacity(T, E, k, cfg.capacity_factor)
    kept = sum(int(np.minimum(np.bincount(r.reshape(-1).numpy(),
                                          minlength=E), C).sum())
               for r in routes)
    got = tracing.counters()
    assert len(routes) == cfg.num_layers
    assert got == {"moe.rows_computed": E * C * len(routes),
                   "moe.picks": T * k * len(routes),
                   "moe.picks_kept": kept}
    if cf == 0.5:
        assert kept < T * k * len(routes)       # some picks dropped


def test_pending_masks_stay_bounded(monkeypatch):
    """Past ``MAX_PENDING`` waiting masks the oldest are summed at once;
    the total is the same."""
    monkeypatch.setattr(tracing, "MAX_PENDING", 2)
    masks = [torch.arange(8) < n for n in (1, 3, 5, 7, 8)]
    with profile(activities=[ProfilerActivity.CPU]):
        for m in masks:
            tracing.count_true("moe.picks_kept", m)
            assert len(tracing.REGISTRY._masks) <= 2
    assert tracing.counters() == {"moe.picks_kept": 24}


def test_a_mask_inside_a_transform_is_not_counted():
    masks = torch.ones(3, 4, dtype=torch.bool)

    def f(m):
        tracing.count_true("moe.picks_kept", m)
        return m.sum()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.func.vmap(f)(masks)
    assert tracing.counters() == {}


def test_launch_counts_are_held_by_one_registry():
    """Each wrapper's ``launch_counts`` is a dict of its own kernels that
    the registry holds: ``launches`` reads them all, ``reset`` zeroes
    them all."""
    held = {ha: ("segment_aggregate", "cloud_aggregate", "segment_sum",
                 "weighted_mean"),
            fa: ("flash_attention", "flash_attention_bf16"),
            da: ("decode_attention", "decode_attention_bf16"),
            rs: ("rglru_scan",)}
    assert set(tracing.launches()) == {n for v in held.values() for n in v}
    for mod, names in held.items():
        assert mod.launch_counts == dict.fromkeys(names, 0)
        assert any(d is mod.launch_counts
                   for d in tracing.REGISTRY.launch_dicts)
    ha.launch_counts["segment_sum"] += 1
    fa.launch_counts["flash_attention_bf16"] += 2
    assert tracing.launches()["segment_sum"] == 1
    assert tracing.launches()["flash_attention_bf16"] == 2
    tracing.reset()
    assert set(tracing.launches().values()) == {0}
    assert fa.launch_counts == {"flash_attention": 0,
                                "flash_attention_bf16": 0}
