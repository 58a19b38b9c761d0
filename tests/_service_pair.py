"""The always-on service of both packages on one federation, for the
parity tests of ``repro_torch.launch.service``.

``sims(...)`` builds the reference's and the port's async simulators the
way ``default_service_sim`` does (the synthetic logreg federation over the
paper's planned schedule), on a problem of the caller's choosing: the
tests use ``CHEAP`` (``zeta = gamma = 2``: a* = 3, b* = 4, one sixth of
the default's local steps a wave), so a service run of a hundred events
takes seconds on the CPU.  ``jax_keys()`` makes the port's service draw
with the reference's keys; ``assert_same_trace`` holds two traces to each
other record by record.  JAX and the reference are imported only where
they are used, so ranks that build the port's simulator (``tsim``) do not
load them.
"""
import contextlib
from unittest import mock

import numpy as np

from repro_torch.core import plan as t_plan
from repro_torch.core.problem import HFLProblem as TProblem
from repro_torch.data import partition, synthetic
from repro_torch.fl.sim import HFLSimulator as TSim
from repro_torch.launch import service as ts
from repro_torch.models import lenet as t_lenet

UES, EDGES, S_MAX = 12, 3, 3
CHEAP = dict(zeta=2.0, gamma=2.0)
RTOL = 1e-6          # float32 draws: torch and XLA may differ by an ulp
ATOL = 1e-5          # the published model, as the other port parity tests


def _ue_data(prob, seed):
    n = int(prob.samples.sum())
    train = synthetic.logreg_data(seed=seed, n=n, dim=12, num_classes=4)
    parts = partition.size_partition(np.random.default_rng(seed), n,
                                     prob.samples.astype(int))
    return [{k: train[k][ix] for k in train} for ix in parts]


def jsim(ues=UES, edges=EDGES, s_max=S_MAX, seed=0, **problem):
    import jax

    from repro.core import plan as j_plan
    from repro.core.problem import HFLProblem as JProblem
    from repro.fl.sim import HFLSimulator as JSim
    from repro.models import lenet as j_lenet
    prob = JProblem(num_edges=edges, num_ues=ues, seed=seed, **problem)
    return JSim(j_plan(prob), lambda p, b: j_lenet.logreg_loss(p, b, l2=1e-3),
                j_lenet.logreg_init(jax.random.PRNGKey(seed), 12, 4),
                _ue_data(prob, seed), mode="async", max_staleness=s_max,
                staleness_decay=0.9, seed=seed)


def tsim(ues=UES, edges=EDGES, s_max=S_MAX, seed=0, mesh=None, **problem):
    """The port's simulator; ``mesh=`` (an ``AggMesh``) shards it."""
    prob = TProblem(num_edges=edges, num_ues=ues, seed=seed, **problem)
    return TSim(t_plan(prob), lambda p, b: t_lenet.logreg_loss(p, b, l2=1e-3),
                t_lenet.logreg_init(12, 4, device="cpu"),
                _ue_data(prob, seed), mode="async", max_staleness=s_max,
                staleness_decay=0.9, seed=seed, mesh=mesh, device="cpu")


@contextlib.contextmanager
def jax_keys():
    """The port's service draws its delay, fault and cohort streams with
    the reference's keys (``jax.random.PRNGKey(seed)``, what the reference
    makes of each seed)."""
    from _jax_key import JaxKey
    seeds = {"_delay_key": "delay_seed", "_fault_key": "fault_seed",
             "_sample_key": "sample_seed"}
    with contextlib.ExitStack() as stack:
        for name, attr in seeds.items():
            stack.enter_context(mock.patch.object(
                ts.HFLService, name,
                lambda self, attr=attr: JaxKey(getattr(self.config, attr))))
        yield


def segments(pkg, spec):
    """``[(scenario, load, duration), ...]`` as the package's Segments."""
    return tuple(pkg.Segment(n, float(load), float(d)) for n, load, d in spec)


def merges(svc, mass=False):
    return [(round(r["t"], 9), r["edge"], r["cycle"], r["stale"])
            + ((round(r["mass"], 9),) if mass else ())
            for r in svc.trace if r["kind"] == "merge"]


def assert_same_trace(got, want, rtol=RTOL):
    """Record for record: the same kinds and fields, every field but the
    clock's equal, and the clock's (``t``, ``latency``) within ``rtol`` of
    the trace's last time.  ``wall`` (a host timing) and ``path`` are not
    compared."""
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    scale = max([abs(r["t"]) for r in want] + [1.0])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), (i, g, w)
        for k, v in w.items():
            if k in ("wall", "path"):
                continue
            if k in ("t", "latency"):
                assert abs(g[k] - v) <= rtol * scale, (i, k, g, w)
            else:
                assert g[k] == v, (i, k, g, w)
