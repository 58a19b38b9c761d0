"""The port's fault processes (``repro_torch.core.faults``) against the JAX
package's: fed the reference's own uniforms and exponentials through the
port's key protocol (``JaxKey``), availability masks, attempt counts and
outage windows equal the reference's exactly and backoffs within rtol
1e-6; validation, null paths and ``FaultModel.is_null`` as the
reference; the port's own draws within 4 standard errors of the
reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _jax_key import JaxKey  # noqa: E402

from repro.core import assoc as j_assoc  # noqa: E402
from repro.core import faults as j_f  # noqa: E402
from repro.core.problem import HFLProblem as JProblem  # noqa: E402
from repro_torch.core import faults as t_f  # noqa: E402
from repro_torch.core import stochastic as t_st  # noqa: E402
from repro_torch.core.problem import HFLProblem as TProblem  # noqa: E402


@pytest.fixture(scope="module")
def probs():
    kw = dict(num_edges=3, num_ues=12, seed=0)
    jp, tp = JProblem(**kw), TProblem(**kw)
    return jp, tp, j_assoc.proposed(jp)


def test_constants_match_reference():
    assert (t_f.WAIT_FOR_ALL, t_f.DEADLINE_FAILOVER, t_f._BACKOFF_EXP_CAP) \
        == (j_f.WAIT_FOR_ALL, j_f.DEADLINE_FAILOVER, j_f._BACKOFF_EXP_CAP)


@pytest.mark.parametrize("proc", [
    ("BernoulliDropout", dict(rate=0.3)),
    ("BernoulliDropout", dict(rate=0.0)),
    ("MarkovChurn", dict(p_off=0.15, p_on=0.45)),
    ("MarkovChurn", dict(p_off=0.1, p_on=0.4)),
    ("MarkovChurn", dict(p_off=0.0, p_on=0.5))],
    ids=lambda p: "-".join(map(str, (p[0], *p[1].values()))))
def test_availability_equals_reference_on_its_uniforms(proc):
    cls, kw = proc
    k = jax.random.PRNGKey(1)
    t = getattr(t_f, cls)(**kw).sample_available(JaxKey(k), 60, 40)
    j = np.asarray(getattr(j_f, cls)(**kw).sample_available(k, 60, 40))
    assert t.dtype == torch.bool and t.shape == j.shape
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("rate", [0.25, 0.6, 0.0])
def test_uplink_attempts_and_backoff_equal_reference(rate):
    k = jax.random.PRNGKey(2)
    tl, jl = t_f.UplinkLoss(rate=rate, backoff=0.1), \
        j_f.UplinkLoss(rate=rate, backoff=0.1)
    t = tl.sample_attempts(JaxKey(k), (5000,))
    j = np.asarray(jl.sample_attempts(k, (5000,)))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_allclose(tl.total_backoff(t).numpy(),
                               np.asarray(jl.total_backoff(j)), rtol=1e-6,
                               atol=0)
    big = np.array([1, 2, 3, 1000])
    np.testing.assert_allclose(tl.total_backoff(big).numpy(),
                               np.asarray(jl.total_backoff(big)), rtol=1e-6)
    assert np.isfinite(tl.total_backoff(big).numpy()).all()


@pytest.mark.parametrize("kw,cycles", [
    (dict(rate=0.3, repair_cycles=2.0), 12),
    (dict(rate=0.05, repair_cycles=6.0), 64),
    (dict(rate=0.0), 8)])
def test_outage_windows_equal_reference(probs, kw, cycles):
    jp, tp, A = probs
    k = jax.random.PRNGKey(3)
    t = t_f.EdgeOutage(**kw).sample_windows(JaxKey(k), tp, A, 8, 3, cycles)
    j = j_f.EdgeOutage(**kw).sample_windows(k, jp, A, 8, 3, cycles)
    assert t == j
    if kw["rate"] >= 0.3:
        assert t, "30%/cycle over 12 cycles should produce windows"


def test_inactive_edges_have_no_windows():
    tp = TProblem(num_edges=3, num_ues=6, seed=2)
    A = np.zeros((6, 3), dtype=np.int64)
    A[:3, 0] = A[3:, 1] = 1                      # edge 2 has no members
    wins = t_f.EdgeOutage(rate=0.9).sample_windows(
        t_st.Key(0, device="cpu"), tp, A, 8, 3, 20)
    assert wins and all(m != 2 for m, _, _ in wins)


@pytest.mark.parametrize("ctor", [
    lambda f: f.BernoulliDropout(rate=1.5),
    lambda f: f.BernoulliDropout(rate=-0.1),
    lambda f: f.MarkovChurn(p_off=0.1, p_on=0.0),
    lambda f: f.MarkovChurn(p_off=1.2),
    lambda f: f.UplinkLoss(rate=1.0),
    lambda f: f.UplinkLoss(backoff=-1.0),
    lambda f: f.EdgeOutage(rate=2.0),
    lambda f: f.EdgeOutage(repair_cycles=0.0)])
def test_validation_as_reference(ctor):
    with pytest.raises(ValueError):
        ctor(t_f)
    with pytest.raises(ValueError):
        ctor(j_f)


def test_fault_model_null_and_fields_as_reference():
    for build in (lambda f: f.FaultModel(),
                  lambda f: f.FaultModel(dropout=f.BernoulliDropout(0.0),
                                         loss=f.UplinkLoss(0.0)),
                  lambda f: f.FaultModel(dropout=f.MarkovChurn(0.15, 0.45)),
                  lambda f: f.FaultModel(outage=f.EdgeOutage(0.05, 6.0)),
                  lambda f: f.FaultModel(loss=f.UplinkLoss(0.25, 0.05))):
        t, j = build(t_f), build(j_f)
        assert t.is_null() == j.is_null()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    k = t_st.Key(0, device="cpu")
    assert t_f.BernoulliDropout().sample_available(k, 3, 4).all()
    assert t_f.MarkovChurn(p_off=0.0).sample_available(k, 3, 4).all()
    assert (t_f.UplinkLoss().sample_attempts(k, (5,)) == 1).all()


def _within_4se(t, j):
    t, j = np.asarray(t, float).ravel(), np.asarray(j, float).ravel()
    se = np.sqrt(t.var() / t.size + j.var() / j.size)
    assert abs(t.mean() - j.mean()) <= 4 * se


def test_own_draws_match_reference_moments():
    """Availability, the churn's OFF-OFF persistence and attempt counts on
    the port's own keys, each within 4 standard errors of the
    reference's."""
    kt, kj = t_st.Key(5, device="cpu"), jax.random.PRNGKey(5)
    d = (t_f.BernoulliDropout(0.3), j_f.BernoulliDropout(0.3))
    _within_4se(d[0].sample_available(kt, 200, 50).numpy(),
                np.asarray(d[1].sample_available(kj, 200, 50)))
    c = (t_f.MarkovChurn(0.15, 0.45), j_f.MarkovChurn(0.15, 0.45))
    at = c[0].sample_available(kt, 400, 64).numpy()
    aj = np.asarray(c[1].sample_available(kj, 400, 64))
    _within_4se(at.mean(0), aj.mean(0))   # cycles correlate, UEs do not
    for a in (at, aj):
        off = ~a
        both = (off[:-1] & off[1:]).sum() / max(off[:-1].sum(), 1)
        assert both > off.mean() + 0.1     # OFF states chain
    u = (t_f.UplinkLoss(0.25), j_f.UplinkLoss(0.25))
    att = u[0].sample_attempts(kt, (5000,)).numpy()
    assert att.min() >= 1
    _within_4se(att, np.asarray(u[1].sample_attempts(kj, (5000,))))
    # the port's own draws are keyed: the same key, the same masks
    np.testing.assert_array_equal(
        c[0].sample_available(kt, 400, 64).numpy(), at)
