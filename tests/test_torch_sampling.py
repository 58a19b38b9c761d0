"""The port's client sampling (``repro_torch.fl.sampling``) against the JAX
package's ``repro.fl.sampling``.

* Fed the reference's own Gumbel and uniform variates (``JaxKey``), every
  sampler's masks equal the reference's exactly, and its inclusion
  probabilities and inverse-propensity weights (float64 numpy in both
  packages) equal them too; ``participation_weights`` lies within float32
  rounding (rtol 1e-6) of the reference's.
* The properties of ``tests/test_sampling_props.py`` hold for the port's
  own draws: the reweighted sampled edge mean within 4 standard errors of
  the full mean, a full rate gives the eligibility mask, mass preserved
  per edge, faults compose without NaN (a dead cohort gives exact zeros,
  also through the plain eq. 6 aggregation), pad rows of the port's
  ``ShardedFlatLayout`` are never sampled, and the weight-proportional
  pad propensity is exactly 0.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _jax_key import JaxKey  # noqa: E402

from repro.fl import sampling as j_s  # noqa: E402
from repro_torch import fl as t_fl  # noqa: E402
from repro_torch.fl import aggregate as t_agg  # noqa: E402
from repro_torch.fl import flatten as t_flatten  # noqa: E402
from repro_torch.fl import sampling as t_s  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402

SAMPLER_NAMES = sorted(t_s.SAMPLERS)
CPU = dict(device="cpu")


def _fleet(seed, n=64, m=4):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, m, n)
    gid[:m] = np.arange(m)              # every edge nonempty
    w = rng.uniform(0.5, 2.0, n)
    return w, gid


def test_registry_and_validation_as_reference():
    assert sorted(j_s.SAMPLERS) == SAMPLER_NAMES
    for name in SAMPLER_NAMES:
        t, j = (t_s.make_sampler(name, 0.3), j_s.make_sampler(name, 0.3))
        assert t.name == j.name and t.is_full() == j.is_full()
        assert t_s.make_sampler(name, 1.0).is_full()
    assert t_s.make_sampler("pareto", 0.2, alpha=3.0).alpha == 3.0
    for bad in (lambda s: s.make_sampler("bogus", 0.5),
                lambda s: s.UniformSampler(participation_rate=0.0),
                lambda s: s.UniformSampler(participation_rate=1.5),
                lambda s: s.UniformSampler(min_per_edge=0),
                lambda s: s.ParetoSampler(alpha=0.0)):
        with pytest.raises(ValueError):
            bad(t_s)
        with pytest.raises(ValueError):
            bad(j_s)
    assert t_fl.make_sampler is t_s.make_sampler


@pytest.mark.parametrize("rate", [0.05, 0.3, 0.7])
@pytest.mark.parametrize("name", SAMPLER_NAMES)
def test_masks_equal_reference_on_its_draws(name, rate):
    w, gid = _fleet(3, n=80, m=5)
    w[[7, 30]] = 0.0                    # ineligible rows
    t, j = t_s.make_sampler(name, rate), j_s.make_sampler(name, rate)
    k = jax.random.PRNGKey(11)
    tm = t.sample_rounds(JaxKey(k), w, gid, 5, 12)
    jm = np.asarray(j.sample_rounds(k, w, gid, 5, 12))
    assert tm.dtype == bool and tm.shape == (12, 80)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(t.sample_mask(JaxKey(k), w, gid, 5),
                                  np.asarray(j.sample_mask(k, w, gid, 5)))
    np.testing.assert_array_equal(t.inclusion_probs(JaxKey(k), w, gid, 5),
                                  j.inclusion_probs(k, w, gid, 5))
    np.testing.assert_array_equal(t.ipw_base_weights(JaxKey(k), w, gid, 5),
                                  j.ipw_base_weights(k, w, gid, 5))
    assert t_s.expected_cohort(w, gid, 5, rate) == \
        j_s.expected_cohort(w, gid, 5, rate) == int(tm[0].sum())


@pytest.mark.parametrize("name", SAMPLER_NAMES)
def test_participation_weights_equal_reference(name):
    w, gid = _fleet(5)
    s = j_s.make_sampler(name, 0.3)
    k = jax.random.PRNGKey(2)
    part = np.asarray(s.sample_mask(k, w, gid, 4))
    surv = np.random.default_rng(5).random(w.shape[0]) > 0.3
    pi = s.inclusion_probs(k, w, gid, 4)
    for kw in ({}, dict(survivors=surv), dict(propensity=pi),
               dict(survivors=surv, propensity=pi)):
        t = t_s.participation_weights(w, part, gid, 4, **kw, **CPU)
        j = np.asarray(j_s.participation_weights(w, part, gid, 4, **kw))
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", SAMPLER_NAMES)
def test_sampled_aggregate_within_clt(name):
    """The inverse-propensity reweighted sampled edge mean over 400 rounds
    of the port's own draws matches the full-participation mean within 4
    standard errors, and the calibrated inclusion probabilities track the
    empirical frequencies."""
    rng = np.random.default_rng(7)
    n, m, rounds = 200, 4, 400
    gid = rng.integers(0, m, n)
    w = rng.uniform(0.5, 2.0, n)
    x = rng.normal(0.0, 1.0, n)
    sampler = t_s.make_sampler(name, participation_rate=0.3)
    part = sampler.sample_rounds(0, w, gid, m, rounds, **CPU)
    pi = sampler.inclusion_probs(0, w, gid, m, **CPU)
    assert np.abs(part.mean(0) - pi).max() < 0.12
    w_m = np.bincount(gid, weights=w, minlength=m)
    full = np.bincount(gid, weights=w * x, minlength=m) / w_m
    ests = np.zeros((rounds, m))
    for r in range(rounds):
        wp = t_s.participation_weights(w, part[r], gid, m, propensity=pi,
                                       **CPU).numpy()
        ests[r] = np.bincount(gid, weights=wp * x, minlength=m) / w_m
    err = np.abs(ests.mean(0) - full)
    se = ests.std(0) / np.sqrt(rounds)
    assert np.all(err <= 4.0 * se + 1e-6), (name, err, se)


@pytest.mark.parametrize("name", SAMPLER_NAMES)
def test_full_rate_masks_are_eligibility(name):
    w, gid = _fleet(0)
    w[5] = 0.0
    s = t_s.make_sampler(name, participation_rate=1.0)
    part = s.sample_rounds(3, w, gid, 4, 6)     # no key is made
    assert np.array_equal(part, np.tile(w > 0, (6, 1)))
    wp = t_s.participation_weights(w, part[0], gid, 4, **CPU).numpy()
    assert np.array_equal(wp, np.asarray(w, np.float32) *
                          (w > 0).astype(np.float32))
    assert np.array_equal(s.inclusion_probs(3, w, gid, 4), (w > 0) * 1.0)
    assert np.array_equal(s.ipw_base_weights(3, w, gid, 4), w)


@given(seed=st.integers(0, 30), name=st.sampled_from(SAMPLER_NAMES),
       rate=st.sampled_from([0.05, 0.2, 0.5, 0.9]))
@settings(max_examples=30, deadline=None)
def test_mass_preserved_per_edge(seed, name, rate):
    w, gid = _fleet(seed)
    s = t_s.make_sampler(name, participation_rate=rate)
    part = s.sample_mask(seed, w, gid, 4, **CPU)
    assert part[w > 0].sum() >= 1       # min_per_edge floor
    wp = t_s.participation_weights(w, part, gid, 4, **CPU).numpy()
    full = np.bincount(gid, weights=w, minlength=4)
    kept = np.bincount(gid, weights=wp, minlength=4)
    np.testing.assert_allclose(kept, full, rtol=1e-5)
    assert np.all(wp[~part] == 0.0)


@given(seed=st.integers(0, 30), rate=st.sampled_from([0.1, 0.4]),
       kill_edge=st.integers(0, 3))
@settings(max_examples=30, deadline=None)
def test_faults_compose_without_nan(seed, rate, kill_edge):
    w, gid = _fleet(seed)
    s = t_s.make_sampler("uniform", participation_rate=rate)
    part = s.sample_mask(seed, w, gid, 4, **CPU)
    rng = np.random.default_rng(seed)
    surv = rng.random(w.shape[0]) > 0.5
    surv[gid == kill_edge] = False      # one edge fully dead
    wp = t_s.participation_weights(w, part, gid, 4, survivors=surv,
                                   **CPU).numpy()
    assert np.all(np.isfinite(wp))
    assert np.all(wp[gid == kill_edge] == 0.0)
    assert np.all(wp[~(part & surv)] == 0.0)
    full = np.bincount(gid, weights=w, minlength=4)
    kept = np.bincount(gid, weights=wp, minlength=4)
    alive = np.bincount(gid[part & surv], minlength=4) > 0
    np.testing.assert_allclose(kept[alive], full[alive], rtol=1e-5)
    assert np.all(kept[~alive] == 0.0)


def test_dead_cohort_aggregates_to_exact_zero():
    """A dead edge's all-zero weights through the plain eq. 6 aggregation
    (the CPU path of ``flat_edge_aggregate``, K1's plain version): its
    rows come out exactly 0, never NaN; every other edge's rows hold the
    survivor-weighted mean."""
    w, gid = _fleet(4, n=40)
    surv = np.ones(40, bool)
    surv[gid == 2] = False
    wp = t_s.participation_weights(w, np.ones(40, bool), gid, 4,
                                   survivors=surv, **CPU)
    buf = torch.as_tensor(np.random.default_rng(4).normal(0, 1, (40, 33)),
                          dtype=torch.float32)
    out = t_agg.flat_edge_aggregate(buf, wp, gid, 4)
    assert ha.launch_counts["segment_aggregate"] == 0
    assert (out[torch.as_tensor(gid == 2)] == 0).all()
    assert torch.isfinite(out).all()
    for m in (0, 1, 3):
        rows = gid == m
        ref = (wp[rows] @ buf[rows]) / wp[rows].sum()
        torch.testing.assert_close(out[rows], ref.expand(rows.sum(), -1),
                                   rtol=1e-5, atol=1e-6)


def _padded_layout(gid, num_shards):
    """A port ``ShardedFlatLayout`` built from ``_pack_groups`` (no ranks
    needed: ``pad_weights``, ``pad_rows`` and ``pad_mask`` only read the
    row permutation)."""
    perm, n_padded = t_flatten._pack_groups(gid, num_shards)
    n = len(gid)
    inv = np.empty(n, np.int64)
    inv[perm[perm >= 0]] = np.flatnonzero(perm >= 0)
    base = t_flatten.FlatLayout.of_single(
        {"w": torch.zeros(4, 3), "b": torch.zeros(3)})
    return t_flatten.ShardedFlatLayout(
        base=base, mesh=None, num_data=num_shards, num_model=1,
        num_rows=n, n_padded=n_padded, f_padded=base.total, perm=perm,
        inv_perm=inv)


@pytest.mark.parametrize("name", SAMPLER_NAMES)
def test_pad_rows_never_sampled(name):
    rng = np.random.default_rng(1)
    gid = np.sort(rng.integers(0, 3, 23))
    layout = _padded_layout(gid, 4)
    assert (layout.perm < 0).any(), "layout must actually have pad rows"
    w_pad = layout.pad_weights(rng.uniform(0.5, 2.0, 23)).numpy()
    gid_pad = layout.pad_rows(gid)
    pad_slots = layout.perm < 0
    assert np.all(w_pad[pad_slots] == 0.0)
    s = t_s.make_sampler(name, participation_rate=0.4)
    part = s.sample_rounds(0, w_pad, gid_pad, 3, 50, **CPU)
    assert not part[:, pad_slots].any(), \
        f"{name} sampler selected a pad row"
    hot = layout.pad_mask(np.ones(23, bool)).numpy()
    assert hot[~pad_slots].all() and not hot[pad_slots].any()


def test_weight_proportional_pad_propensity_exactly_zero():
    """A zero-weight row has a -inf logit AND is masked out of the winner
    set, so its propensity is exactly 0 even when k_m exceeds the
    eligible count."""
    w = np.array([1.0, 1.0, 0.0, 0.0])
    gid = np.zeros(4, np.int64)
    s = t_s.WeightProportionalSampler(participation_rate=1.0 - 1e-9,
                                      min_per_edge=4)
    assert np.isneginf(s.logits(None, w)[2:]).all()
    part = s.sample_rounds(0, w, gid, 1, 200, **CPU)
    assert not part[:, 2:].any()
    assert part[:, :2].all()            # k_m clips to the eligible count
    assert (s.inclusion_probs(0, w, gid, 1, **CPU)[2:] == 0).all()


def test_own_draws_keyed_and_independent_of_device_argument():
    """The same seed gives the same masks; another seed others; an int
    seed with ``device="cpu"`` is ``Key(seed)`` on the CPU; without a card
    an int seed and ``device=None`` raise."""
    from repro_torch.core.stochastic import Key
    w, gid = _fleet(2, n=120)
    for name in SAMPLER_NAMES:
        s = t_s.make_sampler(name, 0.25)
        a = s.sample_rounds(4, w, gid, 4, 8, **CPU)
        np.testing.assert_array_equal(
            a, s.sample_rounds(Key(4, **CPU), w, gid, 4, 8))
        assert not np.array_equal(a, s.sample_rounds(5, w, gid, 4, 8,
                                                     **CPU))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                s.sample_rounds(4, w, gid, 4, 8)
