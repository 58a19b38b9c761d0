"""Per-round client sampling for partial participation (beyond the paper),
ported from the JAX package's ``repro/fl/sampling.py``.

The paper's eqs. 6/10 assume every UE uploads every edge round; fleets of
10^5-10^6 UEs sample a cohort per round (HierFAVG's client-edge-cloud
setting, arXiv 1905.06641).  Samplers are frozen dataclasses; a run's
masks come from ONE keyed batched draw (``sample_rounds``).  Keys follow
``repro_torch.core.stochastic``: an int seed becomes ``Key(seed)`` on
``device`` (``None``: the card, raising without one), and the draws split
and fold where the reference's do, so a key over ``jax.random`` gives the
reference's masks.

Selection is Gumbel-top-k within each edge: per (round, edge) the
``k_m = ceil(rate * n_m)`` eligible members with the largest ``logits +
Gumbel`` keys win — a Plackett-Luce draw without replacement, so ``logits
= log w`` is weight-proportional and ``logits = 0`` uniform.  Eligibility
is strictly ``weight > 0``: zero-weight rows (``ShardedFlatLayout`` pad
rows, masked-out UEs) get ``-inf`` keys AND are masked out of the winner
set, so they are never selected.  The selection (``lexsort``) and the
inclusion-probability bisection are float64 numpy, as in the reference.

``participation_weights`` reweights the cohort with the port's
``aggregate.survivor_weights`` (each edge's kept members rescaled to the
edge's full mass W_m), optionally over inverse-propensity base weights
(the Hajek estimator); composing faults and sampling ANDs the masks first
and renormalizes once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Type

import numpy as np
import torch

from repro_torch.core.stochastic import ensure_key
from repro_torch.device import resolve_device
from repro_torch.fl import aggregate

__all__ = [
    "ClientSampler",
    "UniformSampler",
    "WeightProportionalSampler",
    "ParetoSampler",
    "SAMPLERS",
    "make_sampler",
    "participation_weights",
    "expected_cohort",
]


def _cohort_sizes(w, gid, num_groups, rate, min_per_edge) -> np.ndarray:
    """``k_m = clip(ceil(rate * n_m), min_per_edge, n_m)`` over eligible
    members, 0 for an edge with none."""
    n_m = np.bincount(gid[w > 0], minlength=int(num_groups))
    return np.where(
        n_m > 0,
        np.clip(np.ceil(float(rate) * n_m), int(min_per_edge),
                np.maximum(n_m, 1)),
        0,
    ).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ClientSampler:
    """Base sampler: uniform-within-edge Gumbel-top-k draws.

    ``participation_rate`` in (0, 1]; each nonempty edge keeps at least
    ``min_per_edge`` members (so a sampled round never silences a live
    edge and the mass-preserving reweighting is always well defined).
    """

    participation_rate: float = 0.1
    min_per_edge: int = 1

    name = "uniform"

    def __post_init__(self):
        if not (0.0 < float(self.participation_rate) <= 1.0):
            raise ValueError(
                f"participation_rate must be in (0, 1], got "
                f"{self.participation_rate}")
        if int(self.min_per_edge) < 1:
            raise ValueError("min_per_edge must be >= 1")

    # -- policy hook ---------------------------------------------------
    def logits(self, key, weights: np.ndarray) -> np.ndarray:
        """Per-UE selection log-propensities for ELIGIBLE rows (float64;
        only finite on ``weights > 0`` matters)."""
        return np.zeros(weights.shape[0])

    # -- public API ----------------------------------------------------
    def is_full(self) -> bool:
        """True when every eligible UE participates every round."""
        return float(self.participation_rate) >= 1.0

    def sample_rounds(self, key, weights, group_ids, num_groups, num_rounds,
                      device=None) -> np.ndarray:
        """One batched draw of participation masks: a ``(num_rounds, N)``
        bool array, row r the cohort of round r.  Pure in ``(key, weights,
        group_ids)``."""
        w = np.asarray(weights, np.float64)
        gid = np.asarray(group_ids, np.int64)
        num_rounds = int(num_rounds)
        n = w.shape[0]
        eligible = w > 0
        if self.is_full():
            return np.tile(eligible, (num_rounds, 1))

        key = ensure_key(key, device)
        base = np.asarray(self.logits(key, w), np.float64)
        gum = key.fold_in(1).gumbel((num_rounds, n)).cpu().numpy()
        z = np.where(eligible[None, :], base[None, :] + gum, -np.inf)
        k_m = _cohort_sizes(w, gid, num_groups, self.participation_rate,
                            self.min_per_edge)

        # One lexsort over all (round, edge) groups: primary round,
        # secondary edge, tertiary z descending; within each group the
        # first k_m entries win.
        rf = np.repeat(np.arange(num_rounds), n)
        gf = np.tile(gid, num_rounds)
        zf = z.ravel()
        order = np.lexsort((-zf, gf, rf))
        sr, sg = rf[order], gf[order]
        newgrp = np.ones(num_rounds * n, bool)
        newgrp[1:] = (sr[1:] != sr[:-1]) | (sg[1:] != sg[:-1])
        starts = np.where(newgrp, np.arange(num_rounds * n), 0)
        pos = np.arange(num_rounds * n) - np.maximum.accumulate(starts)
        take = (pos < k_m[sg]) & np.isfinite(zf[order])
        out = np.zeros(num_rounds * n, bool)
        out[order] = take
        return out.reshape(num_rounds, n)

    def sample_mask(self, key, weights, group_ids, num_groups,
                    device=None) -> np.ndarray:
        """Single-round convenience wrapper: ``(N,)`` bool cohort mask."""
        return self.sample_rounds(key, weights, group_ids, num_groups, 1,
                                  device=device)[0]

    def inclusion_probs(self, key, weights, group_ids, num_groups,
                        device=None) -> np.ndarray:
        """Per-UE inclusion probability ``pi_n`` of one round's draw.

        Gumbel-top-k with propensities ``p_n = exp(logits)`` is the
        exponential race; calibrating a per-edge rate ``t_m`` with
        ``sum_n (1 - exp(-p_n t_m)) = k_m`` (bisection) gives ``pi_n = 1 -
        exp(-p_n t_m)``, exact for uniform propensities (``k_m / n_m``).
        Ineligible rows get ``pi = 0``.
        """
        w = np.asarray(weights, np.float64)
        gid = np.asarray(group_ids, np.int64)
        eligible = w > 0
        pi = np.zeros(w.shape[0])
        if self.is_full():
            pi[eligible] = 1.0
            return pi
        logit = np.asarray(self.logits(ensure_key(key, device), w),
                           np.float64)
        k_m = _cohort_sizes(w, gid, num_groups, self.participation_rate,
                            self.min_per_edge)
        for m in range(int(num_groups)):
            rows = np.flatnonzero(eligible & (gid == m))
            if rows.size == 0:
                continue
            k = int(k_m[m])
            if k >= rows.size:
                pi[rows] = 1.0
                continue
            p = np.exp(logit[rows] - logit[rows].max())
            lo, hi = 0.0, 1.0
            while (1.0 - np.exp(-p * hi)).sum() < k:
                hi *= 2.0
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                if (1.0 - np.exp(-p * mid)).sum() < k:
                    lo = mid
                else:
                    hi = mid
            pi[rows] = 1.0 - np.exp(-p * 0.5 * (lo + hi))
        return pi

    def ipw_base_weights(self, key, weights, group_ids, num_groups,
                         device=None) -> np.ndarray:
        """Static inverse-propensity aggregation weights (float64):
        ``w_n / pi_n``, rescaled per edge to the TRUE mass W_m, so
        ``survivor_weights`` over them is the Hajek estimator of eq. 6 and
        eq. 10's edge masses are untouched.  The uniform sampler returns
        the weights themselves up to rounding."""
        w = np.asarray(weights, np.float64)
        if self.is_full():
            return w.copy()
        gid = np.asarray(group_ids, np.int64)
        ng = int(num_groups)
        pi = self.inclusion_probs(key, w, gid, ng, device=device)
        adj = np.where(w > 0, w / np.maximum(pi, 1e-12), 0.0)
        full = np.bincount(gid, weights=w, minlength=ng)
        got = np.bincount(gid, weights=adj, minlength=ng)
        scale = np.where(got > 0, full / np.maximum(got, 1e-12), 0.0)
        return adj * scale[gid]


@dataclasses.dataclass(frozen=True)
class UniformSampler(ClientSampler):
    """Uniform without replacement within each edge."""

    name = "uniform"


@dataclasses.dataclass(frozen=True)
class WeightProportionalSampler(ClientSampler):
    """Plackett-Luce draw with inclusion propensity proportional to
    weight: ``logits = log w``; a zero-weight row is ineligible."""

    name = "weight"

    def logits(self, key, weights):
        with np.errstate(divide="ignore"):
            return np.where(weights > 0,
                            np.log(np.maximum(weights, 1e-300)), -np.inf)


@dataclasses.dataclass(frozen=True)
class ParetoSampler(ClientSampler):
    """Pareto-biased availability: each UE gets a persistent propensity
    ``s_n ~ Pareto(alpha)`` drawn once from the run key (under
    ``fold_in(key, 0)``); rounds sample proportional to ``s_n``.  Smaller
    ``alpha`` = heavier tail = more concentrated participation."""

    alpha: float = 1.5

    name = "pareto"

    def __post_init__(self):
        super().__post_init__()
        if not float(self.alpha) > 0:
            raise ValueError("alpha must be > 0")

    def logits(self, key, weights):
        u = key.fold_in(0).uniform((weights.shape[0],), minval=0.0,
                                   maxval=1.0 - 1e-7)
        u = u.cpu().numpy().astype(np.float64)
        # log of s = (1-u)^(-1/alpha): heavy-tailed persistent propensity
        return -np.log1p(-u) / float(self.alpha)


SAMPLERS: Dict[str, Type[ClientSampler]] = {
    "uniform": UniformSampler,
    "weight": WeightProportionalSampler,
    "pareto": ParetoSampler,
}


def make_sampler(name: str, participation_rate: float, **kw) -> ClientSampler:
    """Registry constructor (mirrors ``stochastic.scenario``)."""
    try:
        cls = SAMPLERS[name]
    except KeyError:
        raise ValueError(
            f"unknown sampler {name!r}; available: {sorted(SAMPLERS)}"
        ) from None
    return cls(participation_rate=participation_rate, **kw)


def participation_weights(weights, participation, group_ids, num_groups,
                          survivors=None, propensity=None,
                          device=None) -> torch.Tensor:
    """Mass-preserving reweighting of a sampled (and possibly faulted)
    cohort: float32 ``(N,)`` on ``device`` (``None``: the card).

    ANDs the participation mask with ``survivors`` (if given) and applies
    ONE renormalization: within each edge the kept members' weights sum
    to the edge's full mass W_m.  An edge whose cohort is entirely gone
    gets all-zero weights, so the aggregation gives exact zeros, never
    NaN.  ``propensity`` (inclusion probabilities, see
    ``ClientSampler.inclusion_probs``) switches the base measure to
    ``w_n / pi_n`` before masking (float64 numpy, as the reference).
    """
    dev = resolve_device(device)
    part = torch.as_tensor(participation, dtype=torch.bool, device=dev)
    if survivors is not None:
        part = part & torch.as_tensor(survivors, dtype=torch.bool,
                                      device=dev)
    if propensity is None:
        return aggregate.survivor_weights(
            torch.as_tensor(weights, dtype=torch.float32, device=dev), part,
            torch.as_tensor(group_ids, device=dev), num_groups)
    w = np.asarray(weights, np.float64)
    gid = np.asarray(group_ids, np.int64)
    ng = int(num_groups)
    pi = np.asarray(propensity, np.float64)
    adj = np.where(w > 0, w / np.maximum(pi, 1e-12), 0.0)
    masked = adj * part.cpu().numpy().astype(np.float64)
    full = np.bincount(gid, weights=w, minlength=ng)
    kept = np.bincount(gid, weights=masked, minlength=ng)
    scale = np.where(kept > 0, full / np.maximum(kept, 1e-12), 0.0)
    return torch.as_tensor(masked * scale[gid], dtype=torch.float32,
                           device=dev)


def expected_cohort(weights, group_ids, num_groups, rate,
                    min_per_edge=1) -> int:
    """Host-side cohort size ``sum_m k_m`` for capacity planning."""
    w = np.asarray(weights, np.float64)
    gid = np.asarray(group_ids, np.int64)
    return int(_cohort_sizes(w, gid, num_groups, rate, min_per_edge).sum())
