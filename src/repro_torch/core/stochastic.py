"""Stochastic channel/compute delay engine — BEYOND-PAPER, ported from the
JAX package's ``repro/core/stochastic.py``.

The paper's delay model (eqs. 1-5, 8) is deterministic: every local
iteration costs exactly ``C_n D_n / f_n``, every upload exactly
``d_n / r_{n,m}``.  Its headline effect — stragglers dominating the
eq. 34 barrier — only becomes visible when delays fluctuate per cycle.
This module makes the per-cycle draws first-class:

* ``DelayModel`` — three key-threaded, vectorized sampling hooks
  (``sample_compute`` / ``sample_uplink`` / ``sample_backhaul``), each
  returning the paper's deterministic value broadcast over a leading draw
  axis by default, and two drivers (``edge_round_times``,
  ``cycle_times``) that apply eq. 33's member max (one ``scatter_reduce``)
  and sum a cycle's ``b`` edge rounds.  The hooks compute in float32 on
  the key's device; the drivers return float64 numpy.
* ``DeterministicDelays`` — the exact paper constants through the float64
  numpy pipeline of ``core.delay``; it never touches torch.
* ``LogNormalCompute`` / ``ShiftedExpCompute`` / ``FadingChannel`` /
  ``Compose`` and the ``Scenario`` registry, as in the reference.
* ``cycle_times_chunk`` / ``CycleTimeSource`` — key-offset chunks of the
  virtual infinite cycle matrix, replay-stable under any access order.

Keys.  ``Key`` takes the place of a ``jax.random`` key and follows the
same tree: every function splits or folds where the reference does, even
where a branch leaves a key unused, so a key object that implements the
same six methods over ``jax.random`` reproduces the reference's draws
through this code.  A key's variates come from a CPU ``torch.Generator``
seeded from ``np.random.SeedSequence([seed, *path])`` and then move to
the key's device, where all the arithmetic runs: the same seed gives the
same draws on the card and on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import delay
from repro_torch.core.problem import HFLProblem
from repro_torch.device import resolve_device

_LN10_OVER_10 = float(np.log(10.0) / 10.0)


class Key:
    """A keyed source of float32 variates on ``device``.

    ``split(n)`` and ``fold_in(i)`` return new keys with one more path
    entry.  The entries are tagged (``2i + 1`` for a split, ``2i + 2`` for
    a fold) so the two never collide, and they are never 0, since
    ``SeedSequence`` pads short entropy with zeros.  Drawing twice from
    one key gives the same variates, as with ``jax.random``.
    """

    def __init__(self, seed: int, path=(), device=None):
        self.seed = int(seed)
        self.path = tuple(int(p) for p in path)
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"Key({self.seed}, path={self.path}, device={self.device})"

    def _child(self, entry: int) -> "Key":
        return Key(self.seed, self.path + (entry,), self.device)

    def split(self, n: int = 2):
        return [self._child(2 * i + 1) for i in range(int(n))]

    def fold_in(self, i: int) -> "Key":
        return self._child(2 * int(i) + 2)

    def _generator(self) -> torch.Generator:
        ss = np.random.SeedSequence([self.seed % 2 ** 64, *self.path])
        return torch.Generator().manual_seed(
            int(ss.generate_state(1, np.uint64)[0]))

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self._generator(),
                           dtype=torch.float32).to(self.device)

    def exponential(self, shape) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=torch.float32).exponential_(
            generator=self._generator()).to(self.device)

    def uniform(self, shape, minval: float = 0.0,
                maxval: float = 1.0) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self._generator(),
                       dtype=torch.float32)
        return (u * (maxval - minval) + minval).to(self.device)

    def gumbel(self, shape) -> torch.Tensor:
        """Standard Gumbel variates by ``jax.random.gumbel``'s definition,
        ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
        u = self.uniform(shape, minval=float(torch.finfo(torch.float32).tiny))
        return -torch.log(-torch.log(u))


def ensure_key(key, device=None):
    """An int seed becomes ``Key(seed)`` on ``device`` (``None``: the
    card, raising without one); a key object passes through."""
    if isinstance(key, (int, np.integer)):
        return Key(int(key), device=resolve_device(device))
    return key


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _segment_max(per_ue: torch.Tensor, assoc) -> torch.Tensor:
    """(D, N) per-UE round latencies -> (D, M) tau draws (eq. 33).

    One ``scatter_reduce`` max over the member UEs; edges with no members
    read 0.  UEs with an all-zero association row go to an overflow
    segment that is dropped, as ``delay.edge_round_time``'s
    ``np.nonzero`` drops them.
    """
    assoc = np.asarray(assoc)
    M = assoc.shape[1]
    gid = torch.as_tensor(np.where(assoc.sum(1) > 0, assoc.argmax(1), M),
                          dtype=torch.int64, device=per_ue.device)
    tau = torch.full((per_ue.shape[0], M + 1), float("-inf"),
                     dtype=per_ue.dtype, device=per_ue.device)
    tau = tau.scatter_reduce(1, gid[None, :].expand(per_ue.shape), per_ue,
                             "amax")[:, :M]
    active = torch.as_tensor(assoc.sum(0) > 0, device=per_ue.device)
    return torch.where(active[None, :], tau, 0.0)


def _participation_rows(participation, num_draws: int) -> np.ndarray:
    part = np.asarray(participation, bool)
    if part.ndim == 1:
        part = np.broadcast_to(part[None], (num_draws, part.shape[0]))
    return part


class DelayModel:
    """Per-cycle delay sampler — override any subset of the three hooks.

    The defaults return the paper's deterministic values broadcast over
    the draw axis, so the base class itself is a (float32) deterministic
    model; ``DeterministicDelays`` below is the float64-exact variant.
    Hooks take a key and a ``num_draws`` count and return every draw at
    once, float32 on the key's device; the drivers take a key or an int
    seed (placed on ``device``) and return float64 numpy.
    """

    # -- ingredient hooks ---------------------------------------------------

    def sample_compute(self, key, problem: HFLProblem, num_draws: int):
        """(num_draws, N) per-local-iteration compute times (eq. 1)."""
        return _f32(problem.t_cmp(), key.device).expand(
            num_draws, problem.num_ues)

    def sample_uplink(self, key, problem: HFLProblem, assoc, num_draws: int):
        """(num_draws, N) UE->edge upload times under ``assoc`` (eqs. 4-5)."""
        return _f32(problem.t_com(np.asarray(assoc)), key.device).expand(
            num_draws, problem.num_ues)

    def sample_backhaul(self, key, problem: HFLProblem, num_draws: int):
        """(num_draws, M) edge->cloud upload times (eq. 8)."""
        return _f32(problem.t_edge_cloud(), key.device).expand(
            num_draws, problem.num_edges)

    # -- drivers ------------------------------------------------------------

    def edge_round_times(self, key, problem: HFLProblem, assoc, a,
                         num_draws: int, participation=None,
                         device=None) -> np.ndarray:
        """(num_draws, M) tau_m draws — eq. 33 over sampled ingredients.

        ``participation`` (optional): a bool ``(N,)`` or ``(num_draws, N)``
        cohort mask.  An unsampled UE never uploads, so its per-round
        latency is zeroed before the member max (an edge whose whole
        cohort is masked out reads 0).
        """
        kc, ku = ensure_key(key, device).split()
        per_ue = (_f32(a, kc.device) *
                  self.sample_compute(kc, problem, num_draws) +
                  self.sample_uplink(ku, problem, assoc, num_draws))
        if participation is not None:
            part = _participation_rows(participation, num_draws)
            per_ue = per_ue * torch.as_tensor(np.ascontiguousarray(part),
                                              dtype=per_ue.dtype,
                                              device=per_ue.device)
        return _segment_max(per_ue, assoc).cpu().numpy().astype(float)

    def cycle_times(self, key, problem: HFLProblem, assoc, a, b,
                    num_draws: int, participation=None,
                    device=None) -> np.ndarray:
        """(num_draws, M) per-cycle times ``sum_{j<b} tau^(j) + t_mc``.

        The ``b`` edge rounds of one cycle are drawn independently and
        summed; inactive edges stay 0.  One batched draw covers every
        cycle of every edge.  ``participation``: bool ``(N,)`` or
        per-cycle ``(num_draws, N)`` cohort masks; the ``b`` edge rounds
        of a cycle share that cycle's mask.
        """
        kr, kb = ensure_key(key, device).split()
        b = int(b)
        part = None
        if participation is not None:
            part = np.repeat(_participation_rows(participation, num_draws),
                             b, axis=0)
        tau = _f32(self.edge_round_times(kr, problem, assoc, a,
                                         num_draws * b, participation=part),
                   kr.device)
        tau = tau.reshape(num_draws, b, problem.num_edges).sum(dim=1)
        t_mc = self.sample_backhaul(kb, problem, num_draws)
        active = torch.as_tensor(np.asarray(assoc).sum(0) > 0,
                                 device=tau.device)
        return (tau + torch.where(active[None, :], t_mc, 0.0)
                ).cpu().numpy().astype(float)


@dataclasses.dataclass(frozen=True)
class DeterministicDelays(DelayModel):
    """The paper's exact constants — eq. 33/34 with zero variance.

    Overrides the drivers with the float64 numpy pipeline of
    ``core.delay``: no key is read, no device resolved, no tensor made,
    so every row is bit-identical to ``delay.edge_cycle_time`` and a
    machine with no card plans with it as before.
    """

    def edge_round_times(self, key, problem, assoc, a, num_draws,
                         participation=None, device=None):
        if participation is None:
            return np.tile(delay.edge_round_time(problem, np.asarray(assoc),
                                                 a), (num_draws, 1))
        return self._masked_tau(problem, np.asarray(assoc), a, num_draws,
                                participation)

    def cycle_times(self, key, problem, assoc, a, b, num_draws,
                    participation=None, device=None):
        assoc = np.asarray(assoc)
        if participation is None:
            return np.tile(delay.edge_cycle_time(problem, assoc, a, b),
                           (num_draws, 1))
        # Deterministic rounds: the b rounds of a cycle share the cycle's
        # cohort mask and are identical, so the cycle is b * tau + t_mc.
        tau = self._masked_tau(problem, assoc, a, num_draws, participation)
        active = assoc.sum(0) > 0
        t_mc = np.where(active, problem.t_edge_cloud(), 0.0)
        return int(b) * tau + t_mc[None, :]

    @staticmethod
    def _masked_tau(problem, assoc, a, num_draws, participation):
        """Float64-exact masked member max (numpy end to end)."""
        per_ue = a * problem.t_cmp() + problem.t_com(assoc)          # (N,)
        part = _participation_rows(participation, num_draws)
        masked = per_ue[None, :] * part                              # (D, N)
        M = assoc.shape[1]
        gid = np.where(assoc.sum(1) > 0, assoc.argmax(1), M)
        out = np.zeros((num_draws, M + 1))
        rows = np.broadcast_to(np.arange(num_draws)[:, None], masked.shape)
        cols = np.broadcast_to(gid[None, :], masked.shape)
        np.maximum.at(out, (rows, cols), masked)
        return out[:, :M]


@dataclasses.dataclass(frozen=True)
class LogNormalCompute(DelayModel):
    """Mean-preserving lognormal compute jitter.

    Per cycle, ``t_cmp -> t_cmp * exp(sigma*z - sigma^2/2)`` with
    ``z ~ N(0,1)`` per UE, so ``E[t] = C_n D_n / f_n`` exactly.  ``sigma``
    is the log-std: 0.2 is mild campus-grade jitter, 1.0 heavy-tailed.
    """
    sigma: float = 0.5

    def sample_compute(self, key, problem, num_draws):
        z = key.normal((num_draws, problem.num_ues))
        jitter = torch.exp(self.sigma * z - 0.5 * self.sigma ** 2)
        return _f32(problem.t_cmp(), z.device) * jitter


@dataclasses.dataclass(frozen=True)
class ShiftedExpCompute(DelayModel):
    """Shifted-exponential straggler tail: ``t_cmp * (1 + beta*Exp(1))``.

    A UE is never faster than eq. 1 and occasionally much slower; ``beta``
    is the mean overhead fraction (mean ``= (1+beta) * t_cmp``).
    """
    beta: float = 1.0

    def sample_compute(self, key, problem, num_draws):
        e = key.exponential((num_draws, problem.num_ues))
        return _f32(problem.t_cmp(), e.device) * (1.0 + self.beta * e)


@dataclasses.dataclass(frozen=True)
class FadingChannel(DelayModel):
    """Per-cycle channel draws through the paper's Shannon-rate uplink.

    Each cycle multiplies eq. 4's path-loss gain by a random power fade
    ``|h|^2 * 10^(shadowing_db * z / 10)`` (``|h|^2 ~ Exp(1)`` if
    ``rayleigh``, ``z ~ N(0,1)``), clipped below at ``fade_floor``;
    eq. 5's ``t_{u,m} = d_n / r_{n,m}`` then fluctuates per cycle.
    ``backhaul_sigma > 0`` applies a mean-preserving lognormal to eq. 8's
    ``t_{m,c}``.
    """
    rayleigh: bool = True
    shadowing_db: float = 0.0
    backhaul_sigma: float = 0.0
    fade_floor: float = 1e-2

    def sample_uplink(self, key, problem, assoc, num_draws):
        assoc = np.asarray(assoc)
        N = problem.num_ues
        gid = assoc.argmax(1)
        # eq. 4 bandwidth split (equal or ``problem.bandwidth_frac``);
        # unassigned rows fall back to B so their dropped draws stay finite
        bn = problem.ue_bandwidth_alloc(assoc)                       # (N,)
        bn = np.where(bn > 0, bn, problem.bandwidth_total)
        snr0 = problem.snr()[np.arange(N), gid]                      # (N,)
        kf, ks = key.split()
        dev = kf.device
        fade = torch.ones((num_draws, N), dtype=torch.float32, device=dev)
        if self.rayleigh:
            fade = kf.exponential((num_draws, N))
        if self.shadowing_db > 0:
            z = ks.normal((num_draws, N))
            fade = fade * torch.exp(_LN10_OVER_10 * self.shadowing_db * z)
        fade = torch.clamp(fade, min=self.fade_floor)
        rate = _f32(bn, dev) * torch.log2(1.0 + _f32(snr0, dev) * fade)
        return _f32(problem.model_bits, dev) / rate

    def sample_backhaul(self, key, problem, num_draws):
        base = _f32(problem.t_edge_cloud(), key.device)
        if self.backhaul_sigma <= 0:
            return base.expand(num_draws, problem.num_edges)
        z = key.normal((num_draws, problem.num_edges))
        return base * torch.exp(self.backhaul_sigma * z -
                                0.5 * self.backhaul_sigma ** 2)


_DET_HOOKS = DelayModel()


@dataclasses.dataclass(frozen=True)
class Compose(DelayModel):
    """Compute hooks from ``compute``, channel hooks from ``channel``;
    either side defaults to the deterministic hooks."""
    compute: Optional[DelayModel] = None
    channel: Optional[DelayModel] = None

    def sample_compute(self, key, problem, num_draws):
        return (self.compute or _DET_HOOKS).sample_compute(
            key, problem, num_draws)

    def sample_uplink(self, key, problem, assoc, num_draws):
        return (self.channel or _DET_HOOKS).sample_uplink(
            key, problem, assoc, num_draws)

    def sample_backhaul(self, key, problem, num_draws):
        return (self.channel or _DET_HOOKS).sample_backhaul(
            key, problem, num_draws)


# ---------------------------------------------------------------------------
# Scenario registry — named workloads composing the models.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named stochastic workload: which distributions, stressing what.

    ``faults`` (optional, a ``repro_torch.core.faults.FaultModel``) adds a
    failure process on top of the delay draws; consumers that only care
    about delays (``model``) ignore it.
    """
    name: str
    model: DelayModel
    regime: str            # which paper regime the workload stresses
    description: str
    faults: Optional[object] = None


from repro_torch.core import faults as _faults  # noqa: E402

SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in (
        Scenario(
            name="deterministic",
            model=DeterministicDelays(),
            regime="the paper's exact eqs. 1-5/34 (control)",
            description="Zero variance; sync == async at max_staleness=0, "
                        "event-for-event."),
        Scenario(
            name="iid_campus",
            model=Compose(compute=LogNormalCompute(sigma=0.2),
                          channel=FadingChannel(rayleigh=False,
                                                shadowing_db=2.0)),
            regime="near-homogeneous fleet; eq. 34's barrier is nearly "
                   "tight, async gains are small",
            description="Mild iid jitter: lognormal compute (sigma=0.2) + "
                        "2 dB shadowing, no fast fading."),
        Scenario(
            name="urban_stragglers",
            model=Compose(compute=ShiftedExpCompute(beta=1.5),
                          channel=FadingChannel(rayleigh=True,
                                                shadowing_db=4.0)),
            regime="straggler-dominated eq. 34 barrier — the regime the "
                   "paper's Algorithm 2/3 optimize for",
            description="Heavy shifted-exponential compute tail "
                        "(beta=1.5) + Rayleigh fading with 4 dB "
                        "shadowing."),
        Scenario(
            name="flaky_uplink",
            model=FadingChannel(rayleigh=True, shadowing_db=8.0,
                                backhaul_sigma=0.5),
            regime="channel-dominated delays: eq. 5 uploads and eq. 8 "
                   "backhaul spike while compute stays constant",
            description="Deep Rayleigh fades with 8 dB shadowing and "
                        "lognormal backhaul jitter (sigma=0.5)."),
        Scenario(
            name="heavy_tail_compute",
            model=ShiftedExpCompute(beta=3.0),
            regime="pure compute stragglers on a clean channel (the "
                   "arXiv 2111.00637 'work' side)",
            description="Shifted-exponential compute with beta=3.0; "
                        "channel deterministic."),
        Scenario(
            name="ue_churn",
            model=Compose(compute=LogNormalCompute(sigma=0.2)),
            regime="intermittent client availability (arXiv 2111.00637 / "
                   "2303.12414): edges lose and regain member UEs for "
                   "whole cycles at a time",
            faults=_faults.FaultModel(
                dropout=_faults.MarkovChurn(p_off=0.15, p_on=0.45)),
            description="Sticky Markov on/off churn (25% stationary "
                        "unavailability, ~2.2-cycle outages) over mild "
                        "compute jitter."),
        Scenario(
            name="edge_outage",
            model=Compose(compute=LogNormalCompute(sigma=0.2)),
            regime="edge-server failures: in-flight cycles voided, "
                   "repair windows stall wait-for-all while failover "
                   "keeps survivors progressing",
            faults=_faults.FaultModel(
                outage=_faults.EdgeOutage(rate=0.05, repair_cycles=6.0)),
            description="Rare (5%/cycle) but LONG edge failures "
                        "(exponential ~6-cycle repairs) over mild "
                        "compute jitter — the regime where stalling in "
                        "place loses to failover."),
        Scenario(
            name="lossy_uplink",
            model=FadingChannel(rayleigh=True, shadowing_db=4.0),
            faults=_faults.FaultModel(
                loss=_faults.UplinkLoss(rate=0.25, backoff=0.05)),
            regime="unreliable eq. 4 uploads: every lost attempt is "
                   "re-charged into eq. 5 plus exponential backoff",
            description="25% per-attempt upload loss with 50 ms base "
                        "backoff over a fading channel."),
    )
}


def scenario(name: str) -> Scenario:
    """Look up a named scenario; raises ValueError with the names."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; registered scenarios: "
                         f"{', '.join(sorted(SCENARIOS))}") from None


def sample_cycle_times(model: DelayModel, key, problem: HFLProblem, assoc,
                       a, b, num_draws: int, device=None) -> np.ndarray:
    """Module-level alias for ``model.cycle_times``: a float64 numpy
    ``(num_draws, M)`` matrix ready for ``events.simulate_async``."""
    return model.cycle_times(key, problem, assoc, a, b, num_draws,
                             device=device)


# ---------------------------------------------------------------------------
# Key-offset resumable sampling.
# ---------------------------------------------------------------------------

#: Rows per key-offset chunk of the virtual infinite cycle matrix.
CYCLE_BLOCK = 32


def cycle_times_chunk(model: DelayModel, key, problem: HFLProblem, assoc,
                      a, b, chunk: int, block: int = CYCLE_BLOCK,
                      device=None) -> np.ndarray:
    """Rows ``[chunk*block, (chunk+1)*block)`` of the virtual infinite
    per-cycle matrix, drawn under ``fold_in(key, chunk)``: row ``c`` is a
    pure function of ``(key, c // block)``, whatever was drawn before, in
    what order or by which process, so a resumed run sees the same
    delays without re-drawing the consumed prefix."""
    k = ensure_key(key, device).fold_in(int(chunk))
    return np.asarray(model.cycle_times(k, problem, assoc, a, b, int(block)))


class CycleTimeSource:
    """Lazy, replay-stable view of the infinite per-cycle delay matrix.

    ``row(c)`` returns the (M,) float64 cost row of 0-based cycle ``c``,
    drawing (and caching) its chunk on demand via ``cycle_times_chunk``.
    Two sources built from the same arguments agree on every row whatever
    the access pattern.
    """

    def __init__(self, model: DelayModel, key, problem: HFLProblem, assoc,
                 a, b, block: int = CYCLE_BLOCK, device=None):
        if int(block) < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.model = model
        self.key = ensure_key(key, device)
        self.problem = problem
        self.assoc = np.asarray(assoc)
        self.a, self.b = a, b
        self.block = int(block)
        self._chunks: Dict[int, np.ndarray] = {}

    def row(self, c: int) -> np.ndarray:
        chunk, off = divmod(int(c), self.block)
        if chunk not in self._chunks:
            self._chunks[chunk] = cycle_times_chunk(
                self.model, self.key, self.problem, self.assoc, self.a,
                self.b, chunk, self.block)
        return self._chunks[chunk][off]

    def cost(self, m: int, cycle: int) -> float:
        """Cost of edge ``m``'s 1-based ``cycle`` (engine convention)."""
        return float(self.row(cycle - 1)[m])
