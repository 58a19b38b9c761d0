"""Problem instances for the hierarchical-FL time-minimization system (§III).

An HFLProblem holds the cloud / edge-server / UE topology with the wireless
constants from the paper's §V-A experiment settings:

  * UEs deployed in a 500m x 500m square, edge servers at the "center"
    of their areas (we place edges on a grid over the square);
  * free-space path loss at 28 GHz: g = (wavelength / (4*pi*d))^2,
    wavelength = 3/280 m;
  * f_max = 2 GHz, p_max = 10 dBm;
  * gamma, zeta (loss-function constants) random integers in [1, 10].

Copied from the JAX package's ``repro/core/problem.py`` (numpy only).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

WAVELENGTH = 3.0 / 280.0           # 28 GHz carrier (§V-A)
FOUR_PI = 4.0 * np.pi


@dataclasses.dataclass
class HFLProblem:
    num_edges: int
    num_ues: int
    # --- wireless / compute constants -------------------------------------
    bandwidth_total: float = 20e6          # B per edge server [Hz]
    ue_bandwidth: float = 1e6              # nominal B_n for capacity (39d)
    noise_power: float = 1e-13             # N0 [W]
    p_max: float = 0.01                    # 10 dBm [W]
    f_max: float = 2e9                     # 2 GHz [cycles/s]
    model_bits: float = 1.9e6              # d_n: LeNet ~60k params fp32
    edge_model_bits: float = 1.9e6         # d_m
    backhaul_rate_lo: float = 100e6        # r_m range [bit/s]
    backhaul_rate_hi: float = 1e9
    cycles_per_sample_lo: float = 1e4      # C_n range
    cycles_per_sample_hi: float = 1e5
    samples_lo: int = 200                  # D_n range
    samples_hi: int = 1000
    area: float = 500.0                    # deployment square [m]
    # --- learning constants (eqs. 2/7/14) ----------------------------------
    zeta: float = 5.0
    gamma: float = 5.0
    big_c: float = 1.0                     # C in eq. (14)
    epsilon: float = 0.25                  # global accuracy target
    seed: int = 0
    # --- beyond-paper: per-UE uplink bandwidth fractions --------------------
    # (N,) share of the serving edge's bandwidth B granted to each UE
    # inside the eq. 4 rate; ``None`` is the paper's equal split
    # B/|N_m|.  Set by ``core.jointopt.optimize_bandwidth`` (the convex
    # per-cell waterfilling split of arXiv 2007.03462).
    bandwidth_frac: Optional[np.ndarray] = None

    # --- generated fields ---------------------------------------------------
    ue_pos: Optional[np.ndarray] = None        # (N, 2)
    edge_pos: Optional[np.ndarray] = None      # (M, 2)
    gains: Optional[np.ndarray] = None         # (N, M) channel gains
    f_n: Optional[np.ndarray] = None           # (N,) CPU frequency (at max)
    p_n: Optional[np.ndarray] = None           # (N,) transmit power (at max)
    cycles: Optional[np.ndarray] = None        # (N,) C_n
    samples: Optional[np.ndarray] = None       # (N,) D_n
    backhaul: Optional[np.ndarray] = None      # (M,) r_m
    meta: Optional[dict] = None                # annotations (roofline bridge)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        N, M = self.num_ues, self.num_edges
        self.ue_pos = rng.uniform(0, self.area, size=(N, 2))
        side = int(np.ceil(np.sqrt(M)))
        centers = []
        cell = self.area / side
        for i in range(M):
            r, c = divmod(i, side)
            centers.append(((c + 0.5) * cell, (r + 0.5) * cell))
        self.edge_pos = np.asarray(centers)
        dist = np.linalg.norm(
            self.ue_pos[:, None, :] - self.edge_pos[None, :, :], axis=-1)
        dist = np.maximum(dist, 1.0)
        self.gains = (WAVELENGTH / (FOUR_PI * dist)) ** 2        # (N, M)
        # Optimal f*, p* are the maxima (paper §IV-C-1).
        self.f_n = np.full(N, self.f_max)
        self.p_n = np.full(N, self.p_max)
        self.cycles = rng.uniform(self.cycles_per_sample_lo,
                                  self.cycles_per_sample_hi, N)
        self.samples = rng.integers(self.samples_lo, self.samples_hi + 1, N).astype(float)
        self.backhaul = rng.uniform(self.backhaul_rate_lo,
                                    self.backhaul_rate_hi, M)

    # -- derived quantities ---------------------------------------------------

    def snr(self) -> np.ndarray:
        """g_{n,m} p_n / N0, shape (N, M) — Alg. 3 sorts on this."""
        return self.gains * self.p_n[:, None] / self.noise_power

    def t_cmp(self) -> np.ndarray:
        """eq. (1): C_n D_n / f_n per local iteration, shape (N,)."""
        return self.cycles * self.samples / self.f_n

    def rate(self, counts: np.ndarray) -> np.ndarray:
        """eq. (4) with equal bandwidth split: B_n = B / |N_m|.

        counts: (M,) number of UEs associated with each edge.
        Returns (N, M) achievable rates given those splits.
        """
        bn = self.bandwidth_total / np.maximum(counts, 1)[None, :]
        return bn * np.log2(1.0 + self.snr())

    def ue_bandwidth_alloc(self, assoc: np.ndarray) -> np.ndarray:
        """Per-UE uplink bandwidth B_n under ``assoc``, shape (N,).

        The eq. 4 split: equal B/|N_m| by default, or the beyond-paper
        ``bandwidth_frac``-weighted split B_n = frac_n * B when set
        (``core.jointopt.optimize_bandwidth``).  UEs with an all-zero
        association row get 0 (they never upload).
        """
        assoc = np.asarray(assoc)
        assigned = assoc.sum(1) > 0
        if self.bandwidth_frac is not None:
            bn = self.bandwidth_total * np.asarray(self.bandwidth_frac, float)
        else:
            counts = assoc.sum(0)
            gid = assoc.argmax(1)
            bn = self.bandwidth_total / np.maximum(counts, 1)[gid]
        return np.where(assigned, bn, 0.0)

    def t_com(self, assoc: np.ndarray) -> np.ndarray:
        """eq. (5): per-UE upload time under association matrix (N, M) 0/1."""
        bn = self.ue_bandwidth_alloc(assoc)
        t = np.zeros(self.num_ues)
        n_idx, m_idx = np.nonzero(assoc)
        r = bn[n_idx] * np.log2(1.0 + self.snr()[n_idx, m_idx])
        t[n_idx] = self.model_bits / r
        return t

    def t_edge_cloud(self) -> np.ndarray:
        """eq. (8): d_m / r_m, shape (M,)."""
        return self.edge_model_bits / self.backhaul
