"""Plain numpy reference of the simulated clock of synchronous Algorithm 1:
the time of one cloud round, eq. 34, for a fleet drawn from its seed.

The fleet is redrawn here as the paper's §V-A settings describe it (UEs
uniform in a 500 m square, edges at the centres of a grid, free-space
loss at 28 GHz, f = 2 GHz, p = 10 dBm, C_n, D_n and r_m uniform), in the
order of draws the program's problem generator uses, so the same seed
gives the same fleet.  Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

WAVELENGTH = 3.0 / 280.0
SETTINGS = dict(bandwidth_total=20e6, noise_power=1e-13, p_max=0.01,
                f_max=2e9, model_bits=1.9e6, edge_model_bits=1.9e6,
                backhaul_rate_lo=100e6, backhaul_rate_hi=1e9,
                cycles_per_sample_lo=1e4, cycles_per_sample_hi=1e5,
                samples_lo=200, samples_hi=1000, area=500.0)


def fleet(num_edges: int, num_ues: int, seed: int, **kw) -> dict:
    """The fleet's drawn quantities: gains (N, M), f, p, C, D (N,), r (M,)."""
    s = dict(SETTINGS, **kw)
    rng = np.random.default_rng(seed)
    N, M = num_ues, num_edges
    ue = rng.uniform(0, s["area"], size=(N, 2))
    side = int(np.ceil(np.sqrt(M)))
    cell = s["area"] / side
    edges = np.asarray([((i % side + 0.5) * cell, (i // side + 0.5) * cell)
                        for i in range(M)])
    dist = np.maximum(np.linalg.norm(ue[:, None, :] - edges[None], axis=-1),
                      1.0)
    gains = (WAVELENGTH / (4.0 * np.pi * dist)) ** 2
    cycles = rng.uniform(s["cycles_per_sample_lo"],
                         s["cycles_per_sample_hi"], N)
    samples = rng.integers(s["samples_lo"], s["samples_hi"] + 1,
                           N).astype(float)
    backhaul = rng.uniform(s["backhaul_rate_lo"], s["backhaul_rate_hi"], M)
    return dict(s, gains=gains, f=np.full(N, s["f_max"]),
                p=np.full(N, s["p_max"]), cycles=cycles, samples=samples,
                backhaul=backhaul)


def cloud_round_time(fl: dict, edge_of_ue, a: int, b: int) -> float:
    """T = max_m { b tau_m + d_m / r_m } (eq. 34), tau_m the slowest
    member's a C_n D_n / f_n + d_n / (B / |N_m| log2(1 + g p / N0))
    (eqs. 1, 4, 5, 33)."""
    gid = np.asarray(edge_of_ue)
    N, M = fl["gains"].shape
    counts = np.bincount(gid, minlength=M)
    t_cmp = fl["cycles"] * fl["samples"] / fl["f"]
    snr = fl["gains"][np.arange(N), gid] * fl["p"] / fl["noise_power"]
    rate = fl["bandwidth_total"] / np.maximum(counts, 1)[gid] \
        * np.log2(1.0 + snr)
    per_ue = float(a) * t_cmp + fl["model_bits"] / rate
    tau = np.zeros(M)
    for n in range(N):
        tau[gid[n]] = max(tau[gid[n]], per_ue[n])
    t_up = np.where(counts > 0, fl["edge_model_bits"] / fl["backhaul"], 0.0)
    return float((float(b) * tau + t_up).max())
