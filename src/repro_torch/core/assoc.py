"""Sub-problem II — UE-to-edge association (§IV-D).

Strategies, all returning an (N, M) 0/1 matrix with exactly one 1 per row
and at most ``capacity`` UEs per edge (``STRATEGIES`` adds the
beyond-paper local searches ``refined`` and ``cluster_refined``):

* ``proposed``   — Algorithm 3: per-edge top-SNR selection with conflict
  resolution by the best unassigned (UE, edge) SNR.
* ``greedy``     — baseline from §V-C: each edge greedily takes the max-SNR
  UEs still available, in edge order.
* ``random_assoc`` — baseline from §V-C: uniform random under capacity.

Copied from the JAX package's ``repro/core/assoc.py`` (numpy only): the
strategies ``plan`` can name, the enumeration oracle ``exhaustive`` and
the fault path's incremental re-association ``failover`` (with
``orphans_of``).  ``refined``'s stochastic objectives
(``"quantile_makespan"``, ``"joint"``) draw through ``core.stochastic`` on
``device``.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

from repro_torch.core import delay
from repro_torch.core.problem import HFLProblem


def capacity_of(problem: HFLProblem) -> int:
    """Max UEs per edge from the bandwidth constraint (39d): B / B_n."""
    cap = int(problem.bandwidth_total // problem.ue_bandwidth)
    # Feasibility: the M edges must be able to host all N UEs.
    need = int(np.ceil(problem.num_ues / problem.num_edges))
    return max(cap, need)


def _assert_valid(problem, assoc, cap):
    assert assoc.shape == (problem.num_ues, problem.num_edges)
    assert (assoc.sum(1) == 1).all(), "each UE must have exactly one edge"
    assert (assoc.sum(0) <= cap).all(), "edge capacity exceeded"


def random_assoc(problem: HFLProblem, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    N, M = problem.num_ues, problem.num_edges
    cap = capacity_of(problem)
    assoc = np.zeros((N, M), dtype=np.int64)
    counts = np.zeros(M, dtype=np.int64)
    for n in rng.permutation(N):
        open_edges = np.flatnonzero(counts < cap)
        m = rng.choice(open_edges)
        assoc[n, m] = 1
        counts[m] += 1
    _assert_valid(problem, assoc, cap)
    return assoc


def greedy(problem: HFLProblem) -> np.ndarray:
    """Each edge (in order) takes the highest-SNR still-unassigned UEs."""
    N, M = problem.num_ues, problem.num_edges
    cap = capacity_of(problem)
    snr = problem.snr()                                  # (N, M)
    assoc = np.zeros((N, M), dtype=np.int64)
    unassigned = set(range(N))
    for m in range(M):
        if not unassigned:
            break
        cands = sorted(unassigned, key=lambda n: -snr[n, m])
        take = cands[:cap]
        # Leave room so the remaining edges can host the remaining UEs.
        remaining_cap = (M - m - 1) * cap
        while len(unassigned) - len(take) > remaining_cap:
            take.append(cands[len(take)])
        for n in take:
            assoc[n, m] = 1
            unassigned.discard(n)
    # Any stragglers (cap rounding): best-SNR open edge.
    counts = assoc.sum(0)
    for n in list(unassigned):
        open_edges = np.flatnonzero(counts < cap)
        m = open_edges[np.argmax(snr[n, open_edges])]
        assoc[n, m] = 1
        counts[m] += 1
    _assert_valid(problem, assoc, cap)
    return assoc


def proposed(problem: HFLProblem) -> np.ndarray:
    """Algorithm 3 — time-minimized UE-to-edge association.

    Each edge i independently claims its top-capacity SNR UEs; a UE claimed
    by edges j < i is resolved by swapping in the best unclaimed (UE, edge)
    pair among {m_i, m_j} (lines 4-8 of Alg. 3), iterating until claims are
    disjoint.  Unclaimed UEs are then attached to their best open edge.
    """
    N, M = problem.num_ues, problem.num_edges
    cap = capacity_of(problem)
    snr = problem.snr()
    # claimed[m] = set of UEs edge m wants.
    claimed = [set(np.argsort(-snr[:, m])[:min(cap, N)].tolist())
               for m in range(M)]

    def unclaimed():
        taken = set().union(*claimed)
        return np.array(sorted(set(range(N)) - taken), dtype=int)

    for i in range(M):
        # resolve conflicts of edge i against all earlier edges j < i.
        # Swapping in a GLOBALLY unclaimed UE guarantees termination: each
        # swap strictly shrinks the unclaimed pool, each drop strictly
        # shrinks the duplicate count.
        progress = True
        while progress:
            progress = False
            for j in range(i):
                both = claimed[i] & claimed[j]
                if not both:
                    continue
                n_conf = min(both)
                pool = unclaimed()
                if pool.size == 0:
                    # nothing to swap in: keep the stronger claim (line 5's
                    # argmax degenerates to the conflicted UE itself)
                    if snr[n_conf, i] >= snr[n_conf, j]:
                        claimed[j].discard(n_conf)
                    else:
                        claimed[i].discard(n_conf)
                    progress = True
                    continue
                pair_snr = snr[pool][:, [i, j]]          # (|pool|, 2)
                flat = int(np.argmax(pair_snr))
                n_new = int(pool[flat // 2])
                m_new = (i, j)[flat % 2]
                # remove the conflicted UE from m_new's claim, add n_new there
                claimed[m_new].discard(n_conf)
                claimed[m_new].add(n_new)
                progress = True

    assoc = np.zeros((N, M), dtype=np.int64)
    counts = np.zeros(M, dtype=np.int64)
    owner = {}
    for m in range(M):
        for n in claimed[m]:
            if n in owner:                  # defensive: keep higher SNR
                if snr[n, m] <= snr[n, owner[n]]:
                    continue
                assoc[n, owner[n]] = 0
                counts[owner[n]] -= 1
            if counts[m] < cap:
                assoc[n, m] = 1
                counts[m] += 1
                owner[n] = m
    for n in range(N):
        if assoc[n].sum() == 0:
            open_edges = np.flatnonzero(counts < cap)
            m = open_edges[np.argmax(snr[n, open_edges])]
            assoc[n, m] = 1
            counts[m] += 1
    _assert_valid(problem, assoc, cap)
    return assoc


def exhaustive(problem: HFLProblem, a: float = 1.0) -> np.ndarray:
    """Exact solution of problem (38)/(39) by enumeration — tiny N, M only."""
    N, M = problem.num_ues, problem.num_edges
    if M**N > 2_000_000:
        raise ValueError(f"exhaustive infeasible for M^N = {M}^{N}")
    cap = capacity_of(problem)
    best, best_val = None, np.inf
    for choice in itertools.product(range(M), repeat=N):
        counts = np.bincount(choice, minlength=M)
        if (counts > cap).any():
            continue
        assoc = np.zeros((N, M), dtype=np.int64)
        assoc[np.arange(N), list(choice)] = 1
        v = delay.association_latency(problem, assoc, a)
        if v < best_val:
            best, best_val = assoc, v
    return best


def _latency_terms(problem: HFLProblem, a: float):
    """Split eq. (38)'s per-UE latency into fixed + per-count parts.

    With equal bandwidth split, UE n on edge m hosting c UEs costs
    ``t_fix[n] + c * t_unit[n, m]``: the upload time scales linearly in
    the member count, which is what makes trial moves O(cap) to
    re-evaluate instead of a full O(N*M) ``t_com`` recompute.
    """
    t_fix = np.asarray(a, float) * problem.t_cmp()              # (N,)
    t_unit = problem.model_bits / (problem.bandwidth_total *
                                   np.log2(1.0 + problem.snr()))  # (N, M)
    return t_fix, t_unit


def orphans_of(assoc: np.ndarray, dead_edges) -> np.ndarray:
    """UE indices orphaned when ``dead_edges`` go down: assigned rows
    whose home edge is dead.  The same membership rule ``failover`` uses
    to pick what it re-homes — exposed so callers (the always-on
    service's segment-boundary failover) can report/trace the orphan set
    without re-deriving it."""
    A = np.asarray(assoc)
    dead = np.atleast_1d(np.asarray(dead_edges, dtype=int)).ravel()
    assigned = A.sum(1) > 0
    return np.flatnonzero(assigned & np.isin(A.argmax(1), dead))


def failover(problem: HFLProblem, assoc: np.ndarray, dead_edges,
             a: float = 10.0) -> np.ndarray:
    """BEYOND-PAPER: incremental re-association after edge failures.

    When edge servers in ``dead_edges`` go down (``repro_torch.core.faults``
    outage windows), their member UEs are ORPHANED.  This re-homes each
    orphan onto a surviving edge, reusing the refined-search delta
    machinery (``_latency_terms``): with the eq. 38 latency split
    ``t_fix[n] + c * t_unit[n, m]``, placing one orphan only changes the
    receiving edge's member count, so every candidate placement is an
    O(members) delta re-score instead of a full O(N*M) ``t_com``
    recompute.  Orphans are placed worst-first (highest best-case
    latency), each onto the edge minimizing the resulting SYSTEM latency
    — the same bottleneck criterion ``refined`` descends.

    Capacity: the bandwidth cap (39d) is respected when feasible; when
    the surviving edges cannot hold everyone under it, the cap relaxes
    to ``ceil(N / M_alive)`` (UEs must land somewhere — degraded
    service beats no service).  Rows that were all-zero stay all-zero;
    dead edges end with zero members.
    """
    A = np.asarray(assoc).copy()
    N, M = A.shape
    dead = sorted({int(m) for m in np.atleast_1d(
        np.asarray(dead_edges, dtype=int)).ravel()})
    if any(m < 0 or m >= M for m in dead):
        raise ValueError(f"dead_edges {dead} out of range for M={M}")
    alive = [m for m in range(M) if m not in dead]
    if not alive:
        raise ValueError("no surviving edges to fail over to")
    assigned = A.sum(1) > 0
    orphans = np.flatnonzero(assigned & np.isin(A.argmax(1), dead))
    if orphans.size == 0:
        return A
    n_assigned = int(assigned.sum())
    cap = max(capacity_of(problem),
              int(np.ceil(n_assigned / len(alive))))
    t_fix, t_unit = _latency_terms(problem, a)
    edge_of = np.where(assigned, A.argmax(1), -1)
    members = {m: np.flatnonzero(edge_of == m).tolist() for m in alive}
    counts = {m: len(members[m]) for m in alive}
    el = {m: (float(np.max(t_fix[members[m]] +
                           counts[m] * t_unit[members[m], m]))
              if members[m] else 0.0) for m in alive}
    # Worst-first: the orphan whose BEST surviving placement is costliest
    # gets first pick (classic bottleneck ordering).
    best_case = np.array([t_fix[n] + np.min(t_unit[n, alive])
                          for n in orphans])
    for n in orphans[np.argsort(-best_case)]:
        best_m, best_val = None, np.inf
        for m in alive:
            if counts[m] >= cap:
                continue
            c_new = counts[m] + 1
            mem = members[m]
            el_m = t_fix[n] + c_new * t_unit[n, m]
            if mem:
                el_m = max(el_m, float(np.max(t_fix[mem] +
                                              c_new * t_unit[mem, m])))
            v = max(el_m, max((el[mm] for mm in alive if mm != m),
                              default=0.0))
            if v < best_val - 1e-12:
                best_val, best_m = v, m
        if best_m is None:          # every survivor at cap: force least-bad
            best_m = min(alive, key=lambda m: counts[m])
        A[n] = 0
        A[n, best_m] = 1
        members[best_m].append(int(n))
        counts[best_m] += 1
        c = counts[best_m]
        mem = members[best_m]
        el[best_m] = float(np.max(t_fix[mem] + c * t_unit[mem, best_m]))
    assert (A.sum(1)[assigned] == 1).all()
    assert (A[:, dead].sum() == 0).all() if dead else True
    return A


def refined(problem: HFLProblem, a: float = 10.0,
            max_moves: int = 500, incremental: bool = True,
            objective: str = "latency", b: float = 3.0, rounds: int = 8,
            max_staleness: int = 2, delay_model=None, q: float = 0.95,
            num_trials: int = 24, delay_key=0, device=None) -> np.ndarray:
    """BEYOND-PAPER: Alg. 3 + bottleneck local search.

    Alg. 3 maximizes selected SNR, which is a proxy for the true objective
    (38).  This post-pass descends the objective directly: repeatedly take
    the bottleneck UE (the argmax of a*t_cmp + t_com) and move it to the
    edge that minimizes the resulting SYSTEM latency (bandwidth re-splits
    included), until no move improves.  Each accepted move strictly lowers
    the objective, so it terminates.  Reported separately in EXPERIMENTS.md
    §Perf (paper-faithful Alg. 3 is the baseline).

    ``objective`` selects what the search descends:

    * ``"latency"`` (default) — eq. 38's max per-UE latency, the paper's
      sub-problem II objective;
    * ``"async_makespan"`` — the event-driven async completion time
      (``delay.async_completion`` with this ``b``/``rounds``/
      ``max_staleness``): the association is tuned for the STALENESS-
      BOUNDED regime, where balancing whole edge cycles matters more than
      the single worst UE.  Scored by full timeline simulation, so only
      the full-recompute search path applies (small N, M instances).
    * ``"quantile_makespan"`` — the ``q``-quantile (default p95) of the
      STOCHASTIC async makespan (``delay.quantile_makespan`` over
      ``num_trials`` keyed trials of ``delay_model``, default the
      ``urban_stragglers`` scenario): the robust association.  A fixed
      ``delay_key`` gives every candidate the same draws (common random
      numbers), so the descent is on a deterministic surface.
      ``device`` places an int ``delay_key``'s draws (``None``: the card).
    * ``"joint"`` — ``"quantile_makespan"`` with the per-cell uplink
      bandwidth split (``core.jointopt.optimize_bandwidth``, beyond-paper
      arXiv 2007.03462) re-optimized for EVERY candidate association, so
      chi and bandwidth co-optimize around a ``jointopt.solve_joint``
      tuple's (a, b, max_staleness).

    ``incremental=True`` (default, latency objective only) evaluates each
    trial move by DELTA: a move only changes the two touched edges'
    latencies, so re-scoring is O(members) + O(M) instead of the full
    O(N*M) ``association_latency`` recompute (the legacy path, kept for
    the bench comparison in ``benchmarks/bench_association.py``).
    """
    cap = capacity_of(problem)
    if objective == "async_makespan":
        def score(A):
            return delay.async_completion(
                problem, A, a, b, rounds=rounds,
                max_staleness=max_staleness)["makespan"]
        return _refined_full_recompute(problem, a, max_moves, cap,
                                       score=score)
    if objective == "quantile_makespan":
        if delay_model is None:
            from repro_torch.core import stochastic
            delay_model = stochastic.scenario("urban_stragglers").model

        def score(A):
            return delay.quantile_makespan(
                problem, A, a, b, rounds=rounds,
                max_staleness=max_staleness, model=delay_model,
                key=delay_key, num_trials=num_trials, q=q, device=device)
        return _refined_full_recompute(problem, a, max_moves, cap,
                                       score=score)
    if objective == "joint":
        # Co-optimize chi with the stochastic joint tuple
        # (core.jointopt): every candidate association is scored on the
        # q-quantile async makespan at the caller's (a, b,
        # max_staleness) with the per-cell bandwidth split RE-OPTIMIZED
        # for that candidate — association, iteration counts, staleness
        # and bandwidth move together ((a, b, max_staleness) come from a
        # prior ``jointopt.solve_joint`` pass; a fixed ``delay_key``
        # keeps the descent surface deterministic, as above).
        from repro_torch.core import jointopt
        if delay_model is None:
            from repro_torch.core import stochastic
            delay_model = stochastic.scenario("urban_stragglers").model

        def score(A):
            frac = jointopt.optimize_bandwidth(problem, A, a)
            saved = problem.bandwidth_frac
            problem.bandwidth_frac = frac
            try:
                return delay.quantile_makespan(
                    problem, A, a, b, rounds=rounds,
                    max_staleness=max_staleness, model=delay_model,
                    key=delay_key, num_trials=num_trials, q=q,
                    device=device)
            finally:
                problem.bandwidth_frac = saved
        return _refined_full_recompute(problem, a, max_moves, cap,
                                       score=score)
    if objective != "latency":
        raise ValueError(f"unknown refined objective {objective!r}")
    if not incremental:
        return _refined_full_recompute(problem, a, max_moves, cap)
    t_fix, t_unit = _latency_terms(problem, a)
    N, M = problem.num_ues, problem.num_edges
    edge_of = proposed(problem).argmax(1)                 # (N,)
    members = [np.flatnonzero(edge_of == m).tolist() for m in range(M)]
    counts = np.array([len(ms) for ms in members])

    def edge_lat(mem, m, c):
        # max latency of edge m hosting rows ``mem`` with count ``c``
        if not mem:
            return 0.0
        mem = np.asarray(mem)
        return float(np.max(t_fix[mem] + c * t_unit[mem, m]))

    el = np.array([edge_lat(members[m], m, counts[m]) for m in range(M)])
    cur = float(el.max())

    def trial_max(changes: dict) -> float:
        vals = el.copy()
        for m, v in changes.items():
            vals[m] = v
        return float(vals.max())

    for _ in range(max_moves):
        per_ue = t_fix + counts[edge_of] * t_unit[np.arange(N), edge_of]
        order = np.argsort(-per_ue)
        # per-edge top-2 member latencies at current counts; invariant
        # across the candidate bottleneck UEs below (state only changes
        # when a move is accepted, which restarts the outer iteration)
        top1 = np.zeros(M)
        top1_idx = np.full(M, -1)
        top2 = np.zeros(M)
        for m in range(M):
            ms = members[m]
            if not ms:
                continue
            lats = per_ue[ms]
            k = int(np.argmax(lats))
            top1[m], top1_idx[m] = lats[k], ms[k]
            if len(ms) > 1:
                top2[m] = np.max(np.delete(lats, k))
        improved = False
        for n in order[:10]:                      # top-10 bottleneck UEs
            m1 = int(edge_of[n])
            best_val, best_apply = cur, None
            mem1_wo = [i for i in members[m1] if i != n]
            el1_move = edge_lat(mem1_wo, m1, counts[m1] - 1)
            # single move to an edge with spare capacity
            for m2 in range(M):
                if m2 == m1 or counts[m2] >= cap:
                    continue
                el2 = edge_lat(members[m2] + [n], m2, counts[m2] + 1)
                v = trial_max({m1: el1_move, m2: el2})
                if v < best_val - 1e-12:
                    best_val, best_apply = v, ("move", n, m2, el1_move, el2)
            # swap with a UE on another edge (escapes capacity-tight minima)
            # — fully vectorized over n2: a swap changes only edges m1/m2,
            # and "edge max without n2" is a top-2 lookup, so every
            # candidate is O(1) after this per-edge precompute.
            base1 = edge_lat(mem1_wo, m1, counts[m1])
            lat_on_m1 = t_fix + counts[m1] * t_unit[:, m1]      # n2 joins m1
            add_n = t_fix[n] + counts * t_unit[n, :]            # n joins m2
            # max of el over edges other than {m1, m2}, for every m2
            el_ex1 = el.copy()
            el_ex1[m1] = -np.inf
            k = int(np.argmax(el_ex1))
            second = np.max(np.delete(el_ex1, k)) if M > 1 else -np.inf
            excl = np.where(np.arange(M) == k, second, el_ex1[k])
            m2v = edge_of
            rem_max = np.where(np.arange(N) == top1_idx[m2v],
                               top2[m2v], top1[m2v])
            el1v = np.maximum(base1, lat_on_m1)
            el2v = np.maximum(rem_max, add_n[m2v])
            vv = np.maximum(np.maximum(excl[m2v], el1v), el2v)
            for n2 in np.flatnonzero(m2v != m1):
                if vv[n2] < best_val - 1e-12:
                    best_val = float(vv[n2])
                    best_apply = ("swap", int(n2), int(m2v[n2]),
                                  float(el1v[n2]), float(el2v[n2]))
            if best_apply is not None:
                kind, other, m2, new_el1, new_el2 = best_apply
                if kind == "move":
                    members[m1].remove(other)     # other == n
                    members[m2].append(other)
                    counts[m1] -= 1
                    counts[m2] += 1
                    edge_of[other] = m2
                else:                             # swap n <-> other (n2)
                    members[m1].remove(n)
                    members[m2].remove(other)
                    members[m1].append(other)
                    members[m2].append(n)
                    edge_of[n], edge_of[other] = m2, m1
                el[m1], el[m2] = new_el1, new_el2
                cur = best_val
                improved = True
                break
        if not improved:
            break
    assoc = np.zeros((N, M), dtype=np.int64)
    assoc[np.arange(N), edge_of] = 1
    _assert_valid(problem, assoc, cap)
    return assoc


def _refined_full_recompute(problem: HFLProblem, a: float, max_moves: int,
                            cap: int, score=None) -> np.ndarray:
    """Full-recompute trial evaluation: ``score(assoc)`` per candidate move
    (default: eq. 38 ``association_latency``).  Same bottleneck search as
    the incremental path; also carries the pluggable async-makespan
    objective, and the bench times it against the incremental path."""
    if score is None:
        def score(A):
            return delay.association_latency(problem, A, a)
    assoc = proposed(problem)
    cur = score(assoc)
    t_cmp = problem.t_cmp()
    N = problem.num_ues
    for _ in range(max_moves):
        per_ue = np.asarray(a) * t_cmp + problem.t_com(assoc)
        order = np.argsort(-per_ue)
        improved = False
        for n in order[:10]:                      # top-10 bottleneck UEs
            m_cur = int(assoc[n].argmax())
            best_val, best_trial = cur, None
            # single move to an edge with spare capacity
            for m in range(problem.num_edges):
                if m == m_cur or assoc[:, m].sum() >= cap:
                    continue
                trial = assoc.copy()
                trial[n, m_cur], trial[n, m] = 0, 1
                v = score(trial)
                if v < best_val - 1e-12:
                    best_val, best_trial = v, trial
            # swap with a UE on another edge (escapes capacity-tight minima)
            for n2 in range(N):
                m2 = int(assoc[n2].argmax())
                if m2 == m_cur:
                    continue
                trial = assoc.copy()
                trial[n, m_cur], trial[n, m2] = 0, 1
                trial[n2, m2], trial[n2, m_cur] = 0, 1
                v = score(trial)
                if v < best_val - 1e-12:
                    best_val, best_trial = v, trial
            if best_trial is not None:
                assoc, cur = best_trial, best_val
                improved = True
                break
        if not improved:
            break
    _assert_valid(problem, assoc, cap)
    return assoc


def _kmeans(features: np.ndarray, k: int, *, iters: int = 10, seed: int = 0,
            chunk: int = 16384):
    """Plain-numpy Lloyd's k-means with CHUNKED assignment.

    Built for N up to 10^6: the (rows, k) distance block is computed via
    ``|x|^2 + |c|^2 - 2 x.c`` over ``chunk`` rows at a time, so peak
    memory is O(chunk * k) — never O(N * k).  Seeding is a cheap
    k-means++ over a 4096-row subsample with incremental min-distance
    updates.  Returns ``(assign (N,), centers (k, d))``.
    """
    X = np.asarray(features, np.float64)
    N = X.shape[0]
    k = int(min(k, N))
    rng = np.random.default_rng(seed)

    sub = X[rng.choice(N, size=min(N, 4096), replace=False)]
    centers = np.empty((k, X.shape[1]))
    centers[0] = sub[rng.integers(sub.shape[0])]
    d2 = ((sub - centers[0]) ** 2).sum(1)
    for i in range(1, k):
        tot = d2.sum()
        if tot <= 1e-12:          # duplicate points: fall back to uniform
            centers[i] = sub[rng.integers(sub.shape[0])]
        else:
            centers[i] = sub[rng.choice(sub.shape[0], p=d2 / tot)]
        d2 = np.minimum(d2, ((sub - centers[i]) ** 2).sum(1))

    assign = np.zeros(N, np.int64)
    c2 = (centers ** 2).sum(1)
    for _ in range(int(iters)):
        for s in range(0, N, chunk):
            blk = X[s:s + chunk]
            d = ((blk ** 2).sum(1)[:, None] + c2[None, :] -
                 2.0 * blk @ centers.T)
            assign[s:s + chunk] = d.argmin(1)
        counts = np.bincount(assign, minlength=k)
        for dim in range(X.shape[1]):
            sums = np.bincount(assign, weights=X[:, dim], minlength=k)
            centers[:, dim] = np.where(counts > 0, sums /
                                       np.maximum(counts, 1),
                                       centers[:, dim])
        c2 = (centers ** 2).sum(1)
    return assign, centers


def _ue_polish(t_fix, t_unit, edge_of, counts, cap, alive, max_moves):
    """Bounded per-UE bottleneck descent (the ``refined`` inner loop,
    restricted to ``alive`` edges and ``max_moves`` iterations).

    Each iteration takes the single worst UE and evaluates every move to
    an alive edge with room plus a vectorized swap scan over all N
    partners — O(N log N) per iteration, so a capped iteration count
    stays tractable at N=10^6 where ``refined``'s unbounded search (and
    its ``proposed`` warm start) do not.  Mutates and returns
    ``edge_of``/``counts``.
    """
    N, M = t_unit.shape
    rows = np.arange(N)
    alive = np.asarray(sorted(alive))
    for _ in range(int(max_moves)):
        per_ue = t_fix + counts[edge_of] * t_unit[rows, edge_of]
        # per-edge top-2 member latencies via one descending argsort
        order = np.argsort(-per_ue, kind="stable")
        m_ord = edge_of[order]
        top1 = np.zeros(M)
        top1_idx = np.full(M, -1)
        top2 = np.zeros(M)
        u, idx = np.unique(m_ord, return_index=True)
        top1[u] = per_ue[order[idx]]
        top1_idx[u] = order[idx]
        keep = np.ones(N, bool)
        keep[idx] = False
        u2, idx2 = np.unique(m_ord[keep], return_index=True)
        top2[u2] = per_ue[order[keep][idx2]]
        el = top1
        n = int(order[0])
        m1 = int(edge_of[n])
        cur = float(el.max())
        base1 = top2[m1] if top1_idx[m1] == n else top1[m1]
        best = None                      # (v, kind, other/m2, el1, el2)
        for m2 in alive:
            if m2 == m1 or counts[m2] >= cap:
                continue
            mem2 = np.flatnonzero(edge_of == m2)
            mem1 = np.flatnonzero(edge_of == m1)
            mem1 = mem1[mem1 != n]
            c1, c2 = counts[m1] - 1, counts[m2] + 1
            el1 = float((t_fix[mem1] + c1 * t_unit[mem1, m1]).max()) \
                if mem1.size else 0.0
            el2 = float(max((t_fix[mem2] + c2 * t_unit[mem2, m2]).max()
                            if mem2.size else 0.0,
                            t_fix[n] + c2 * t_unit[n, m2]))
            trial = el.copy()
            trial[m1], trial[m2] = el1, el2
            v = float(trial.max())
            if v < cur - 1e-12 and (best is None or v < best[0]):
                best = (v, "move", m2, el1, el2)
        # vectorized swap scan: n <-> n2 for every n2 off edge m1
        el_ex1 = el.copy()
        el_ex1[m1] = -np.inf
        k = int(np.argmax(el_ex1))
        second = np.max(np.delete(el_ex1, k)) if M > 1 else -np.inf
        excl = np.where(np.arange(M) == k, second, el_ex1[k])
        m2v = edge_of
        rem_max = np.where(rows == top1_idx[m2v], top2[m2v], top1[m2v])
        el1v = np.maximum(base1, t_fix + counts[m1] * t_unit[:, m1])
        el2v = np.maximum(rem_max, t_fix[n] + counts[m2v] *
                          t_unit[n, m2v])
        vv = np.maximum(np.maximum(excl[m2v], el1v), el2v)
        vv = np.where(m2v == m1, np.inf, vv)
        n2 = int(np.argmin(vv))
        if vv[n2] < cur - 1e-12 and (best is None or vv[n2] < best[0]):
            best = (float(vv[n2]), "swap", n2,
                    float(el1v[n2]), float(el2v[n2]))
        if best is None:
            break
        _, kind, other, _, _ = best
        if kind == "move":
            counts[m1] -= 1
            counts[other] += 1
            edge_of[n] = other
        else:
            edge_of[n], edge_of[other] = edge_of[other], m1
    return edge_of, counts


def cluster_refined(problem: HFLProblem, a: float = 10.0, *,
                    num_clusters: Optional[int] = None,
                    max_moves: int = 100, polish_moves: int = 200,
                    dead_edges=(), seed: int = 0,
                    kmeans_iters: int = 10) -> np.ndarray:
    """Scalable ``refined``: associate CLUSTERS of UEs, not individuals.

    ``refined``'s per-UE swap scan is O(N) per candidate move — fine at
    N≈10^2-10^3, untenable at the 10^5-10^6 the sampled-participation
    path targets.  This variant (BEYOND-PAPER; D2D-style clustering):

    1. k-means clusters the UEs on (normalized location, standardized
       log best-SNR) — geographic proximity dominates, the rate proxy
       separates UEs that share a spot but not a channel;
    2. greedily places whole clusters (largest first) on the alive edge
       with the best cluster-mean SNR that has capacity;
    3. runs the bottleneck descent at CLUSTER granularity: find the
       eq. 38 bottleneck UE, try moving ITS CLUSTER to every other alive
       edge with room, accept the best strict improvement.

    ``dead_edges`` are excluded from every placement and every move (the
    outage-aware variant, cf. the JAX package's ``failover``); capacity is
    relaxed the same way ``failover`` relaxes it when edges are down.  Returns a valid
    (N, M) one-hot association.
    """
    N, M = problem.num_ues, problem.num_edges
    dead = {int(m) for m in dead_edges}
    alive = [m for m in range(M) if m not in dead]
    if not alive:
        raise ValueError("cluster_refined: every edge is dead")
    cap = capacity_of(problem)
    if dead:
        cap = max(cap, int(np.ceil(N / len(alive))))

    snr = problem.snr()                                       # (N, M)
    pos = problem.ue_pos / problem.area
    r = np.log10(np.maximum(snr.max(axis=1), 1e-12))
    r = (r - r.mean()) / (r.std() + 1e-12)
    feats = np.c_[pos, 0.25 * r]
    k = int(num_clusters or min(max(8 * M, 64), N))
    assign, _ = _kmeans(feats, k, iters=kmeans_iters, seed=seed)

    raw = [np.flatnonzero(assign == c) for c in range(k)]
    raw = [c for c in raw if c.size]
    raw_sizes = np.array([c.size for c in raw])
    # cluster-mean log-SNR to each edge drives the greedy placement
    raw_pref = np.stack([np.log10(np.maximum(snr[c], 1e-12)).mean(0)
                         for c in raw])                       # (C, M)

    # Greedy placement, largest cluster first.  A cluster that fits
    # nowhere whole is SPILLED across edges in preference order — the
    # spilled parts become separate groups so the move scan below still
    # relocates whole groups.
    counts = np.zeros(M, np.int64)
    placed: list = []                    # (rows, edge) groups
    for c in np.argsort(-raw_sizes):
        rows, prefc = raw[c], raw_pref[c]
        order = sorted(alive, key=lambda m: -prefc[m])
        fit = [m for m in order if counts[m] + rows.size <= cap]
        if fit:
            placed.append((rows, fit[0]))
            counts[fit[0]] += rows.size
            continue
        off = 0
        for m in order:
            room = int(cap - counts[m])
            if room <= 0:
                continue
            part = rows[off:off + room]
            if part.size:
                placed.append((part, m))
                counts[m] += part.size
                off += part.size
            if off >= rows.size:
                break
        assert off >= rows.size, "capacity infeasible"

    clusters = [rows for rows, _ in placed]
    C = len(clusters)
    sizes = np.array([c.size for c in clusters])
    edge_of = np.array([m for _, m in placed], np.int64)

    t_fix, t_unit = _latency_terms(problem, a)

    # Latency envelope per (group, edge): the argmax member at cnt=cap
    # gives a line fix + cnt * unit that tracks the group's true max —
    # exact at cnt=cap (the regime the tight bandwidth cap pins us to),
    # a tight proxy elsewhere.  O(N*M) once; every swap eval after this
    # touches only these (C, M) tables, never the raw UE rows.
    cols = np.arange(M)
    E_fix = np.empty((C, M))
    E_unit = np.empty((C, M))
    for c, rows in enumerate(clusters):
        sc = t_fix[rows][:, None] + cap * t_unit[rows]        # (|c|, M)
        r = rows[np.argmax(sc, axis=0)]
        E_fix[c] = t_fix[r]
        E_unit[c] = t_unit[r, cols]

    members = [np.flatnonzero(edge_of == m) for m in range(M)]

    def _lat(mem, m, cnt):
        if mem.size == 0 or cnt == 0:
            return 0.0
        return float((E_fix[mem, m] + cnt * E_unit[mem, m]).max())

    el = np.array([_lat(members[m], m, counts[m]) for m in range(M)])
    for _ in range(int(max_moves)):
        mb = int(np.argmax(el))
        S = members[mb]
        if S.size == 0:
            break
        vals = E_fix[S, mb] + counts[mb] * E_unit[S, mb]
        sources = S[np.argsort(-vals)[:8]]   # worst offenders first
        cur = float(el.max())
        best = None          # (v, cs, m2, c2_or_None, lat_mb, lat_m2)
        for cs in sources:
            sz = sizes[cs]
            S_less = S[S != cs]
            for m2 in alive:
                if m2 == mb:
                    continue
                T = members[m2]
                # plain move, if the target has room
                if counts[m2] + sz <= cap:
                    lat_mb = _lat(S_less, mb, counts[mb] - sz)
                    lat_m2 = _lat(np.append(T, cs), m2, counts[m2] + sz)
                    trial = el.copy()
                    trial[mb], trial[m2] = lat_mb, lat_m2
                    v = float(trial.max())
                    if v < cur - 1e-12 and (best is None or v < best[0]):
                        best = (v, cs, m2, None, lat_mb, lat_m2)
                # swaps cs <-> c2 (how refined escapes a tight cap)
                for c2 in T:
                    s2 = sizes[c2]
                    if (counts[mb] - sz + s2 > cap or
                            counts[m2] - s2 + sz > cap):
                        continue
                    nb, n2 = counts[mb] - sz + s2, counts[m2] - s2 + sz
                    lat_mb = _lat(np.append(S_less, c2), mb, nb)
                    lat_m2 = _lat(np.append(T[T != c2], cs), m2, n2)
                    trial = el.copy()
                    trial[mb], trial[m2] = lat_mb, lat_m2
                    v = float(trial.max())
                    if v < cur - 1e-12 and (best is None or v < best[0]):
                        best = (v, cs, m2, c2, lat_mb, lat_m2)
        if best is None:
            break
        _, cs, m2, c2, lat_mb, lat_m2 = best
        sz = sizes[cs]
        members[mb] = members[mb][members[mb] != cs]
        members[m2] = np.append(members[m2], cs)
        counts[mb] -= sz
        counts[m2] += sz
        edge_of[cs] = m2
        if c2 is not None:
            s2 = sizes[c2]
            members[m2] = members[m2][members[m2] != c2]
            members[mb] = np.append(members[mb], c2)
            counts[m2] -= s2
            counts[mb] += s2
            edge_of[c2] = mb
        el[mb], el[m2] = lat_mb, lat_m2

    ue_edge = np.empty(N, np.int64)
    for c, rows in enumerate(clusters):
        ue_edge[rows] = edge_of[c]
    if polish_moves:
        ue_edge, counts = _ue_polish(t_fix, t_unit, ue_edge, counts,
                                     cap, alive, polish_moves)

    assoc = np.zeros((N, M), np.int64)
    assoc[np.arange(N), ue_edge] = 1
    _assert_valid(problem, assoc, cap)
    assert not any(assoc[:, m].any() for m in dead), \
        "cluster placed on a dead edge"
    return assoc


STRATEGIES = {
    "proposed": lambda p, **kw: proposed(p),
    "refined": lambda p, a=10.0, **kw: refined(p, a=a),
    "cluster": lambda p, a=10.0, seed=0, **kw: cluster_refined(p, a=a,
                                                               seed=seed),
    "greedy": lambda p, **kw: greedy(p),
    "random": lambda p, seed=0, **kw: random_assoc(p, seed=seed),
}
