"""Federated partitioners: split a dataset across N UEs.

Every partitioner returns a list of index arrays (one per UE); sizes D_n
and the label-skew profile are what the paper's delay model consumes
(D_n enters t_cmp via eq. 1).

Copied from the JAX package's ``repro/data/partition.py`` (numpy only).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def iid_partition(rng: np.random.Generator, n_samples: int,
                  num_ues: int) -> List[np.ndarray]:
    idx = rng.permutation(n_samples)
    return [np.sort(part) for part in np.array_split(idx, num_ues)]


def size_partition(rng: np.random.Generator, n_samples: int,
                   sizes: Sequence[int]) -> List[np.ndarray]:
    """Partition honoring the paper's heterogeneous D_n draws."""
    sizes = np.asarray(sizes, int)
    total = int(sizes.sum())
    idx = rng.choice(n_samples, size=total, replace=total > n_samples)
    out, ofs = [], 0
    for s in sizes:
        out.append(np.sort(idx[ofs:ofs + s]))
        ofs += s
    return out


def dirichlet_partition(rng: np.random.Generator, labels: np.ndarray,
                        num_ues: int, alpha: float = 0.5,
                        min_size: int = 2) -> List[np.ndarray]:
    """Non-IID label-skew split (Dirichlet over class proportions)."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    while True:
        buckets: List[list] = [[] for _ in range(num_ues)]
        for c in classes:
            pool = np.flatnonzero(labels == c)
            rng.shuffle(pool)
            props = rng.dirichlet([alpha] * num_ues)
            splits = (np.cumsum(props) * len(pool)).astype(int)[:-1]
            for u, part in enumerate(np.split(pool, splits)):
                buckets[u].extend(part.tolist())
        if min(len(b) for b in buckets) >= min_size:
            return [np.sort(np.array(b, int)) for b in buckets]
        alpha *= 2.0   # too skewed to satisfy min_size — soften
