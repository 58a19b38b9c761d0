"""The benchmark's inputs, made from the seed.

Frozen copies of the program's generators (``repro_torch/data/
synthetic.py``: ``class_gaussian_images``, ``TokenStream``;
``repro_torch/data/partition.py``: ``size_partition``), so a change to the
program cannot change the inputs.  The images are drawn on the device
with a ``torch.Generator`` in two large calls (the class means stay the
program's fixed pattern from ``numpy`` seed 12345); the token chain and
the partition stay in numpy, as the program's are.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def class_gaussian_images(gen, n: int, *, num_classes: int = 10,
                          size: int = 28, channels: int = 1,
                          noise: float = 0.8, mean_seed: int = 12345):
    """``n`` images N(mu_class, noise^2 I) and their labels, on ``gen``'s
    device: (n, size, size, channels) fp32 and (n,) int32."""
    import torch
    dev = gen.device
    means = np.random.default_rng(mean_seed).normal(
        0.0, 1.0, (num_classes, size, size, channels)).astype(np.float32)
    means = torch.as_tensor(means, device=dev)
    labels = torch.randint(0, num_classes, (n,), generator=gen, device=dev)
    imgs = torch.randn((n, size, size, channels), generator=gen, device=dev)
    imgs.mul_(noise).add_(means[labels])
    return imgs, labels.to(torch.int32)


def size_partition(rng: np.random.Generator, n_samples: int, sizes):
    """Index arrays, one a UE, of the UEs' D_n sizes: the paper's
    heterogeneous split."""
    sizes = np.asarray(sizes, int)
    total = int(sizes.sum())
    idx = rng.choice(n_samples, size=total, replace=total > n_samples)
    out, ofs = [], 0
    for s in sizes:
        out.append(np.sort(idx[ofs:ofs + s]))
        ofs += s
    return out


@dataclasses.dataclass
class TokenStream:
    """Order-2 Markov pseudo-text over the vocabulary, from the seed."""
    vocab_size: int
    seed: int = 0

    def batch(self, batch_size: int, seq_len: int, step: int = 0):
        rng = np.random.default_rng((self.seed, step))
        v = self.vocab_size
        a, b = 31, 17
        toks = np.zeros((batch_size, seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, batch_size)
        toks[:, 1] = rng.integers(0, v, batch_size)
        for t in range(2, seq_len + 1):
            noise = rng.integers(0, 7, batch_size)
            toks[:, t] = (a * toks[:, t - 1] + b * toks[:, t - 2] + noise) % v
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}
