"""Synthetic datasets (MNIST is unavailable offline).

* ``synthetic_mnist``        — 28x28x1 class-mean Gaussian images, 10 classes.
  Same tensor shapes as MNIST so LeNet runs unchanged.
* ``logreg_data``            — low-dimensional Gaussian-mixture features for
  the strongly-convex logistic-regression task (Assumption 1 holds).

* ``TokenStream``           — order-2 Markov pseudo-text token batches
  (prompts for the transformer stack's serving path).

Copied from the JAX package's ``repro/data/synthetic.py`` (numpy only), so
both packages draw byte-identical data from the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def class_gaussian_images(rng: np.random.Generator, n: int, *,
                          num_classes: int = 10, size: int = 28,
                          channels: int = 1, noise: float = 0.8):
    """Images ~ N(mu_class, noise^2 I); mu_class is a fixed random pattern."""
    mu_rng = np.random.default_rng(12345)      # class means fixed across UEs
    means = mu_rng.normal(0.0, 1.0, (num_classes, size, size, channels))
    labels = rng.integers(0, num_classes, n)
    imgs = means[labels] + rng.normal(0.0, noise, (n, size, size, channels))
    return imgs.astype(np.float32), labels.astype(np.int32)


def synthetic_mnist(seed: int = 0, n_train: int = 6000, n_test: int = 1000):
    rng = np.random.default_rng(seed)
    xtr, ytr = class_gaussian_images(rng, n_train)
    xte, yte = class_gaussian_images(rng, n_test)
    return {"images": xtr, "labels": ytr}, {"images": xte, "labels": yte}


def logreg_data(seed: int = 0, n: int = 2000, dim: int = 32,
                num_classes: int = 10, margin: float = 2.0):
    rng = np.random.default_rng(seed)
    mu_rng = np.random.default_rng(54321)      # class means fixed across splits
    means = mu_rng.normal(0.0, margin, (num_classes, dim))
    labels = rng.integers(0, num_classes, n)
    x = means[labels] + rng.normal(0.0, 1.0, (n, dim))
    return {"images": x.astype(np.float32), "labels": labels.astype(np.int32)}


@dataclasses.dataclass
class TokenStream:
    """Deterministic pseudo-text: order-2 Markov chain over the vocab.

    Learnable structure (bigram statistics) so training loss decreases;
    fully reproducible from the seed; no files.
    """
    vocab_size: int
    seed: int = 0

    def batch(self, batch_size: int, seq_len: int, step: int = 0):
        rng = np.random.default_rng((self.seed, step))
        v = self.vocab_size
        # next = (a*prev + b*prev2 + noise) mod v — cheap learnable chain
        a, b = 31, 17
        toks = np.zeros((batch_size, seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, batch_size)
        toks[:, 1] = rng.integers(0, v, batch_size)
        for t in range(2, seq_len + 1):
            noise = rng.integers(0, 7, batch_size)
            toks[:, t] = (a * toks[:, t - 1] + b * toks[:, t - 2] + noise) % v
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}
