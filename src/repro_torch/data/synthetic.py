"""Synthetic datasets (MNIST is unavailable offline).

* ``synthetic_mnist``        — 28x28x1 class-mean Gaussian images, 10 classes.
  Same tensor shapes as MNIST so LeNet runs unchanged.
* ``logreg_data``            — low-dimensional Gaussian-mixture features for
  the strongly-convex logistic-regression task (Assumption 1 holds).

Copied from the JAX package's ``repro/data/synthetic.py`` (numpy only), so
both packages draw byte-identical data from the same seed.  Its
``TokenStream`` waits for the transformer stack (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

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
