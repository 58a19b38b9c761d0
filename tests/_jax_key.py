"""The port's key protocol over ``jax.random``, for the parity tests.

``JaxKey`` implements what ``repro_torch.core.stochastic.Key`` offers
(``split``, ``fold_in``, ``normal``, ``exponential``, ``uniform``,
``gumbel``) with the reference's own variates, as float32 CPU tensors, so
the reference's draws go through the port's code.  ``JaxKey(seed)`` holds
``jax.random.PRNGKey(seed)``, the key the reference makes of an int seed.
"""
import jax
import numpy as np
import torch


class JaxKey:
    device = torch.device("cpu")

    def __init__(self, key):
        self.key = jax.random.PRNGKey(key) if isinstance(key, int) else key

    def split(self, n=2):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, i):
        return JaxKey(jax.random.fold_in(self.key, int(i)))

    @staticmethod
    def _t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def normal(self, shape):
        return self._t(jax.random.normal(self.key, tuple(shape)))

    def exponential(self, shape):
        return self._t(jax.random.exponential(self.key, tuple(shape)))

    def uniform(self, shape, minval=0.0, maxval=1.0):
        return self._t(jax.random.uniform(self.key, tuple(shape),
                                          minval=minval, maxval=maxval))

    def gumbel(self, shape):
        return self._t(jax.random.gumbel(self.key, tuple(shape)))
