"""A draw source for the port's random functions that rebuilds the JAX
package's own draws from its key tree (see the port's
utils/random_draws.py): `split` splits the key as jax.random.split does,
and each draw is the JAX draw of the same meaning from the current key, so
the port and the JAX function see the same numbers."""

import numpy as np
import jax
import torch


class JaxDraws:
    def __init__(self, key, device="cpu"):
        self.key = key
        self.device = device

    def split(self, n=2):
        return [JaxDraws(k, self.device) for k in jax.random.split(self.key, n)]

    def _t(self, a):
        return torch.from_numpy(np.array(a)).to(self.device)

    def normal(self, shape):
        return self._t(jax.random.normal(self.key, shape))

    def uniform(self, shape, minval=0.0, maxval=1.0):
        return self._t(jax.random.uniform(self.key, shape, minval=minval,
                                          maxval=maxval))

    def randint(self, shape, minval, maxval):
        return self._t(jax.random.randint(self.key, shape, minval, maxval)).long()
