"""Where the port's random functions take their draws from.

The JAX package threads explicit PRNG keys through its random functions and
splits them (`keys = jax.random.split(key, 8)`). The port's counterparts
take a draw source with the same shape of interface: `split(n)` gives n
sources, and `normal`, `uniform` and `randint` give tensors of the JAX
functions' meaning (uniform's minval/maxval scaling included). In a run the
source is `Draws`, one `torch.Generator` drawn in sequence (`split` hands
out the same source). A parity test hands the port a source that rebuilds
the JAX function's own draws from its key tree, so port and reference see
the same numbers.
"""

import torch


class Draws:
    """Draws from one torch.Generator, delivered on `device` (the
    generator's own device unless another is named: a CPU generator feeding
    CUDA tensors gives the card the CPU's numbers)."""

    def __init__(self, generator, device=None):
        self.generator = generator
        self.device = torch.device(device if device is not None
                                   else generator.device)

    def split(self, n=2):
        return [self] * n

    def _to(self, x):
        return x if x.device == self.device else x.to(self.device)

    def normal(self, shape):
        return self._to(torch.randn(shape, generator=self.generator,
                                    device=self.generator.device))

    def uniform(self, shape, minval=0.0, maxval=1.0):
        u = torch.rand(shape, generator=self.generator,
                       device=self.generator.device)
        return self._to(u * (maxval - minval) + minval)

    def randint(self, shape, minval, maxval):
        if maxval <= minval:       # an empty range gives minval, as in JAX
            return torch.full(shape, minval, dtype=torch.int64, device=self.device)
        return self._to(torch.randint(minval, maxval, shape,
                                      generator=self.generator,
                                      device=self.generator.device))
