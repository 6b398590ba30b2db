"""What a run makes from its seed and hands to the port and to the
reference alike: the weights, the synthetic SMPL model's arrays, and the
random draws of the steps.

Weights are drawn on the device, in one call a model: each conv and linear
weight N(0, 1 / fan_in), biases zero, BatchNorms the identity (the port's
models/weights.py::init_weights, drawn in one block in place of leaf by
leaf). Keys are those of the reference's models, which carry the port's
state-dict names.
"""

import numpy as np
import torch
from torch import nn

# Streams of a seed: each kind of input draws from its own.
STREAM_WEIGHTS, STREAM_HRNET, STREAM_DATA, STREAM_DRAWS, STREAM_SAMPLES = range(5)


def substream(seed, stream):
    """A 63-bit seed of `stream` under the run's seed (any whole number)."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, stream])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def seeded_weights(model, seed, device):
    """A state dict for `model`'s conv, linear and BatchNorm leaves, drawn
    on `device` from `seed` in one call; other buffers are left out.

    :param model: a reference model (may live on the meta device)
    """
    convs, norms = [], []
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            convs.append((name, m))
        elif isinstance(m, nn.BatchNorm2d):
            norms.append((name, m))
    total = sum(m.weight.numel() for _, m in convs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, m in convs:
        n, shape = m.weight.numel(), tuple(m.weight.shape)
        fan_in = n // shape[0]
        out[f"{name}.weight"] = flat[offset:offset + n].view(shape) / fan_in ** 0.5
        offset += n
        if m.bias is not None:
            out[f"{name}.bias"] = torch.zeros(m.bias.shape, device=device)
    for name, m in norms:
        c = m.num_features
        out[f"{name}.weight"] = torch.ones(c, device=device)
        out[f"{name}.bias"] = torch.zeros(c, device=device)
        out[f"{name}.running_mean"] = torch.zeros(c, device=device)
        out[f"{name}.running_var"] = torch.ones(c, device=device)
        out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64,
                                                         device=device)
    return out


def load_weights(model, weights):
    """Load `weights` into `model`: every key must exist, and every conv,
    linear and BatchNorm leaf of the model must be given."""
    own = model.state_dict()
    missing = [k for k in weights if k not in own]
    if missing:
        raise KeyError(f"weights for keys the model lacks: {missing[:5]}")
    for k, v in weights.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: {tuple(v.shape)} for {tuple(own[k].shape)}")
    leaves = set(seeded_weights_keys(model))
    if leaves - set(weights):
        raise KeyError(f"no weights for {sorted(leaves - set(weights))[:5]}")
    model.load_state_dict(weights, strict=False)
    return model


def seeded_weights_keys(model):
    keys = []
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.BatchNorm2d)):
            keys.extend(f"{name}.{k}" for k, _ in m.state_dict().items())
    return keys


def smpl_arrays(num_betas=10):
    """The synthetic SMPL model's numpy arrays in SMPL's published shapes
    (6890 vertices, 13776 faces, 24 joints), from the reference's copy of
    the generator (seed 0: the model the port's CLIs fall back to)."""
    from hp3d_bench.reference.models.smpl import synthetic_smpl_params
    return synthetic_smpl_params(num_betas=num_betas, seed=0)


class Draws:
    """A draw source with the interface of the port's
    utils/random_draws.py: split / normal / uniform / randint, drawn in
    sequence from one torch.Generator on the device. While `recording` it
    keeps a copy of every tensor it hands out, for Replay."""

    def __init__(self, seed, device):
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.device = torch.device(device)
        self.recording = False
        self.record = []

    def split(self, n=2):
        return [self] * n

    def _out(self, t):
        if self.recording:
            self.record.append(t.clone())
        return t

    def normal(self, shape):
        return self._out(torch.randn(shape, generator=self.generator,
                                     device=self.device))

    def uniform(self, shape, minval=0.0, maxval=1.0):
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return self._out(u * (maxval - minval) + minval)

    def randint(self, shape, minval, maxval):
        if maxval <= minval:
            return self._out(torch.full(shape, minval, dtype=torch.int64,
                                        device=self.device))
        return self._out(torch.randint(minval, maxval, shape,
                                       generator=self.generator,
                                       device=self.device))


class Replay:
    """Hands out recorded draws again, in order. Where the reference asks
    for a draw the record does not hold in that shape (the port drew
    otherwise), it draws afresh from `fallback` and counts a mismatch, so
    that the comparison, not a crash, reports the difference."""

    def __init__(self, record, fallback):
        self.record = list(record)
        self.i = 0
        self.fallback = fallback
        self.mismatches = 0

    def split(self, n=2):
        return [self] * n

    def _next(self, shape, fresh):
        if self.i < len(self.record) and tuple(self.record[self.i].shape) == tuple(shape):
            self.i += 1
            return self.record[self.i - 1]
        self.i += 1
        self.mismatches += 1
        return fresh()

    def normal(self, shape):
        return self._next(shape, lambda: self.fallback.normal(shape))

    def uniform(self, shape, minval=0.0, maxval=1.0):
        return self._next(shape, lambda: self.fallback.uniform(shape, minval, maxval))

    def randint(self, shape, minval, maxval):
        return self._next(shape, lambda: self.fallback.randint(shape, minval, maxval))
