"""The training stores, written and read by the benchmark itself.

The port's `NativeTrainLoader` memory-maps fixed-record stores (a raw
.bin and an np.save'd {"shape", "dtype"} in .bin.meta.npy) and draws its
batches on C++ worker threads (csrc/batch_sampler.cpp). `StoreDraws`
works out the same batches again from the loader's seed and the arrays the
benchmark wrote, so the reference trains on batches the benchmark drew,
and each batch the loader hands the port is held against them.
"""

import numpy as np

M64 = (1 << 64) - 1
# std::mt19937_64's parameters (C++11 [rand.predef]).
_N, _M = 312, 156
_MATRIX_A = 0xB5026F5AA96619E9
_UPPER, _LOWER = 0xFFFFFFFF80000000, 0x7FFFFFFF
# The loader seeds worker w with seed + _GOLDEN * (w + 1).
_GOLDEN = 0x9E3779B97F4A7C15


def write_store(path, array):
    """An (N, ...) array as a store the loader reads."""
    array = np.ascontiguousarray(array)
    array.tofile(path)
    np.save(path + ".meta.npy", {"shape": array.shape, "dtype": str(array.dtype)},
            allow_pickle=True)
    return path


class MT19937_64:
    """std::mt19937_64, output for output."""

    def __init__(self, seed):
        mt = [seed & M64]
        for i in range(1, _N):
            mt.append((6364136223846793005 * (mt[-1] ^ (mt[-1] >> 62)) + i) & M64)
        self.mt, self.i = mt, _N

    def _twist(self):
        mt = self.mt
        for i in range(_N):
            x = (mt[i] & _UPPER) | (mt[(i + 1) % _N] & _LOWER)
            mt[i] = mt[(i + _M) % _N] ^ (x >> 1) ^ (_MATRIX_A if x & 1 else 0)
        self.i = 0

    def __call__(self):
        if self.i >= _N:
            self._twist()
        y = self.mt[self.i]
        self.i += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        y ^= y >> 43
        return y & M64


class StoreDraws:
    """The batches the loader's workers draw, read from the stores' arrays.

    Worker w draws per item one number r from its own generator; every
    store as long as the first takes record r % n_0, and each other store
    (in store order) one further draw, rng() % n_s. A worker's batches reach
    the loader's queue in its own order; the workers' interleave as the
    threads finish, so a batch handed out is the next batch of some worker.

    :param arrays: the stores' arrays, in the loader's store order
    :param keys: the loader's name for each store
    """

    def __init__(self, arrays, keys, batch_size, seed, n_workers):
        self.arrays, self.keys, self.B = arrays, keys, batch_size
        self.rngs = [MT19937_64((seed + _GOLDEN * (w + 1)) & M64)
                     for w in range(n_workers)]
        self.next_batch = [None] * n_workers

    def _draw(self, w):
        rng, n0 = self.rngs[w], len(self.arrays[0])
        idx = [[] for _ in self.arrays]
        for _ in range(self.B):
            r = rng()
            for s, a in enumerate(self.arrays):
                if len(a) == n0:
                    idx[s].append(r % n0)
            for s, a in enumerate(self.arrays):
                if len(a) != n0:
                    idx[s].append(rng() % len(a))
        return {k: a[np.asarray(i)] for k, a, i in zip(self.keys, self.arrays, idx)}

    def _peek(self, w):
        if self.next_batch[w] is None:
            self.next_batch[w] = self._draw(w)
        return self.next_batch[w]

    def take(self, w=0):
        """Worker w's next batch."""
        batch, self.next_batch[w] = self._peek(w), None
        return batch

    def match(self, fed):
        """The benchmark's own batch for a batch the loader handed out: the
        next batch of the worker it equals, or, where it equals none, the
        first worker's next one.

        :return: (batch, whether the loader's batch equals it)
        """
        for w in range(len(self.rngs)):
            if all(np.array_equal(fed[k], self._peek(w)[k]) for k in self.keys):
                return self.take(w), True
        return self.take(0), False
