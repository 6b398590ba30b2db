"""The benchmark's own draw of the training batches (stores.py) against
the port's NativeTrainLoader, which builds its C++ sampler on the host."""

import os

import numpy as np
import pytest
from conftest import tiny

from hp3d_bench import harness, inputs, stores
from hp3d_bench.paths import train

SEED = 2 ** 31 + 4099


def test_mt19937_64_gives_the_standards_10000th_output():
    # C++11 [rand.predef]: the 10000th output of a default-constructed
    # std::mt19937_64 (seed 5489).
    rng = stores.MT19937_64(5489)
    for _ in range(9999):
        rng()
    assert rng() == 9981545732273789042


@pytest.mark.parametrize("threads", [1, 2])
def test_loader_batches_are_the_benchmarks_own_draw(tmp_path, threads):
    from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
        NativeTrainLoader)
    files = tiny("r18.train.s2.b72")
    files[2]["params"]["loader_threads"] = threads
    ctx = harness.Context("r18.train.s2.b72", SEED, 0, 0, "cpu", 0.0, files=files)
    root = os.path.join(tmp_path, "stores")
    arrays = train.write_stores(root, SEED, ctx.traffic, 32)
    own = train.store_draws(ctx, arrays)
    loader = NativeTrainLoader(root, ctx.traffic["batch"], n_threads=threads,
                               seed=inputs.substream(SEED, inputs.STREAM_DATA))
    try:
        batches = train.endless(loader)
        for _ in range(8):
            batch = next(batches)
            mine, same = own.match(batch)
            assert same
            for k in train.LOADER_KEYS:
                np.testing.assert_array_equal(batch[k], mine[k])
        # A record altered in a batch the loader handed out is a miss.
        batch = {k: np.array(v) for k, v in next(batches).items()}
        batch["texture"][0, 0, 0] ^= 1
        assert own.match(batch)[1] is False
    finally:
        loader.close()

