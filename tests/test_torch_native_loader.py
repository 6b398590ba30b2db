"""The port's native C++ batch sampler (data/native_loader.py,
csrc/batch_sampler.cpp) against the JAX package's
(data/native_loader.py, native/batch_sampler.cpp) on the CPU.

- The store format is shared: a store written by either package reads
  back in the other with equal shape, dtype and bytes.
- On stores of equal record counts, the two samplers with one worker
  thread give byte-equal batches, shuffled and sequential.
- On the JAX pack tool's stores, whose counts differ (every pose, texture
  and background), JAX's NativeTrainLoader raises its AssertionError (a
  fault of the JAX package, logged in ROADMAP Queue 3); the port's yields
  batches whose records each belong to their own store, with an epoch of
  the poses' count over the batch size, and draws textures apart from
  poses.
- In sequential mode with several threads no window comes twice (JAX's
  workers read the window counter and add to it in two steps).
- With several threads the batches come in one order: worker j % n's, as
  one thread of its generator draws them; sequential windows in order
  (the test above).
- Closing a sampler whose threads wait for room never hangs.
- A failed build or a failed sampler call raises.
"""

import os

import cv2
import numpy as np
import pytest

from hierarchicalprobabilistic3dhuman_tpu.data import native_loader as jnl
from hierarchicalprobabilistic3dhuman_tpu.data import pack_training_stores as jpack

from hierarchicalprobabilistic3dhuman_torch.data import native_loader as tnl

PACKAGES = {"jax": jnl, "port": tnl}


@pytest.fixture(scope="module")
def equal_stores(tmp_path_factory):
    """Poses (50, 72) float32, backgrounds (50, 3, 16, 16) uint8 and
    texels (50, 7829, 3) uint8, from a seed."""
    d = tmp_path_factory.mktemp("equal")
    rng = np.random.RandomState(0)
    arrays = {"poses": rng.randn(50, 72).astype(np.float32),
              "backgrounds": (rng.rand(50, 3, 16, 16) * 255).astype(np.uint8),
              "textures": (rng.rand(50, 7829, 3) * 255).astype(np.uint8)}
    return {name: tnl.write_tensor_store(str(d / f"{name}.bin"), a)
            for name, a in arrays.items()}, arrays


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_store_reads_back_in_the_other_package(tmp_path, writer, reader):
    rng = np.random.RandomState(1)
    for name, a in (("poses", rng.randn(7, 72).astype(np.float32)),
                    ("texels", (rng.rand(7, 5, 3) * 255).astype(np.uint8))):
        path = PACKAGES[writer].write_tensor_store(str(tmp_path / f"{name}.bin"), a)
        shape, dtype = PACKAGES[reader].read_store_meta(path)
        assert shape == a.shape and dtype == a.dtype
        back = np.fromfile(path, dtype=dtype).reshape(shape)
        assert back.tobytes() == a.tobytes()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sampler_bytes_equal_jax_on_equal_counts(equal_stores, seed, shuffle):
    """One worker thread each: the first 5 batches byte-equal, field by
    field."""
    paths, _ = equal_stores
    order = [paths["poses"], paths["backgrounds"], paths["textures"]]
    js = jnl.NativeBatchSampler(order, 8, n_threads=1, seed=seed, shuffle=shuffle)
    ts = tnl.NativeBatchSampler(order, 8, n_threads=1, seed=seed, shuffle=shuffle)
    try:
        for _ in range(5):
            for j, t in zip(js.next(), ts.next()):
                assert j.dtype == t.dtype and j.shape == t.shape
                assert j.tobytes() == t.tobytes()
    finally:
        js.close()
        ts.close()


def write_jpgs(folder, n, seed):
    os.makedirs(folder)
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = (rng.rand(24, 32, 3) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(folder, f"bg_{i:03d}.jpg"), img)


@pytest.fixture(scope="module")
def unequal_stores(tmp_path_factory):
    """The JAX pack tool's stores of 40 poses, 2 grey + 3 non-grey atlases
    sampled per vertex, and 7 backgrounds at 16^2; each pose and each
    background is unique, and so is each texture record."""
    d = tmp_path_factory.mktemp("unequal")
    rng = np.random.RandomState(2)
    np.savez(d / "poses.npz", poses=rng.randn(40, 72).astype(np.float32))
    np.savez(d / "textures.npz",
             grey=(rng.rand(2, 60, 40, 3) * 255).astype(np.uint8),
             nongrey=(rng.rand(3, 60, 40, 3) * 255).astype(np.uint8))
    write_jpgs(str(d / "bgs"), 7, seed=3)
    out = d / "stores"
    out.mkdir()
    jpack.pack_poses(str(d / "poses.npz"), str(out / "poses.bin"))
    jpack.pack_textures(str(d / "textures.npz"), str(out / "textures.bin"))
    jpack.pack_backgrounds(str(d / "bgs"), str(out / "backgrounds.bin"), img_wh=16)
    records = {name: np.fromfile(str(out / f"{name}.bin"), dtype=dtype).reshape(shape)
               for name in ("poses", "textures", "backgrounds")
               for shape, dtype in [jnl.read_store_meta(str(out / f"{name}.bin"))]}
    return str(out), records


def record_index(records, row):
    """The index of the one record equal to `row`; fails if there is none."""
    hits = np.nonzero((records.reshape(len(records), -1)
                       == row.reshape(1, -1)).all(axis=1))[0]
    assert len(hits) >= 1, "a batch row that is no record of its store"
    return int(hits[0])


def test_unequal_counts_jax_raises_port_trains(unequal_stores):
    store_dir, records = unequal_stores
    assert [len(records[k]) for k in ("poses", "textures", "backgrounds")] == [40, 5, 7]
    assert len({r.tobytes() for r in records["textures"]}) == 5
    assert len({r.tobytes() for r in records["backgrounds"]}) == 7
    with pytest.raises(AssertionError, match="record dim"):
        jnl.NativeTrainLoader(store_dir, batch_size=4)

    B = 4
    loader = tnl.NativeTrainLoader(store_dir, batch_size=B, n_threads=2, seed=5)
    try:
        assert len(loader) == 40 // B
        pairs = set()
        n_batches = 0
        while n_batches < 50:
            for batch in loader:
                n_batches += 1
                assert batch["pose"].shape == (B, 72)
                assert batch["texture"].shape == (B, 7829, 3)
                assert batch["background"].shape == (B, 3, 16, 16)
                for i in range(B):
                    p = record_index(records["poses"], batch["pose"][i])
                    t = record_index(records["textures"], batch["texture"][i])
                    record_index(records["backgrounds"], batch["background"][i])
                    pairs.add((p, t))
        textures_per_pose = {}
        for p, t in pairs:
            textures_per_pose.setdefault(p, set()).add(t)
        assert n_batches == 50
        # With r % 5 for the textures, pose p would always get texture p % 5.
        assert max(len(ts) for ts in textures_per_pose.values()) > 1
        assert len({t for _, t in pairs}) == 5
    finally:
        loader.close()


@pytest.mark.parametrize("n_threads", [2, 8])
def test_sequential_mode_no_window_twice(tmp_path, n_threads):
    """Record r holds r: each batch must be one window k*B .. k*B + B - 1,
    and over 40 batches (windows repeat only after 250) no k twice; they
    come in order, batch k as window k. 8 threads against a queue of 4 is
    the stress case."""
    ids = np.arange(1000, dtype=np.float32)[:, None].repeat(3, axis=1)
    path = tnl.write_tensor_store(str(tmp_path / "ids.bin"), ids)
    B = 4
    sampler = tnl.NativeBatchSampler([path], B, n_threads=n_threads, seed=0,
                                     shuffle=False)
    try:
        windows = []
        for _ in range(40):
            (batch,) = sampler.next()
            first = int(batch[0, 0])
            assert first % B == 0
            np.testing.assert_array_equal(batch[:, 0], np.arange(first, first + B))
            windows.append(first // B)
        assert len(set(windows)) == len(windows), sorted(windows)
        assert windows == list(range(40))
    finally:
        sampler.close()


GOLDEN = 0x9E3779B97F4A7C15  # worker w's generator: seed + GOLDEN * (w + 1)


@pytest.mark.parametrize("n_threads", [2, 3, 8])
def test_batches_come_in_one_order(equal_stores, n_threads):
    """Of n workers, batch j is worker j % n's (j // n)-th batch, whatever
    the threads' speeds: the (j // n)-th batch of one thread seeded so that
    its worker's generator is that worker's. So two samplers of one seed and
    thread count hand out the same batches (as the ranks of a mesh need)."""
    paths, _ = equal_stores
    order = [paths["poses"], paths["backgrounds"], paths["textures"]]
    seed, n_batches = 11, 4 * n_threads
    many = tnl.NativeBatchSampler(order, 8, n_threads=n_threads, seed=seed)
    try:
        got = [many.next() for _ in range(n_batches)]
    finally:
        many.close()
    for w in range(n_threads):
        one = tnl.NativeBatchSampler(order, 8, n_threads=1,
                                     seed=(seed + GOLDEN * w) % 2 ** 64)
        try:
            for j in range(w, n_batches, n_threads):
                for a, b in zip(got[j], one.next()):
                    assert a.tobytes() == b.tobytes(), (w, j)
        finally:
            one.close()


def test_close_never_hangs(tmp_path):
    """2,000 samplers of 8 threads, closed just after a batch was taken (so
    threads woken to test for room are testing): every close returns. With
    stop set outside the lock, a thread that tested just before it and
    blocked just after the notify never woke, and this hung within the
    2,000."""
    import threading

    ids = np.arange(64, dtype=np.int64)[:, None]
    path = tnl.write_tensor_store(str(tmp_path / "ids.bin"), ids)

    def cycle():
        for _ in range(2000):
            sampler = tnl.NativeBatchSampler([path], 1, n_threads=8, shuffle=False)
            for _ in range(16):
                sampler.next()
            sampler.close()

    worker = threading.Thread(target=cycle, daemon=True)
    worker.start()
    worker.join(60)
    assert not worker.is_alive()


def test_native_train_loader_dict_batches(tmp_path):
    """The JAX test's dict batches (tests/test_native_loader.py): keys,
    dtypes and shapes, records row-aligned across equal-count fields."""
    n, wh = 20, 16
    rng = np.random.RandomState(0)
    poses = rng.randn(n, 72).astype(np.float32)
    textures = (rng.rand(n, 24, 16, 3) * 255).astype(np.uint8)
    bgs = (rng.rand(n, 3, wh, wh) * 255).astype(np.uint8)
    tnl.write_tensor_store(str(tmp_path / "poses.bin"), poses)
    tnl.write_tensor_store(str(tmp_path / "textures.bin"), textures)
    tnl.write_tensor_store(str(tmp_path / "backgrounds.bin"), bgs)

    loader = tnl.NativeTrainLoader(str(tmp_path), batch_size=4, seed=3)
    try:
        assert len(loader) == 5
        batches = list(loader)
        assert len(batches) == 5
        b = batches[0]
        assert set(b) == set(tnl.NativeTrainLoader.KEYS)
        assert b["pose"].shape == (4, 72) and b["pose"].dtype == np.float32
        assert b["texture"].shape == (4, 24, 16, 3) and b["texture"].dtype == np.uint8
        assert b["background"].shape == (4, 3, wh, wh) and b["background"].dtype == np.uint8
        i = int(np.argmin(np.abs(poses[:, 0] - b["pose"][0, 0])))
        np.testing.assert_array_equal(b["texture"][0], textures[i])
        np.testing.assert_array_equal(b["background"][0], bgs[i])
    finally:
        loader.close()


def test_failures_raise(tmp_path, monkeypatch):
    """A missing store raises from the sampler, and so does a source g++
    refuses; neither falls back to anything."""
    with pytest.raises(FileNotFoundError):
        tnl.NativeTrainLoader(str(tmp_path), batch_size=2)
    path = tnl.write_tensor_store(str(tmp_path / "a.bin"), np.zeros((4, 2), np.float32))
    os.remove(path)
    with pytest.raises(OSError, match="bs_add_store"):
        tnl.NativeBatchSampler([path], 2)

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnl, "SRC_PATH", str(bad))
    monkeypatch.setattr(tnl, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnl, "LIB_PATH", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnl.build_sampler()
    assert not (tmp_path / "build" / "lib.so").exists()


def test_port_builds_outside_the_jax_package():
    """The port's library lies under build/hp3d_torch_native/, and its
    source is the port's own."""
    lib = tnl.build_sampler()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert lib == os.path.join(repo, "build", "hp3d_torch_native",
                               "libbatch_sampler.so")
    assert os.path.exists(lib)
    assert "hierarchicalprobabilistic3dhuman_torch" in tnl.SRC_PATH
