"""The port's data-prep tools against the JAX package's on the CPU:
pack_training_stores.py (poses, textures per vertex and as full atlases,
backgrounds) writes .bin files and metadata byte-equal to JAX's on a small
npz and jpg folder, and copy_lsun_images_to_train_files_dir.py builds the
same file tree."""

import os

import cv2
import numpy as np
import pytest

from hierarchicalprobabilistic3dhuman_tpu.data import (
    copy_lsun_images_to_train_files_dir as jcopy, native_loader as jnl,
    pack_training_stores as jpack)

from hierarchicalprobabilistic3dhuman_torch.data import (
    copy_lsun_images_to_train_files_dir as tcopy, native_loader as tnl,
    pack_training_stores as tpack)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Poses and texture npz files and a folder of jpgs (and one png,
    which the packer skips), from a seed."""
    d = tmp_path_factory.mktemp("sources")
    rng = np.random.RandomState(4)
    np.savez(d / "poses.npz", fnames=np.array([f"h36m_{i}" for i in range(9)]),
             poses=rng.randn(9, 72))
    np.savez(d / "textures.npz",
             grey=(rng.rand(2, 120, 80, 3) * 255).astype(np.uint8),
             nongrey=(rng.rand(3, 120, 80, 3) * 255).astype(np.uint8))
    os.makedirs(d / "bgs")
    for i in range(4):
        img = (rng.rand(30 + 7 * i, 41, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(d / "bgs" / f"bg_{i}.jpg"), img)
    cv2.imwrite(str(d / "bgs" / "skipped.png"), np.zeros((8, 8, 3), np.uint8))
    return d


def pack_all(pack, src, out, per_vertex):
    os.makedirs(out)
    return [pack.pack_poses(str(src / "poses.npz"), str(out / "poses.bin")),
            pack.pack_textures(str(src / "textures.npz"), str(out / "textures.bin"),
                               per_vertex=per_vertex),
            pack.pack_backgrounds(str(src / "bgs"), str(out / "backgrounds.bin"),
                                  img_wh=24)]


@pytest.mark.parametrize("per_vertex", [True, False], ids=["per_vertex", "full_atlas"])
def test_pack_stores_byte_equal_jax(sources, tmp_path, per_vertex):
    jpaths = pack_all(jpack, sources, tmp_path / "jax", per_vertex)
    tpaths = pack_all(tpack, sources, tmp_path / "port", per_vertex)
    shapes = []
    for jp, tp in zip(jpaths, tpaths):
        assert os.path.basename(jp) == os.path.basename(tp)
        with open(jp, "rb") as f, open(tp, "rb") as g:
            assert f.read() == g.read(), os.path.basename(tp)
        assert jnl.read_store_meta(jp) == tnl.read_store_meta(tp)
        meta = np.load(tp + ".meta.npy", allow_pickle=True).item()
        assert meta == np.load(jp + ".meta.npy", allow_pickle=True).item()
        shapes.append(meta["shape"])
    texture_shape = (5, 7829, 3) if per_vertex else (5, 120, 80, 3)
    assert shapes == [(9, 72), texture_shape, (4, 3, 24, 24)]


def test_copy_lsun_images_same_tree(tmp_path):
    rng = np.random.RandomState(5)
    lsun = tmp_path / "lsun"
    for cat, n in (("bedroom", 60), ("kitchen", 3)):
        os.makedirs(lsun / cat)
        for i in range(n):
            ext = (".jpg", ".JPEG", ".webp")[i % 3]
            (lsun / cat / f"{i:04d}{ext}").write_bytes(rng.bytes(16))
        (lsun / cat / "notes.txt").write_text("not an image")
    (lsun / "README").write_text("a file, not a category")

    def tree(root):
        out = {}
        for dirpath, _, files in os.walk(root):
            for f in files:
                path = os.path.join(dirpath, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = fh.read()
        return out

    jcopy.copy_lsun_images(str(lsun), str(tmp_path / "jax"))
    tcopy.copy_lsun_images(str(lsun), str(tmp_path / "port"))
    jt, tt = tree(tmp_path / "jax"), tree(tmp_path / "port")
    assert jt == tt
    # 2% of 60 is one val image a category, and at least one for 3.
    assert sum(k.startswith(os.path.join("lsun_backgrounds", "val")) for k in tt) == 2
    assert len(tt) == 63
