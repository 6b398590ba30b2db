"""The port's batched folder predict vs the JAX package's, and vs the
port's own folder driver at batch 1.

The setup of tests/test_predict_driver.py::
test_batched_folder_predict_matches_per_image: a stub HRNet (one bright
heatmap pixel per joint), the predictor at embed width 64 with the JAX
weights carried across (models/weights.py), synthetic SMPL, proxy 32, 4
samples, batch 2, two resolution groups (three 128^2 photos, so a partial
chunk, and one 96^2). Tolerance: pose mode, shape mean and cam within 1e-5
of JAX's and of the port's at batch 1 (the uncertainty comes from other
draws in each, so only its shape and finiteness are held); pre-decoded
inputs give the PNG run's outputs exactly. Uncropped photos go through
the single-person keypoint detector on the centroid stub of
tests/test_torch_detector.py: its boxes within 1e-3 px of JAX's, and the
outputs within 1e-5.
"""

import os
import threading

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose2d_hrnet_cfg_defaults as j_hrnet_cfg,
    get_pose_shape_cfg_defaults as j_pose_shape_cfg)
from hierarchicalprobabilistic3dhuman_tpu.models.canny_edge_detector import (
    CannyEdgeDetector as JCanny)
from hierarchicalprobabilistic3dhuman_tpu.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as JPredictor)
from hierarchicalprobabilistic3dhuman_tpu.models.smpl import SMPL as JSMPL
from hierarchicalprobabilistic3dhuman_tpu.predict import keypoint_detector as jkd
from hierarchicalprobabilistic3dhuman_tpu.predict.predict_pose_mf_shape_gaussian_net import (
    predict_folder_batched as j_predict_folder_batched)

from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose2d_hrnet_cfg_defaults, get_pose_shape_cfg_defaults)
from hierarchicalprobabilistic3dhuman_torch.data.pack_predict_inputs import (
    pack_folder)
from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
    CannyEdgeDetector)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_predictor)
from hierarchicalprobabilistic3dhuman_torch.predict import keypoint_detector as tkd
from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
    predict_folder_batched)

from test_torch_detector import _blob, j_centroid_stub, t_centroid_stub

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

D, WH, N = 32, 64, 4
KEYS = ("pose_mode", "shape_mean", "cam", "per_vertex_uncertainty")
HM_W, HM_H = get_pose2d_hrnet_cfg_defaults().MODEL.HEATMAP_SIZE


def hrnet_stub(x):
    """One bright pixel per joint, as the JAX test's stub."""
    hm = torch.zeros((x.shape[0], 17, HM_H, HM_W))
    for j in range(17):
        hm[:, j, 10 + 2 * j, 5 + 3 * j] = 0.9
    return hm


def j_hrnet_stub(x):
    hm = jnp.zeros((x.shape[0], 17, HM_H, HM_W))
    for j in range(17):
        hm = hm.at[:, j, 10 + 2 * j, 5 + 3 * j].set(0.9)
    return hm


@pytest.fixture(scope="module")
def models():
    jmodel = JPredictor(embed_dim=64)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 18, D, D)))
    tmodel = PoseMFShapeGaussianNet(embed_dim=64).eval()
    tmodel.load_state_dict(flax_to_torch_predictor(
        jax.tree_util.tree_map(np.asarray, variables), tmodel))
    cfg = get_pose_shape_cfg_defaults()
    cfg.DATA.PROXY_REP_SIZE = D
    return {"jax": (jmodel, variables), "port": dict(
        pose_shape_model=tmodel, pose_shape_cfg=cfg,
        smpl_model=SMPL.synthetic(device="cpu"), hrnet=hrnet_stub,
        hrnet_cfg=get_pose2d_hrnet_cfg_defaults(),
        edge_detect_model=CannyEdgeDetector(device="cpu", threshold=0.0),
        device="cpu", visualise_wh=WH, num_uncertainty_samples=N)}


def _photos(directory, sizes, seed):
    directory.mkdir()
    rng = np.random.RandomState(seed)
    for name, (h, w) in sizes.items():
        cv2.imwrite(str(directory / name),
                    (rng.rand(h, w, 3) * 255).astype(np.uint8))
    return directory


@pytest.fixture(scope="module")
def folder_runs(models, tmp_path_factory):
    """JAX's and the port's batched --no_vis runs on one folder, and the
    port's run on it at batch 1 with figures."""
    root = tmp_path_factory.mktemp("batched")
    image_dir = _photos(root / "imgs", {"a0.png": (128, 128),
                                        "a1.png": (128, 128),
                                        "a2.png": (128, 128),
                                        "b0.png": (96, 96)}, seed=3)
    jmodel, variables = models["jax"]
    cfg = j_pose_shape_cfg()
    cfg.DATA.PROXY_REP_SIZE = D
    ref = j_predict_folder_batched(
        pose_shape_model_apply=jax.jit(lambda x: jmodel.apply(variables, x)),
        pose_shape_cfg=cfg, smpl_model=JSMPL.synthetic(),
        hrnet_apply=j_hrnet_stub, hrnet_cfg=j_hrnet_cfg(),
        edge_detect_model=JCanny(threshold=0.0), image_dir=str(image_dir),
        save_dir=str(root / "out_jax"), batch_size=2, visualise_wh=WH,
        save_vis=False, num_uncertainty_samples=N)
    port = predict_folder_batched(
        image_dir=str(image_dir), save_dir=str(root / "out_port"),
        batch_size=2, save_vis=False, **models["port"])
    per_image = predict_folder_batched(
        image_dir=str(image_dir), save_dir=str(root / "out_single"),
        batch_size=1, visualise_uncropped=False, **models["port"])
    return {"jax": ref, "port": port, "per_image": per_image, "root": root,
            "image_dir": image_dir}


@pytest.mark.parametrize("key", ["pose_mode", "shape_mean", "cam"])
def test_batched_matches_jax_and_per_image(folder_runs, key):
    port, ref, single = (folder_runs[k] for k in ("port", "jax", "per_image"))
    assert sorted(port) == sorted(ref) == sorted(single) == [
        "a0.png", "a1.png", "a2.png", "b0.png"]
    for fname in sorted(port):
        vs_jax = np.abs(port[fname][key] - np.asarray(ref[fname][key])).max()
        vs_single = np.abs(port[fname][key] - single[fname][key]).max()
        print(f"{fname} {key}: max abs diff vs JAX {vs_jax:.3e}, vs batch "
              f"1 {vs_single:.3e} (tol 1e-5)")
        assert vs_jax <= 1e-5 and vs_single <= 1e-5


def _recording(detect, boxes):
    """The detector, its boxes recorded per call."""
    def recorded(image):
        found = detect(image)
        boxes.append(np.asarray(found["boxes"]))
        return found
    return recorded


def test_batched_uncropped_photos_through_the_detector(models, tmp_path):
    """Uncropped photos, an off-centre blob in each, through the batched
    driver with the single-person keypoint detector, port vs JAX: two
    resolution groups at batch 2 (a full chunk and a partial one). The
    detector sees each photo as float [0, 1]: JAX's on the host, the
    port's where the chunk lives. The blobs sit off-centre at odd
    positions: the stub floors the brightness centroid to a heatmap cell,
    and a centroid on a cell's edge (a blob centred in its crop) would
    fall either side of it by the float order of the sums alone."""
    d = tmp_path / "scenes"
    d.mkdir()
    for name, (h, w, sy, sx) in {"p0.png": (256, 192, 117.3, 61.7),
                                 "p1.png": (256, 192, 141.9, 128.6),
                                 "q0.png": (192, 256, 88.4, 171.2)}.items():
        blob = _blob(h, w, sy, sx, 40.0, 20.0)
        cv2.imwrite(str(d / name), (np.stack([blob] * 3, -1) * 255).astype(np.uint8))
    jmodel, variables = models["jax"]
    cfg = j_pose_shape_cfg()
    cfg.DATA.PROXY_REP_SIZE = D
    jboxes, tboxes = [], []
    ref = j_predict_folder_batched(
        pose_shape_model_apply=jax.jit(lambda x: jmodel.apply(variables, x)),
        pose_shape_cfg=cfg, smpl_model=JSMPL.synthetic(),
        hrnet_apply=j_hrnet_stub, hrnet_cfg=j_hrnet_cfg(),
        edge_detect_model=JCanny(threshold=0.0), image_dir=str(d),
        save_dir=str(tmp_path / "out_jax"), batch_size=2, visualise_wh=WH,
        save_vis=False, num_uncertainty_samples=N,
        object_detect_fn=_recording(jkd.make_keypoint_bootstrap_detector(
            j_centroid_stub(), j_hrnet_cfg()), jboxes))
    port = predict_folder_batched(
        image_dir=str(d), save_dir=str(tmp_path / "out_port"), batch_size=2,
        save_vis=False, object_detect_fn=_recording(
            tkd.make_keypoint_bootstrap_detector(
                t_centroid_stub(), models["port"]["hrnet_cfg"], "cpu"), tboxes),
        **models["port"])
    assert len(tboxes) == len(jboxes) == 3
    for t, j in zip(tboxes, jboxes):
        assert t.shape == j.shape == (1, 4)
        box_diff = np.abs(t - j).max()
        print(f"box {t[0].tolist()}: max abs diff from JAX's {box_diff:.3e} px "
              "(tol 1e-3)")
        assert box_diff <= 1e-3
    assert sorted(port) == sorted(ref) == ["p0.png", "p1.png", "q0.png"]
    for fname in sorted(port):
        for key in ("pose_mode", "shape_mean", "cam"):
            diff = np.abs(port[fname][key] - np.asarray(ref[fname][key])).max()
            print(f"{fname} {key}: max abs diff vs JAX {diff:.3e} (tol 1e-5)")
            assert diff <= 1e-5


def test_outputs_npz_matches_jax(folder_runs):
    """outputs.npz: the same keys in the same order, the same file order,
    and the same rows as the returned results."""
    root = folder_runs["root"]
    port = np.load(root / "out_port" / "outputs.npz")
    ref = np.load(root / "out_jax" / "outputs.npz")
    assert port.files == ref.files == ["fnames", *KEYS]
    assert list(port["fnames"]) == list(ref["fnames"]) == sorted(folder_runs["port"])
    for i, fname in enumerate(port["fnames"]):
        for k in KEYS:
            np.testing.assert_array_equal(port[k][i], folder_runs["port"][fname][k])
        u = port["per_vertex_uncertainty"][i]
        assert u.shape == (6890,) and np.isfinite(u).all() and u.max() > 0
    assert port["pose_mode"].shape == ref["pose_mode"].shape == (4, 23, 3, 3)
    # --no_vis writes outputs.npz and no figure.
    assert sorted(os.listdir(root / "out_port")) == ["outputs.npz"]


def test_predecoded_inputs_match_pngs(models, tmp_path):
    """.npy files and .npz packs (pack_folder) give the PNG run's outputs."""
    rng = np.random.RandomState(8)
    imgs = {f"im{i}.png": (rng.rand(96, 96, 3) * 255).astype(np.uint8)
            for i in range(3)}
    png_dir, npy_dir = tmp_path / "png", tmp_path / "npy"
    png_dir.mkdir(), npy_dir.mkdir()
    for fname, rgb in imgs.items():
        cv2.imwrite(str(png_dir / fname), rgb[:, :, ::-1])   # BGR on disk
        np.save(str(npy_dir / (fname[:-4] + ".npy")), rgb)
    npz_dir = tmp_path / "npz"
    pack_folder(str(png_dir), str(npz_dir), shard_size=2)
    assert len(list(npz_dir.glob("*.npz"))) == 2
    outs = {name: predict_folder_batched(
        image_dir=str(d), save_dir=str(tmp_path / f"out_{name}"), batch_size=2,
        save_vis=False, **models["port"])
        for name, d in (("png", png_dir), ("npy", npy_dir), ("npz", npz_dir))}
    for name in ("npy", "npz"):
        assert sorted(outs[name]) == sorted(imgs)
        for fname in imgs:
            for k in ("pose_mode", "shape_mean", "cam"):
                np.testing.assert_array_equal(outs[name][fname][k],
                                              outs["png"][fname][k],
                                              err_msg=f"{name}/{fname}/{k}")


def test_npy_png_stem_collision_refused(tmp_path):
    d = tmp_path / "mix"
    d.mkdir()
    rgb = np.zeros((32, 32, 3), np.uint8)
    cv2.imwrite(str(d / "foo.png"), rgb)
    np.save(str(d / "foo.npy"), rgb)
    with pytest.raises(ValueError, match="collide"):
        predict_folder_batched(
            pose_shape_model=None, pose_shape_cfg=get_pose_shape_cfg_defaults(),
            smpl_model=None, hrnet=None,
            hrnet_cfg=get_pose2d_hrnet_cfg_defaults(), edge_detect_model=None,
            image_dir=str(d), save_dir=str(tmp_path / "out"), device="cpu")


def test_decode_error_reaches_the_caller(models, tmp_path):
    """A photo that does not decode fails the run with its name, from the
    decode thread, instead of leaving the caller waiting on a queue."""
    d = _photos(tmp_path / "imgs", {"good.png": (64, 64)}, seed=1)
    (d / "bad.png").write_bytes(b"not a png at all")
    failure = []

    def run():
        try:
            predict_folder_batched(image_dir=str(d),
                                   save_dir=str(tmp_path / "out"),
                                   batch_size=2, save_vis=False,
                                   **models["port"])
        except ValueError as e:
            failure.append(str(e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the batched driver hung on a bad photo"
    assert failure and "bad.png" in failure[0]


@pytest.mark.parametrize("batch_size", [1, 2])
def test_figures_on_writes_figure_and_uncrop(models, tmp_path, batch_size):
    """save_vis with visualise_uncropped and visualise_samples: the 2 x 4
    figure, the uncropped composite, of the photo's size, and the 3 x 6
    samples figure, for each photo."""
    d = _photos(tmp_path / "imgs", {"im0.png": (100, 90), "im1.png": (100, 90),
                                    "im2.png": (70, 80)}, seed=4)
    save_dir = tmp_path / "out"
    results = predict_folder_batched(
        image_dir=str(d), save_dir=str(save_dir), batch_size=batch_size,
        save_vis=True, visualise_uncropped=True, visualise_samples=True,
        **models["port"])
    assert sorted(results) == ["im0.png", "im1.png", "im2.png"]
    for fname, hw in (("im0", (100, 90)), ("im1", (100, 90)), ("im2", (70, 80))):
        fig = cv2.imread(str(save_dir / f"{fname}.png"))
        assert fig is not None and fig.shape == (2 * WH, 4 * WH, 3)
        assert (fig[:, 2 * WH:] > 0).mean() > 0.01      # the views hold a body
        unc = cv2.imread(str(save_dir / f"{fname}_uncrop.png"))
        photo = cv2.imread(str(d / f"{fname}.png"))
        assert unc is not None and unc.shape == hw + (3,)
        # the body is pasted over part of the photo, the rest is the photo
        same = (unc == photo).all(axis=-1).mean()
        assert 0.2 < same < 1.0, same
        samples = cv2.imread(str(save_dir / f"{fname}_samples.png"))
        assert samples is not None and samples.shape == (3 * WH, 6 * WH, 3)
