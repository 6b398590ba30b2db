"""The port's person detection vs the JAX package: both keypoint bootstrap
detectors, the centre-most box selection, the CLI on an uncropped photo,
and the bfloat16 HRNet.

The detectors run on the content-aware stubs of
tests/test_keypoint_detector.py (heatmap peaks at the brightness centroid
of whatever crop they are given), written once in JAX and once in torch,
on the same synthetic scenes. Tolerance: boxes within 1e-3 px, the same
number of boxes, the same empty result. The bfloat16 HRNet is held to the
bounds of tests/test_hrnet.py::test_bf16_inference_matches_f32 against the
port's float32 HRNet: heatmaps within 5% of the float32 maximum, and the
float32 value at bf16's argmax within 2% of it.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose2d_hrnet_cfg_defaults as j_hrnet_cfg)
from hierarchicalprobabilistic3dhuman_tpu.predict import keypoint_detector as jkd
from hierarchicalprobabilistic3dhuman_tpu.predict.predict_hrnet import (
    predict_hrnet as j_hrnet_single,
    select_centremost_person_box as j_select_box)

from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
    _make_detector, build_parser, build_predictor, main)
from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose2d_hrnet_cfg_defaults)
from hierarchicalprobabilistic3dhuman_torch.models.hrnet import (
    PoseHighResolutionNet)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet)
from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights
from hierarchicalprobabilistic3dhuman_torch.predict import keypoint_detector as tkd
from hierarchicalprobabilistic3dhuman_torch.predict.predict_hrnet import (
    make_hrnet_batch_predictor, select_centremost_person_box)
from hierarchicalprobabilistic3dhuman_torch.utils.precision import bf16_apply

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HRNET_CFG = get_pose2d_hrnet_cfg_defaults()
HM_W, HM_H = HRNET_CFG.MODEL.HEATMAP_SIZE


def j_centroid_stub(spread=4):
    """tests/test_keypoint_detector.py::_centroid_stub."""
    def stub(x):
        B, _, H, W = x.shape
        lum = x.sum(axis=1)
        lum = lum - lum.min(axis=(1, 2), keepdims=True)
        total = lum.sum(axis=(1, 2)) + 1e-6
        ys = (lum * jnp.arange(H)[None, :, None]).sum(axis=(1, 2)) / total
        xs = (lum * jnp.arange(W)[None, None, :]).sum(axis=(1, 2)) / total
        hm = jnp.zeros((B, 17, HM_H, HM_W))
        for j in range(17):
            dy, dx = (j // 3 - 2.5) * spread, (j % 3 - 1) * spread
            py = jnp.clip((ys / 4.0 + dy).astype(jnp.int32), 0, HM_H - 1)
            px = jnp.clip((xs / 4.0 + dx).astype(jnp.int32), 0, HM_W - 1)
            hm = hm.at[jnp.arange(B), j, py, px].set(0.9)
        return hm
    return stub


def t_centroid_stub(spread=4):
    """The same stub in torch."""
    def stub(x):
        B, _, H, W = x.shape
        lum = x.sum(dim=1)
        lum = lum - lum.amin(dim=(1, 2), keepdim=True)
        total = lum.sum(dim=(1, 2)) + 1e-6
        ys = (lum * torch.arange(H)[None, :, None]).sum(dim=(1, 2)) / total
        xs = (lum * torch.arange(W)[None, None, :]).sum(dim=(1, 2)) / total
        hm = torch.zeros((B, 17, HM_H, HM_W))
        for j in range(17):
            dy, dx = (j // 3 - 2.5) * spread, (j % 3 - 1) * spread
            py = torch.clamp((ys / 4.0 + dy).to(torch.int32), 0, HM_H - 1)
            px = torch.clamp((xs / 4.0 + dx).to(torch.int32), 0, HM_W - 1)
            hm[torch.arange(B), j, py, px] = 0.9
        return hm
    return stub


def _two_person_stub(xp):
    """tests/test_keypoint_detector.py::_two_person_stub, in JAX (xp=jnp)
    or torch (xp=torch): a peak per joint at the centroid of the red and of
    the blue channel's brightness, wherever that channel has contrast, in a
    cloud that scales with the blob's apparent size."""
    def amax(a):
        return a.max(axis=(1, 2)) if xp is jnp else a.amax(dim=(1, 2))

    def amin(a):
        return (a.min(axis=(1, 2), keepdims=True) if xp is jnp
                else a.amin(dim=(1, 2), keepdim=True))

    def total(a):
        return a.sum(axis=(1, 2)) if xp is jnp else a.sum(dim=(1, 2))

    def stub(x):
        B, _, H, W = x.shape
        hm = xp.zeros((B, 17, HM_H, HM_W))
        rows = xp.arange(H)[None, :, None]
        cols = xp.arange(W)[None, None, :]
        for ch in (0, 2):
            lum = x[:, ch]
            lum = lum - amin(lum)
            conf = xp.where(amax(lum) > 0.2, 0.9, 0.0)
            tot = total(lum) + 1e-6
            ys, xs = total(lum * rows) / tot, total(lum * cols) / tot
            sd_y = xp.sqrt(total(lum * (rows - ys[:, None, None]) ** 2) / tot) + 1.0
            sd_x = xp.sqrt(total(lum * (cols - xs[:, None, None]) ** 2) / tot) + 1.0
            for j in range(17):
                dy = (j // 3 - 2.5) / 2.5 * sd_y
                dx = (j % 3 - 1) * sd_x
                py, px = (ys + dy) / 4.0, (xs + dx) / 4.0
                if xp is jnp:
                    py = jnp.clip(py.astype(jnp.int32), 0, HM_H - 1)
                    px = jnp.clip(px.astype(jnp.int32), 0, HM_W - 1)
                    hm = hm.at[jnp.arange(B), j, py, px].max(conf)
                else:
                    py = torch.clamp(py.to(torch.int32), 0, HM_H - 1)
                    px = torch.clamp(px.to(torch.int32), 0, HM_W - 1)
                    b = torch.arange(B)
                    hm[b, j, py, px] = torch.maximum(hm[b, j, py, px], conf)
        return hm
    return stub


def _dead_stub(xp):
    return lambda x: xp.zeros((x.shape[0], 17, HM_H, HM_W))


def _blob(H, W, sy, sx, sig_y, sig_x):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.exp(-(((yy - sy) / sig_y) ** 2 + ((xx - sx) / sig_x) ** 2))


def _scene(name):
    if name == "blob":                 # one off-centre person
        return np.broadcast_to(_blob(512, 384, 240.0, 120.0, 80.0, 40.0),
                               (3, 512, 384)).astype(np.float32)
    if name == "block":                # a uniform bright block
        img = np.zeros((3, 400, 300), np.float32)
        img[:, 100:300, 80:220] = 1.0
        return img
    if name == "point":                # coincident keypoints: min-extent box
        return np.ones((3, 256, 256), np.float32)
    if name == "two":                  # two people, red and blue
        img = np.zeros((3, 512, 384), np.float32)
        img[0] = _blob(512, 384, 200.0, 100.0, 60.0, 35.0)
        img[2] = _blob(512, 384, 300.0, 280.0, 60.0, 35.0)
        return img
    if name == "one_red":              # one person for the multi detector
        img = np.zeros((3, 512, 384), np.float32)
        img[0] = _blob(512, 384, 240.0, 120.0, 80.0, 40.0)
        return img
    return np.zeros((3, 256, 256), np.float32)           # empty


def _point_stub(xp):
    def stub(x):
        if xp is jnp:
            return jnp.zeros((x.shape[0], 17, HM_H, HM_W)).at[
                :, :, HM_H // 2, HM_W // 2].set(0.9)
        hm = torch.zeros((x.shape[0], 17, HM_H, HM_W))
        hm[:, :, HM_H // 2, HM_W // 2] = 0.9
        return hm
    return stub


def _compare(name, port, ref, expect_boxes):
    print(f"{name}: port boxes {port['boxes'].tolist()}, JAX boxes "
          f"{np.asarray(ref['boxes']).tolist()}")
    assert port["boxes"].shape == np.asarray(ref["boxes"]).shape
    assert port["boxes"].shape[0] == expect_boxes
    if expect_boxes:
        diff = np.abs(port["boxes"] - np.asarray(ref["boxes"])).max()
        print(f"{name}: max abs box diff {diff:.3e} px (tol 1e-3)")
        assert diff <= 1e-3
        for k in ("labels", "scores", "kp_mean_conf"):
            np.testing.assert_allclose(port[k], np.asarray(ref[k]), atol=1e-6)


@pytest.mark.parametrize("scene,stubs,expect", [
    ("blob", "centroid", 1), ("block", "centroid", 1), ("point", "point", 1),
    ("empty", "dead", 0)])
def test_single_person_detector_matches(scene, stubs, expect):
    j_stub, t_stub = {"centroid": (j_centroid_stub(), t_centroid_stub()),
                      "point": (_point_stub(jnp), _point_stub(torch)),
                      "dead": (_dead_stub(jnp), _dead_stub(torch))}[stubs]
    img = _scene(scene)
    ref = jkd.make_keypoint_bootstrap_detector(j_stub, j_hrnet_cfg())(
        jnp.asarray(img))
    port = tkd.make_keypoint_bootstrap_detector(t_stub, HRNET_CFG, "cpu")(
        torch.from_numpy(img))
    _compare(f"single {scene}", port, ref, expect)


@pytest.mark.parametrize("scene,stub,expect", [
    ("two", "two", 2), ("one_red", "two", 1), ("empty", "dead", 0)])
def test_multi_person_detector_matches(scene, stub, expect):
    make = {"two": _two_person_stub, "dead": _dead_stub}[stub]
    img = _scene(scene)
    ref = jkd.make_multi_person_bootstrap_detector(
        make(jnp), j_hrnet_cfg(), max_people=4)(jnp.asarray(img))
    port = tkd.make_multi_person_bootstrap_detector(
        make(torch), HRNET_CFG, "cpu", max_people=4)(img)   # numpy input
    _compare(f"multi {scene}", port, ref, expect)


def test_cluster_peaks_and_iou_match():
    rng = np.random.RandomState(6)
    kp = (rng.rand(17, 4, 2) * 300).astype(np.float32)
    confs = rng.rand(17, 4).astype(np.float32)
    confs[2, 1] = confs[5, 0]                        # equal confidences
    port = tkd._cluster_peaks(kp, confs, 0.3, radius=60.0)
    ref = jkd._cluster_peaks(kp, confs, 0.3, radius=60.0)
    assert len(port) == len(ref) > 1
    for p, r in zip(port, ref):
        assert p["chan"] == r["chan"]
        np.testing.assert_array_equal(p["pts"], r["pts"])
    a, b = (10.0, 20.0, 110.0, 220.0), (50.0, 0.0, 150.0, 100.0)
    assert tkd._iou_xyxy(a, b) == jkd._iou_xyxy(a, b) > 0
    assert tkd._effective_threshold(confs, 0.3, 0.1, 0.35) == \
        jkd._effective_threshold(confs, 0.3, 0.1, 0.35)


@pytest.mark.parametrize("case", ["several", "filtered", "empty", "none"])
def test_select_centremost_person_box_matches(case):
    dets = {"boxes": np.array([[10, 20, 110, 220], [150, 100, 250, 300],
                               [140, 90, 260, 290], [0, 0, 50, 50]], np.float32),
            "labels": np.array([1, 1, 2, 1]),
            "scores": np.array([0.9, 0.95, 0.99, 0.5], np.float32)}
    if case == "filtered":
        dets["scores"][:] = 0.5
    elif case == "empty":
        dets = {k: v[:0] for k, v in dets.items()}
    elif case == "none":
        dets = None
    port = select_centremost_person_box(dets, (400, 300), threshold=0.8)
    ref = j_select_box(dets, (400, 300), threshold=0.8)
    print(f"{case}: port {port}, JAX {ref}")
    np.testing.assert_allclose(port[0], np.asarray(ref[0]), atol=0)
    assert port[1:] == ref[1:]


def test_predict_hrnet_matches_jax():
    """make_hrnet_batch_predictor on a batch of one uncropped scene, its box
    from the single-person detector: the box exactly, joints and
    confidences exactly, the crop within 1e-5, against JAX's predict_hrnet
    with the same stubs."""
    img = _scene("blob")
    ref = j_hrnet_single(
        j_centroid_stub(spread=2), j_hrnet_cfg(), jnp.asarray(img),
        object_detect_fn=jkd.make_keypoint_bootstrap_detector(
            j_centroid_stub(), j_hrnet_cfg()))
    port = make_hrnet_batch_predictor(t_centroid_stub(spread=2), HRNET_CFG, "cpu")(
        torch.from_numpy(img)[None],
        object_detect_fn=tkd.make_keypoint_bootstrap_detector(
            t_centroid_stub(), HRNET_CFG, "cpu"))
    centre, height, width = (port["bbox_centres"][0],
                             float(port["bbox_heights"][0]),
                             float(port["bbox_widths"][0]))
    crop_diff = np.abs(port["cropped_image"][0].numpy()
                       - np.asarray(ref["cropped_image"])).max()
    print(f"predict_hrnet: box {centre.tolist()} {height} x {width} (JAX "
          f"{np.asarray(ref['bbox_centre']).tolist()} {ref['bbox_height']} x "
          f"{ref['bbox_width']}); crop max abs diff {crop_diff:.3e} (tol 1e-5)")
    # The detector found the blob: a box smaller than the 512 x 384 frame.
    assert height < 512 and width < 384
    np.testing.assert_array_equal(centre, np.asarray(ref["bbox_centre"]))
    assert (height, width) == (ref["bbox_height"], ref["bbox_width"])
    np.testing.assert_array_equal(port["joints2D"][0].numpy(),
                                  np.asarray(ref["joints2D"]))
    np.testing.assert_array_equal(port["joints2Dconfs"][0].numpy(),
                                  np.asarray(ref["joints2Dconfs"]))
    assert port["cropped_image"].shape == (1, 3, 384, 288) and crop_diff <= 1e-5


def test_cli_detector_choices(capsys, tmp_path, monkeypatch):
    """auto takes the keypoint bootstrap with JAX's NOTE; maskrcnn is
    refused with a clear error; cropped photos and 'none' take no detector;
    reference checkpoints load and a predictor checkpoint selects the
    LAPACK-sign SVD; --num_devices > 1 goes to the ranks' launcher with
    every rank on the "sample" axis (JAX's cli/predict.py:194-202), never
    ignored."""
    def args(*extra):
        return build_parser().parse_args(["-I", "x", "-S", "y", *extra])

    stub = t_centroid_stub()
    assert callable(_make_detector(args(), stub, HRNET_CFG, "cpu"))
    assert "keypoint-bootstrap detector" in capsys.readouterr().out
    assert callable(_make_detector(args("--detector", "keypoint-multi"), stub,
                                   HRNET_CFG, "cpu"))
    assert _make_detector(args("--detector", "none"), stub, HRNET_CFG, "cpu") is None
    assert _make_detector(args("-C"), stub, HRNET_CFG, "cpu") is None
    with pytest.raises(RuntimeError, match="Mask-RCNN"):
        _make_detector(args("--detector", "maskrcnn"), stub, HRNET_CFG, "cpu")
    # Reference-layout checkpoints of random weights, as build_predictor
    # reads them, with numpy scalars beside the state dicts.
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("DATA:\n  PROXY_REP_SIZE: 64\n")
    predictor = init_weights(PoseMFShapeGaussianNet(),
                             torch.Generator().manual_seed(11))
    hrnet = init_weights(PoseHighResolutionNet(), torch.Generator().manual_seed(12))
    w3d, w2d = str(tmp_path / "w.tar"), str(tmp_path / "w.pth")
    torch.save({"best_model_state_dict": predictor.state_dict(),
                "epoch": np.int64(3)}, w3d)
    torch.save({"state_dict": hrnet.state_dict(),
                "best_val": np.float64(0.5)}, w2d)
    for extra, svd_impl, loaded in (
            (["--pose_shape_weights", w3d], "lapack", "pose_shape_model"),
            (["--pose2D_hrnet_weights", w2d], "jacobi", "hrnet"),
            (["--svd_impl", "lapack"], "lapack", None)):
        built = build_predictor(args("--device", "cpu", "-C", "--pose_shape_cfg",
                                     str(cfg), *extra))
        assert built["pose_shape_model"].svd_impl == svd_impl
        if loaded:
            source = predictor if loaded == "pose_shape_model" else hrnet
            got = built[loaded].state_dict()
            assert all(torch.equal(got[k], v) for k, v in
                       source.state_dict().items()), extra
    from hierarchicalprobabilistic3dhuman_torch.parallel import launch
    launched = []
    monkeypatch.setattr(launch, "launch", lambda run, a, sample_parallel: (
        launched.append((a.num_devices, sample_parallel))))
    main(["-I", "x", "-S", "y", "--device", "cpu", "--num_devices", "2"])
    assert launched == [(2, 2)]


def test_cli_on_an_uncropped_photo(tmp_path):
    """run_predict_torch.py --detector keypoint --device cpu on a demo photo
    pasted into a larger canvas, at small sizes, with both figures."""
    image_dir = tmp_path / "imgs"
    image_dir.mkdir()
    photo = cv2.imread(os.path.join(REPO, "demo", "00007.png"))
    canvas = np.full((photo.shape[0] + 120, photo.shape[1] + 200, 3), 40,
                     np.uint8)
    canvas[100:100 + photo.shape[0], 30:30 + photo.shape[1]] = photo
    canvas = cv2.resize(canvas, None, fx=0.25, fy=0.25)
    cv2.imwrite(str(image_dir / "scene.png"), canvas)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("DATA:\n  PROXY_REP_SIZE: 64\n")
    save_dir = tmp_path / "out"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "run_predict_torch.py"),
         "--image_dir", str(image_dir), "--save_dir", str(save_dir),
         "--detector", "keypoint", "--device", "cpu", "--visualise_wh", "64",
         "--num_uncertainty_samples", "4", "--pose_shape_cfg", str(cfg),
         "--visualise_uncropped", "--visualise_samples"],
        cwd=str(tmp_path), timeout=300, capture_output=True, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stdout + out.stderr
    fig = cv2.imread(str(save_dir / "scene.png"))
    assert fig is not None and fig.shape == (128, 256, 3)
    unc = cv2.imread(str(save_dir / "scene_uncrop.png"))
    assert unc is not None and unc.shape == canvas.shape
    samples = cv2.imread(str(save_dir / "scene_samples.png"))
    assert samples is not None and samples.shape == (3 * 64, 6 * 64, 3)


def test_bf16_hrnet_matches_float32():
    hrnet = init_weights(PoseHighResolutionNet(),
                         torch.Generator().manual_seed(1)).eval()
    x = torch.from_numpy(np.random.RandomState(33).rand(2, 3, 128, 96)
                         .astype(np.float32))
    with torch.inference_mode():
        out_f32 = hrnet(x).numpy()
        out_bf16 = bf16_apply(hrnet)(x)
    assert out_bf16.dtype == torch.float32
    assert next(hrnet.parameters()).dtype == torch.float32   # original kept
    out_bf16 = out_bf16.numpy()
    assert out_bf16.shape == out_f32.shape == (2, 17, 32, 24)
    scale = np.abs(out_f32).max()
    diff = np.abs(out_bf16 - out_f32).max()
    flat = out_f32.reshape(2, 17, -1)
    arg = out_bf16.reshape(2, 17, -1).argmax(-1)
    peak_gap = np.abs(flat.max(-1)
                      - np.take_along_axis(flat, arg[..., None], -1)[..., 0]).max()
    print(f"bf16 HRNet: max abs diff {diff:.3e} = {diff / scale:.4f} of the "
          f"float32 max (tol 0.05); peak gap {peak_gap / scale:.4f} (tol 0.02)")
    assert diff < 0.05 * scale and peak_gap < 0.02 * scale
