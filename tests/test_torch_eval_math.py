"""The evaluation slice's modules vs the JAX package, one by one.

SMPL from an official-layout .pkl (a scipy-sparse J_regressor and chumpy
objects, unpickled without chumpy) against the JAX SMPL on the same file,
vertices within 1e-6, and .npz preferred where both exist; the mixed-gender
forward within 1e-5; the Gaussian shape sampler on JAX's draws, exact;
Procrustes and the scale-translation alignment within 1e-5; the per-frame
metrics within 1e-4 relative; EvalMetricsTracker on the same per-frame
inputs within 1e-6; and items of both evaluation datasets on synthetic
folders in their layouts: images exact, heatmaps within 1e-6.
"""

import os
import pickle
import sys
import types

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse
import torch

from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose_shape_cfg_defaults as j_cfg)
from hierarchicalprobabilistic3dhuman_tpu.data.pw3d_eval_dataset import (
    PW3DEvalDataset as JPW3D)
from hierarchicalprobabilistic3dhuman_tpu.data.ssp3d_eval_dataset import (
    SSP3DEvalDataset as JSSP3D)
from hierarchicalprobabilistic3dhuman_tpu.metrics.eval_metrics_tracker import (
    EvalMetricsTracker as JTracker)
from hierarchicalprobabilistic3dhuman_tpu.metrics.metric_sums import (
    make_eval_frame_metrics_fn as j_frame_metrics_fn)
from hierarchicalprobabilistic3dhuman_tpu.models.smpl import (
    SMPL as JSMPL, smpl_forward_mixed as j_forward_mixed)
from hierarchicalprobabilistic3dhuman_tpu.ops.bingham_sampling import (
    shape_gaussian_sampling as j_shape_sampling)
from hierarchicalprobabilistic3dhuman_tpu.utils.eval_utils import (
    procrustes_analysis_batch as j_procrustes,
    scale_and_translation_transform_batch as j_scale_translate)

import chip_smoke
from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults as t_cfg)
from hierarchicalprobabilistic3dhuman_torch.data.pw3d_eval_dataset import (
    PW3DEvalDataset as TPW3D)
from hierarchicalprobabilistic3dhuman_torch.data.ssp3d_eval_dataset import (
    SSP3DEvalDataset as TSSP3D)
from hierarchicalprobabilistic3dhuman_torch.metrics import (
    EvalMetricsTracker as TTracker)
from hierarchicalprobabilistic3dhuman_torch.metrics.metric_sums import (
    make_eval_frame_metrics_fn as t_frame_metrics_fn)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import (
    SMPL as TSMPL, convert_smpl_pkl_to_npz, smpl_forward_mixed as t_forward_mixed,
    synthetic_smpl_params)
from hierarchicalprobabilistic3dhuman_torch.ops.bingham_sampling import (
    shape_gaussian_sampling as t_shape_sampling)
from hierarchicalprobabilistic3dhuman_torch.utils.eval_utils import (
    procrustes_analysis_batch as t_procrustes,
    scale_and_translation_transform_batch as t_scale_translate)

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL_METRICS = ["PVE", "PVE-SC", "PVE-PA", "PVE-T-SC", "MPJPE", "MPJPE-PA",
                "joints2D-L2E", "silhouette-IOU", "PVE_samples_min",
                "PVE-PA_samples_min", "MPJPE-SC_samples_min",
                "joints2Dsamples-L2E", "silhouettesamples-IOU"]


class _Ch:
    """Pickles as chumpy.ch.Ch, holding its array in `x` (the official
    SMPL .pkl files are pickled chumpy objects)."""

    def __init__(self, x):
        self.x = x


def _write_smpl_pkl(path, arrays, monkeypatch):
    """An official-layout SMPL pkl from the port's synthetic arrays: native
    posedirs (V, 3, 207), a sparse J_regressor, chumpy-wrapped arrays."""
    chumpy, chumpy_ch = types.ModuleType("chumpy"), types.ModuleType("chumpy.ch")
    _Ch.__module__, _Ch.__qualname__ = "chumpy.ch", "Ch"
    chumpy_ch.Ch = _Ch
    monkeypatch.setitem(sys.modules, "chumpy", chumpy)
    monkeypatch.setitem(sys.modules, "chumpy.ch", chumpy_ch)
    V = arrays["v_template"].shape[0]
    data = {
        "v_template": _Ch(arrays["v_template"].astype(np.float64)),
        "shapedirs": _Ch(arrays["shapedirs"].astype(np.float64)),
        "posedirs": arrays["posedirs"].T.reshape(V, 3, 207).astype(np.float64),
        "J_regressor": scipy.sparse.csc_matrix(arrays["J_regressor"].astype(np.float64)),
        "weights": _Ch(arrays["lbs_weights"].astype(np.float64)),
        "f": arrays["faces"].astype(np.uint32),
        "kintree_table": np.stack([np.arange(24) - 1, np.arange(24)]),
    }
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)
    monkeypatch.delitem(sys.modules, "chumpy.ch")
    monkeypatch.delitem(sys.modules, "chumpy")


@pytest.fixture(scope="module")
def pose_inputs():
    rng = np.random.RandomState(9)
    return (rng.randn(3, 10).astype(np.float32),
            (rng.randn(3, 69) * 0.3).astype(np.float32),
            (rng.randn(3, 3) * 0.3).astype(np.float32))


def test_smpl_from_pkl_matches_jax(tmp_path, monkeypatch, pose_inputs):
    _write_smpl_pkl(tmp_path / "SMPL_NEUTRAL.pkl", synthetic_smpl_params(seed=3),
                    monkeypatch)
    assert "chumpy" not in sys.modules
    port = TSMPL.from_files("cpu", gender="neutral", model_path=str(tmp_path))
    ref = JSMPL(model_path=str(tmp_path), gender="neutral")
    betas, body, glob = pose_inputs
    out = port(betas=torch.from_numpy(betas), body_pose=torch.from_numpy(body),
               global_orient=torch.from_numpy(glob))
    jout = ref(betas=jnp.asarray(betas), body_pose=jnp.asarray(body),
               global_orient=jnp.asarray(glob))
    for k in ("vertices", "joints"):
        err = np.abs(out[k].numpy() - np.asarray(jout[k])).max()
        print(f"SMPL from .pkl, {k}: max abs diff from JAX {err:.2e} (tol 1e-6)")
        assert err <= 1e-6, k

    # Both files: the .npz is read (here, with its template moved by 1 m).
    convert_smpl_pkl_to_npz(str(tmp_path / "SMPL_NEUTRAL.pkl"),
                            str(tmp_path / "SMPL_NEUTRAL.npz"))
    npz = dict(np.load(tmp_path / "SMPL_NEUTRAL.npz"))
    npz["v_template"] = npz["v_template"] + 1.0
    np.savez(tmp_path / "SMPL_NEUTRAL.npz", **npz)
    moved = TSMPL.from_files("cpu", gender="neutral", model_path=str(tmp_path))
    jmoved = JSMPL(model_path=str(tmp_path), gender="neutral")
    np.testing.assert_allclose(moved.params.v_template.numpy(),
                               port.params.v_template.numpy() + 1.0, atol=1e-6)
    np.testing.assert_array_equal(moved.params.v_template.numpy(),
                                  np.asarray(jmoved.params.v_template))
    with pytest.raises(FileNotFoundError, match="npz|pkl"):
        TSMPL.from_files("cpu", gender="male", model_path=str(tmp_path))


def test_smpl_forward_mixed_matches_jax(pose_inputs):
    models = [synthetic_smpl_params(seed=s) for s in (0, 1, 2)]
    tparams = [TSMPL.synthetic("cpu", seed=s).params for s in (0, 1, 2)]
    jparams = [JSMPL.synthetic(seed=s).params for s in (0, 1, 2)]
    assert np.array_equal(models[1]["v_template"], np.asarray(jparams[1].v_template))
    betas, body, glob = pose_inputs
    codes = np.array([2, 0, 1], np.int32)
    rotmats = dict(body_pose=body, global_orient=glob)
    for pose2rot, kwargs in ((True, rotmats), (False, {})):
        out = t_forward_mixed(tparams, torch.from_numpy(codes),
                              betas=torch.from_numpy(betas), pose2rot=pose2rot,
                              **{k: torch.from_numpy(v) for k, v in kwargs.items()})
        jout = j_forward_mixed(jparams, jnp.asarray(codes), betas=jnp.asarray(betas),
                               pose2rot=pose2rot,
                               **{k: jnp.asarray(v) for k, v in kwargs.items()})
        for k in ("vertices", "joints"):
            err = np.abs(out[k].numpy() - np.asarray(jout[k])).max()
            print(f"smpl_forward_mixed {sorted(kwargs)}, {k}: max abs diff "
                  f"{err:.2e} (tol 1e-5)")
            assert err <= 1e-5, k
    # Row b equals the forward of its own gender's model.
    single = TSMPL(tparams[2])(betas=torch.from_numpy(betas[:1]),
                               body_pose=torch.from_numpy(body[:1]),
                               global_orient=torch.from_numpy(glob[:1]))
    mixed = t_forward_mixed(tparams, torch.from_numpy(codes),
                            betas=torch.from_numpy(betas),
                            body_pose=torch.from_numpy(body),
                            global_orient=torch.from_numpy(glob))
    np.testing.assert_allclose(mixed["vertices"][0].numpy(),
                               single["vertices"][0].numpy(), atol=1e-5)


def test_shape_gaussian_sampling_on_jax_draws():
    rng = np.random.RandomState(2)
    mean = rng.randn(3, 10).astype(np.float32)
    std = np.exp(rng.randn(3, 10) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(j_shape_sampling(key, jnp.asarray(mean), jnp.asarray(std), 5))
    eps = jax.random.normal(key, (3, 5, 10), dtype=jnp.float32)
    port = t_shape_sampling(torch.from_numpy(mean), torch.from_numpy(std), 5,
                            eps=torch.from_numpy(np.array(eps))).numpy()
    print(f"shape_gaussian_sampling: max abs diff {np.abs(port - ref).max():.2e} (tol 0)")
    np.testing.assert_array_equal(port, ref)
    drawn = t_shape_sampling(torch.from_numpy(mean), torch.from_numpy(std), 5,
                             generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 5, 10)


@pytest.mark.parametrize("points", [14, 6890])
def test_alignments_match_jax(points):
    rng = np.random.RandomState(points)
    S2 = rng.randn(4, points, 3).astype(np.float32)
    R = np.linalg.qr(rng.randn(4, 3, 3))[0]
    S1 = (1.3 * np.einsum("bij,bnj->bni", R, S2) + rng.randn(4, 1, 3)
          + rng.randn(4, points, 3) * 0.05).astype(np.float32)
    for name, t_fn, j_fn in (("procrustes", t_procrustes, j_procrustes),
                             ("scale+translation", t_scale_translate,
                              j_scale_translate)):
        port = t_fn(torch.from_numpy(S1), torch.from_numpy(S2)).numpy()
        ref = np.asarray(j_fn(jnp.asarray(S1), jnp.asarray(S2)))
        err = np.abs(port - ref).max()
        print(f"{name} on {points} points: max abs diff {err:.2e} (tol 1e-5)")
        assert err <= 1e-5, name
    # Procrustes recovers the similarity transform up to the noise.
    assert np.abs(t_procrustes(torch.from_numpy(S1), torch.from_numpy(S2)).numpy()
                  - S2).mean() < 0.1


def _frame_inputs(B=3, N=4, P=6890, wh=16, seed=0):
    """Per-frame predictions and targets as the eval step hands them over."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    target = {"verts": rng.randn(B, P, 3).astype(f32),
              "reposed_verts": rng.randn(B, P, 3).astype(f32),
              "joints3D": rng.randn(B, 14, 3).astype(f32),
              "joints2D": (rng.rand(B, 17, 2) * wh).astype(f32),
              "silhouettes": (rng.rand(B, wh, wh) > 0.5).astype(f32)}
    pred = {k: (v + rng.randn(*v.shape) * 0.1).astype(f32)
            for k, v in target.items() if k in ("verts", "reposed_verts",
                                                "joints3D", "joints2D")}
    pred["silhouettes"] = (rng.rand(B, wh, wh) > 0.5).astype(f32)
    pred["verts_samples"] = (target["verts"][:, None]
                             + rng.randn(B, N, P, 3) * 0.1).astype(f32)
    pred["reposed_verts_samples"] = (target["reposed_verts"][:, None]
                                     + rng.randn(B, N, P, 3) * 0.1).astype(f32)
    pred["joints3D_samples"] = (target["joints3D"][:, None]
                                + rng.randn(B, N, 14, 3) * 0.1).astype(f32)
    pred["joints2Dsamples"] = (target["joints2D"][:, None]
                               + rng.randn(B, N, 17, 2)).astype(f32)
    pred["silhouettessamples"] = (rng.rand(B, N, wh, wh) > 0.5).astype(f32)
    return pred, target


def test_frame_metrics_match_jax():
    pred, target = _frame_inputs()
    port = t_frame_metrics_fn(FULL_METRICS)(
        {k: torch.from_numpy(v) for k, v in pred.items()},
        {k: torch.from_numpy(v) for k, v in target.items()})
    ref = jax.jit(j_frame_metrics_fn(FULL_METRICS))(
        {k: jnp.asarray(v) for k, v in pred.items()},
        {k: jnp.asarray(v) for k, v in target.items()})
    assert set(port) == set(ref)
    for k in sorted(ref):
        a, b = port[k].numpy(), np.asarray(ref[k])
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        print(f"frame metric {k}: max rel diff {rel:.2e} (tol 1e-4)")
        assert a.shape == b.shape and rel <= 1e-4, k


def test_tracker_matches_jax(tmp_path):
    """Both update paths over two batches, the final metrics and the
    per-frame files (restored to a given frame order)."""
    batches = [_frame_inputs(seed=s) for s in (1, 2)]
    order = np.array([3, 0, 5, 1, 4, 2])
    finals = {}
    for side, Tracker, frame_fn, wrap in (
            ("port", TTracker, t_frame_metrics_fn(FULL_METRICS), torch.from_numpy),
            ("jax", JTracker, jax.jit(j_frame_metrics_fn(FULL_METRICS)), jnp.asarray)):
        for path in ("host", "device"):
            save = tmp_path / f"{side}_{path}"
            save.mkdir()
            tracker = Tracker(FULL_METRICS, img_wh=16, save_path=str(save),
                              save_per_frame_metrics=True)
            tracker.initialise_metric_sums()
            tracker.initialise_per_frame_metric_lists()
            for pred, target in batches:
                if path == "host":
                    tracker.update_per_batch(pred, target, 3)
                else:
                    fm = frame_fn({k: wrap(v) for k, v in pred.items()},
                                  {k: wrap(v) for k, v in target.items()})
                    tracker.update_per_batch_device(
                        {k: np.asarray(v) for k, v in fm.items()}, 3)
            finals[side, path] = tracker.compute_final_metrics(frame_order=order)
    for path in ("host", "device"):
        for k, ref in finals["jax", path].items():
            port = finals["port", path][k]
            print(f"tracker ({path} path) {k}: port {port:.8f}, JAX {ref:.8f}")
            assert abs(port - ref) <= 1e-6 * max(abs(ref), 1.0), (path, k)
        for m in FULL_METRICS:
            if "samples" in m:
                continue
            a = np.load(tmp_path / f"port_{path}" / f"{m}_per_frame.npy")
            b = np.load(tmp_path / f"jax_{path}" / f"{m}_per_frame.npy")
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=m)


def _demo_images(n, wh):
    demo = sorted(f for f in os.listdir(os.path.join(REPO, "demo"))
                  if f.endswith(".png"))
    images = []
    for f in demo:
        rgb = cv2.cvtColor(cv2.imread(os.path.join(REPO, "demo", f)),
                           cv2.COLOR_BGR2RGB)
        if rgb.shape[:2] == (512, 512):
            images.append(cv2.resize(rgb, (wh, wh)))
    return images[:n]


@pytest.mark.parametrize("dataset", ["ssp3d", "3dpw"])
def test_dataset_items_match_jax(tmp_path, dataset):
    images = _demo_images(4, 96)
    jcfg, tcfg = j_cfg(), t_cfg()
    jcfg.DATA.PROXY_REP_SIZE = tcfg.DATA.PROXY_REP_SIZE = 64
    if dataset == "ssp3d":
        root = chip_smoke.write_ssp3d_folder(str(tmp_path / "ssp"), images, seed=1)
        port, ref = TSSP3D(root, tcfg, 0.6), JSSP3D(root, jcfg, 0.6)
    else:
        root = chip_smoke.write_3dpw_folder(str(tmp_path / "pw"), images, seed=2)
        port, ref = TPW3D(root, tcfg, 0.6), JPW3D(root, jcfg, 0.6)
    assert len(port) == len(ref) == 4
    for i in range(4):
        a, b = port[i], ref[i]
        # The port's 3DPW items add the keypoints (joints2D-L2E's ground
        # truth), the coordinates the heatmaps are built from.
        assert set(a) - set(b) == ({"keypoints"} if dataset == "3dpw" else set())
        for k in ("image", "silhouette", "keypoints", "pose", "shape"):
            if k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        hm = np.abs(a["heatmaps"] - b["heatmaps"]).max()
        assert a["heatmaps"].shape == (17, 64, 64) and hm <= 1e-6, hm
        assert (a["fname"], a["gender"]) == (b["fname"], b["gender"])
    print(f"{dataset}: 4 items equal; heatmaps max abs diff {hm:.2e} (tol 1e-6)")
    if dataset == "3dpw":
        kps = np.load(os.path.join(root, "hrnet_results_centred.npy"))[0, :, :2]
        np.testing.assert_allclose(port[0]["keypoints"],
                                   kps * 64 / 96, rtol=1e-6)
