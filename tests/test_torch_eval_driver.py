"""The port's evaluation driver vs the JAX package's, gender-sorted pass.

Both drivers evaluate the gender-interleaved tiny dataset of
tests/test_eval_driver.py (6 frames, m/f/n) at batch 2 with the same
predictor weights (embed 64, 32^2 proxy, carried across with
models/weights.py), the same three synthetic SMPL bodies, 4 samples, and
JAX's own sampler draws, rebuilt from its key splitting (one split per
batch, then pose/shape, then the Bingham proposals) and handed to the
port through its `sample_draws`. The JAX renderer runs its Pallas kernel in
interpret mode, as the renderer tests do. The metrics cover every family:
point errors with and without alignment, sample minima, joints 2D and the
two silhouette IOUs.

Tolerances: final metrics within 1e-4 relative, the IOUs within 2e-3 (a
silhouette edge pixel can move with the last bits of a vertex); per-frame
files within 1e-5 (IOUs 2e-3) and in dataset order.
tests/test_torch_eval_driver_mixed.py runs the unsorted pass.
"""

from functools import partial

import numpy as np
import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose_shape_cfg_defaults as j_cfg)
from hierarchicalprobabilistic3dhuman_tpu.evaluate import (
    evaluate_pose_mf_shape_gaussian_net as jev)
from hierarchicalprobabilistic3dhuman_tpu.models.canny_edge_detector import (
    CannyEdgeDetector as JCanny)
from hierarchicalprobabilistic3dhuman_tpu.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as JPredictor)
from hierarchicalprobabilistic3dhuman_tpu.models.smpl import SMPL as JSMPL

from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults as t_cfg)
from hierarchicalprobabilistic3dhuman_torch.evaluate import (
    evaluate_pose_mf_shape_gaussian_net as tev)
from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
    CannyEdgeDetector as TCanny)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as TPredictor)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL as TSMPL
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_predictor)
from test_eval_driver import _TinyEvalDataset

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

D, N, B = 32, 4, 2
METRICS = ["PVE", "PVE-PA", "PVE-T-SC", "MPJPE-SC", "joints2D-L2E",
           "silhouette-IOU", "PVE_samples_min", "MPJPE-PA_samples_min",
           "joints2Dsamples-L2E", "silhouettesamples-IOU"]
FRAME_FILES = ["fname_per_frame", "pose_per_frame", "shape_per_frame",
               "cam_per_frame"]


def jax_draws(rng_seed=0):
    """sample_draws' stand-in: the draws JAX's driver makes, batch by batch
    (evaluate_pose_mf_shape_gaussian_net.py:394, :219, and
    bingham_sampling.py:47-57)."""
    key = jax.random.PRNGKey(rng_seed)

    def draws(generator, batch_size, num_samples, num_betas, device):
        nonlocal key
        key, sub = jax.random.split(key)
        key_pose, key_shape = jax.random.split(sub)
        key_eps, key_w = jax.random.split(key_pose)
        lanes = num_samples * 8

        def t(a):
            return torch.from_numpy(np.array(a)).to(device)

        return {"pose_eps": t(jax.random.normal(key_eps, (batch_size, 23, lanes, 4))),
                "pose_w": t(jax.random.uniform(key_w, (batch_size, 23, lanes))),
                "shape_eps": t(jax.random.normal(
                    key_shape, (batch_size, num_samples, num_betas)))}
    return draws


def run_jax(save_path, sort_by_gender, on_device_metrics):
    cfg = j_cfg()
    cfg.DATA.PROXY_REP_SIZE = D
    model = JPredictor(embed_dim=64)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 18, D, D)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
        mp.setattr(jev, "TexturedIUVRenderer",
                   partial(jev.TexturedIUVRenderer, backend="pallas"))
        metrics = jev.evaluate_pose_mf_shape_gaussian_net(
            pose_shape_apply=model.apply, pose_shape_vars=variables,
            pose_shape_cfg=cfg, smpl_neutral=JSMPL.synthetic(seed=0),
            smpl_male=JSMPL.synthetic(seed=1), smpl_female=JSMPL.synthetic(seed=2),
            edge_detect_model=JCanny(threshold=0.0), metrics=METRICS,
            eval_dataset=_TinyEvalDataset(), batch_size=B, num_workers=0,
            num_samples_for_metrics=N, save_path=str(save_path),
            save_per_frame_metrics=True, sort_by_gender=sort_by_gender,
            on_device_metrics=on_device_metrics)
    return metrics, jax.tree_util.tree_map(np.asarray, variables)


def run_port(save_path, variables, sort_by_gender, on_device_metrics):
    cfg = t_cfg()
    cfg.DATA.PROXY_REP_SIZE = D
    model = TPredictor(embed_dim=64)
    model.load_state_dict(flax_to_torch_predictor(variables, model))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tev, "sample_draws", jax_draws())
        return tev.evaluate_pose_mf_shape_gaussian_net(
            pose_shape_model=model.eval(), pose_shape_cfg=cfg,
            smpl_neutral=TSMPL.synthetic("cpu", seed=0),
            smpl_male=TSMPL.synthetic("cpu", seed=1),
            smpl_female=TSMPL.synthetic("cpu", seed=2),
            edge_detect_model=TCanny("cpu", threshold=0.0), metrics=METRICS,
            eval_dataset=_TinyEvalDataset(), device=torch.device("cpu"),
            batch_size=B, num_workers=0, num_samples_for_metrics=N,
            save_path=str(save_path), save_per_frame_metrics=True,
            sort_by_gender=sort_by_gender, on_device_metrics=on_device_metrics)


def compare(port_dir, port, jax_dir, ref, label):
    for k in METRICS:
        if "IOU" in k:
            err, tol = abs(port[k] - ref[k]), 2e-3
        else:
            err, tol = abs(port[k] - ref[k]) / abs(ref[k]), 1e-4
        print(f"{label} {k}: port {port[k]:.6f}, JAX {ref[k]:.6f}, diff {err:.2e} "
              f"(tol {tol})")
        assert err <= tol, (label, k)
    for name in FRAME_FILES + [f"{m}_per_frame" for m in METRICS
                               if "samples" not in m]:
        a, b = np.load(port_dir / f"{name}.npy"), np.load(jax_dir / f"{name}.npy")
        if name == "fname_per_frame":
            assert list(a) == list(b) == [f"frame_{i:03d}.png" for i in range(6)]
            continue
        tol = 2e-3 if "IOU" in name else 1e-5
        print(f"{label} {name}: max abs diff {np.abs(a - b).max():.2e} (tol {tol})")
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def sorted_jax(tmp_path_factory):
    jax_dir = tmp_path_factory.mktemp("jax_sorted")
    metrics, variables = run_jax(jax_dir, sort_by_gender=True,
                                 on_device_metrics=True)
    return jax_dir, metrics, variables


@pytest.mark.parametrize("on_device_metrics", [True, False])
def test_sorted_pass_matches_jax(sorted_jax, tmp_path, on_device_metrics):
    """The gender-sorted pass (one static-gender step per gender), metrics
    on the device or on the host tracker, against JAX's sorted pass with
    on-device metrics (JAX's own tests hold its two metric paths equal)."""
    jax_dir, ref, variables = sorted_jax
    port = run_port(tmp_path, variables, True, on_device_metrics)
    compare(tmp_path, port, jax_dir, ref, f"sorted, on_device={on_device_metrics}")
