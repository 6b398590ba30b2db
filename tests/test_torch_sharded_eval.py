"""The port's sharded eval step on the CPU against its 1-rank step, and
against the JAX package's eval step on JAX's own ("data", "sample") mesh.

One SSP-3D-style batch at B = 4, 48^2, EMBED_DIM 64, 4 samples, mixed
genders (the three synthetic SMPL bodies of seeds 0, 1, 2), random
images, heatmaps, targets and silhouettes; the frame metrics on the
device.

  * 2 gloo ranks (processes of chip_smoke.py) at data 2 and at sample 2
    against the 1-rank step, every metric family (point errors with and
    without alignment, best-sample minima, joints 2D, both silhouette
    IOUs): per-frame values and sample sums within max(1e-5, 10 x the
    float32 floor) of each output's largest value, 1e-5 here (rows and
    samples split, the sums only reordered); the IOU counts within 2e-3
    (a silhouette edge pixel can move with the last bits of a vertex);
  * 4 ranks at data 2 x sample 2 against JAX's
    _make_eval_step(mesh=make_mesh(sample_parallel=2)) on the 8-device
    virtual CPU mesh (data 4 x sample 2; tests/test_parallel.py:105 holds
    it to JAX's unsharded step at 5e-4) and JAX's unsharded step, on the
    same weights and the same draws (JAX's key tree, as tests/jax_draws.py
    rebuilds it), without silhouettes (JAX's would run its Pallas kernel
    in interpret mode inside the sharded jit): within 1e-4 of each
    output's largest value of JAX's unsharded step, the JAX-against-port
    rule of tests/test_torch_eval_driver.py, and of JAX's sharded step
    within that plus JAX's own distance between its two steps.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose_shape_cfg_defaults as j_cfg)
from hierarchicalprobabilistic3dhuman_tpu.evaluate.evaluate_pose_mf_shape_gaussian_net import (
    _make_eval_step as j_make_eval_step)
from hierarchicalprobabilistic3dhuman_tpu.metrics.metric_sums import (
    make_eval_frame_metrics_fn as j_frame_metrics_fn)
from hierarchicalprobabilistic3dhuman_tpu.models.canny_edge_detector import (
    CannyEdgeDetector as JCanny)
from hierarchicalprobabilistic3dhuman_tpu.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as JPredictor)
from hierarchicalprobabilistic3dhuman_tpu.models.smpl import SMPL as JSMPL
from hierarchicalprobabilistic3dhuman_tpu.parallel import make_mesh as j_make_mesh

from hierarchicalprobabilistic3dhuman_torch.cli.predict import build_pose_shape_model
from hierarchicalprobabilistic3dhuman_torch.configs import get_pose_shape_cfg_defaults
from hierarchicalprobabilistic3dhuman_torch.evaluate.evaluate_pose_mf_shape_gaussian_net import (
    sample_draws)
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_predictor)

torch.set_num_threads(2)

D, B, N = 48, 4, 4
CFG = ["DATA.PROXY_REP_SIZE", D, "MODEL.EMBED_DIM", 64]
JAX_METRICS = ["PVE", "PVE-PA", "PVE-T-SC", "MPJPE-SC", "joints2D-L2E",
               "PVE_samples_min", "MPJPE-PA_samples_min", "joints2Dsamples-L2E"]


def _batch(seed=0):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return {"image": t(rng.rand(B, 3, D, D)),
            "heatmaps": t(rng.rand(B, 17, D, D) ** 8),
            "pose": t(rng.randn(B, 72) * 0.2), "shape": t(rng.randn(B, 10)),
            "gender": torch.tensor([0, 1, 2, 1], dtype=torch.int32),
            "joints2d": t(rng.rand(B, 17, 2) * D),
            "silhouette": t(rng.rand(B, D, D) > 0.5)}


def _inputs(metrics, silhouettes, draws, weights=None, sample_parallel=(1,)):
    return {"cfg": CFG, "batch": _batch(), "draws": draws, "metrics": metrics,
            "num_samples": N, "silhouettes": silhouettes, "weights": weights,
            "sample_parallel": list(sample_parallel)}


def test_two_ranks_match_one(tmp_path):
    """Data 2 and sample 2 against one rank, every metric family."""
    draws = sample_draws(torch.Generator().manual_seed(0), B, N, 10, "cpu")
    inputs = _inputs(chip_smoke.PAR_EVAL_METRICS, True, draws,
                     sample_parallel=(1, 2))
    ref = chip_smoke.par_eval_step(torch.device("cpu"), inputs)
    outs = chip_smoke.run_ranks("eval", 2, inputs, str(tmp_path), threads=2,
                                timeout=600)
    assert set(ref["frame_metrics"]) >= {"PVE_samples_min", "silhouette-IOU",
                                         "num_samples_true_positives"}
    for rank, per_mesh in enumerate(outs):
        for s, got in zip(inputs["sample_parallel"], per_mesh):
            worst = chip_smoke.compare_frames(
                f"eval, data {2 // s} x sample {s}, rank {rank}", ref, got)
            assert worst <= 1.0


def _jax_draws(key):
    """sample_draws' dict of JAX's eval step's draws from `key`
    (evaluate_pose_mf_shape_gaussian_net.py:219 and
    bingham_sampling.py:47-57)."""
    key_pose, key_shape = jax.random.split(key)
    key_eps, key_w = jax.random.split(key_pose)

    def t(a):
        return torch.from_numpy(np.array(a))

    return {"pose_eps": t(jax.random.normal(key_eps, (B, 23, N * 8, 4))),
            "pose_w": t(jax.random.uniform(key_w, (B, 23, N * 8))),
            "shape_eps": t(jax.random.normal(key_shape, (B, N, 10)))}


def test_four_ranks_match_jax_mesh(tmp_path):
    """The port's 2 x 2 ranks against JAX's sharded eval step, and against
    JAX's unsharded one: within 1e-4 of the latter, and of the former
    within 1e-4 plus JAX's own distance between the two (its sharded step
    moves the best-sample errors by up to ~6e-4 relative on the CPU; its
    own test allows 5e-4 on the sample meshes)."""
    cfg = j_cfg()
    cfg.DATA.PROXY_REP_SIZE = D
    model = JPredictor(embed_dim=64)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 18, D, D)))
    key = jax.random.PRNGKey(7)
    b = _batch()
    args = [jnp.asarray(b[k].numpy()) for k in ("image", "heatmaps", "pose",
                                               "shape", "gender", "joints2d",
                                               "silhouette")]

    def jax_step(mesh):
        step = j_make_eval_step(
            lambda proxy: model.apply(variables, proxy), JSMPL.synthetic(seed=0),
            JSMPL.synthetic(seed=1), JSMPL.synthetic(seed=2),
            JCanny(threshold=0.0), cfg, N, compute_joints2d=True,
            compute_silhouettes=False, compute_samples=True,
            silhouette_renderer=None, mesh=mesh,
            frame_metrics_fn=j_frame_metrics_fn(JAX_METRICS))
        with mesh or contextlib.nullcontext():
            out = step(key, *args)
        return {"frame_metrics": {k: torch.from_numpy(np.array(v))
                                  for k, v in out["frame_metrics"].items()}}

    mesh = j_make_mesh(sample_parallel=2)
    assert mesh.shape == {"data": 4, "sample": 2}
    ref_mesh, ref_single = jax_step(mesh), jax_step(None)

    t_cfg = get_pose_shape_cfg_defaults()
    t_cfg.merge_from_list(CFG)
    weights = flax_to_torch_predictor(jax.tree_util.tree_map(np.asarray, variables),
                                      build_pose_shape_model(t_cfg, "jacobi"))
    inputs = _inputs(JAX_METRICS, False, _jax_draws(key), weights=weights,
                     sample_parallel=(2,))
    outs = chip_smoke.run_ranks("eval", 4, inputs, str(tmp_path), threads=2,
                                timeout=600)
    for rank, (got,) in enumerate(outs):
        for k, single in ref_single["frame_metrics"].items():
            port = got["frame_metrics"][k]
            jax_own = chip_smoke.rel_diff(ref_mesh["frame_metrics"][k], single)
            to_single = chip_smoke.rel_diff(port, single)
            to_mesh = chip_smoke.rel_diff(port, ref_mesh["frame_metrics"][k])
            print(f"rank {rank} {k}: port vs JAX {to_single:.1e}, vs JAX's mesh "
                  f"{to_mesh:.1e} (JAX mesh vs JAX {jax_own:.1e})")
            assert to_single <= 1e-4, k
            assert to_mesh <= 1e-4 + jax_own, k
