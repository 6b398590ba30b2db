"""Set-up shared by the port's train-step tests (test_torch_train_step.py,
test_torch_resnet50_step*.py) and its training-trajectory test
(test_torch_golden_run.py): the small training configuration, the JAX
package's predictor and train step built from it (its Pallas rasterizer in
interpret mode), the port's train step built from the same configuration,
and the float64 predictor that the port's float32 noise floors are read
against."""

import contextlib
from functools import partial

import numpy as np
import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import pytest

from chip_smoke import Float64Predictor  # noqa: F401  (shared with the chip's phase 11)
from hierarchicalprobabilistic3dhuman_tpu.models.canny_edge_detector import (
    CannyEdgeDetector as JCanny)
from hierarchicalprobabilistic3dhuman_tpu.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as JPredictor)
from hierarchicalprobabilistic3dhuman_tpu.models.smpl import SMPL as JSMPL
from hierarchicalprobabilistic3dhuman_tpu.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as JRenderer)
from hierarchicalprobabilistic3dhuman_tpu.train.train_pose_mf_shape_gaussian_net import (
    make_train_step as j_make_train_step)

from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
    CannyEdgeDetector as TCanny)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL as TSMPL
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer as TRenderer)
from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
    TrainStep)

EMBED = 64


def small_cfg(get, size, layers):
    """The training config of `get` (either package's
    get_pose_shape_cfg_defaults) at a `size`^2 proxy, ResNet-`layers`,
    EMBED_DIM 64 and 2 matrix-Fisher samples, the focal length scaled with
    the proxy (300 px at 256^2)."""
    cfg = get()
    cfg.DATA.PROXY_REP_SIZE = size
    cfg.MODEL.NUM_RESNET_LAYERS = layers
    cfg.MODEL.EMBED_DIM = EMBED
    cfg.LOSS.NUM_SAMPLES = 2
    cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH = 300.0 * size / 256
    return cfg


def init_jax_predictor(layers, size, seed):
    """JAX's predictor at ResNet-`layers` and its variables (numpy),
    initialised from PRNGKey(seed) on a `size`^2 proxy."""
    jmodel = JPredictor(num_resnet_layers=layers, embed_dim=EMBED)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 18, size, size))))
    return jmodel, variables


@contextlib.contextmanager
def pallas_interpret():
    """JAX's Pallas kernels in interpret mode while the block runs: a step
    that renders must be traced inside it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
        yield


def jax_train_step(predictor, cfg, loss_stage_cfg, optimizer, metrics):
    """JAX's make_train_step(jit=False) of config `cfg`: synthetic SMPL,
    the perspective textured render through the Pallas kernel, Canny with
    threshold 0."""
    size = cfg.DATA.PROXY_REP_SIZE
    return j_make_train_step(
        predictor, cfg, JSMPL.synthetic(),
        JRenderer(img_wh=size, projection_type="perspective",
                  perspective_focal_length=cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH,
                  render_rgb=True, backend="pallas"),
        JCanny(threshold=0.0), loss_stage_cfg, optimizer, train=True,
        jit=False, metrics_to_track=metrics)


def port_train_step(predictor, cfg, loss_stage_cfg, optimizer, metrics):
    """The port's TrainStep on the CPU, built as jax_train_step builds
    JAX's."""
    size = cfg.DATA.PROXY_REP_SIZE
    return TrainStep(
        predictor, cfg, TSMPL.synthetic("cpu"),
        TRenderer("cpu", img_wh=size, projection_type="perspective",
                  perspective_focal_length=cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH,
                  render_rgb=True),
        TCanny("cpu", threshold=0.0), loss_stage_cfg, optimizer, train=True,
        metrics_to_track=metrics)
