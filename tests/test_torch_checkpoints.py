"""Reference checkpoints in the port, and the --svd_impl auto rule.

A `.tar` in the reference's layout (the state dicts beside epoch,
best_epoch_val_metrics and optimiser_state_dict, which hold numpy scalars)
is written with torch.save from random weights. It loads into fresh port
modules with strict=True, every tensor equal; the JAX package's
converters (torch_to_flax_predictor, torch_to_flax_hrnet) read the same
state dict, and the JAX networks' outputs equal the port's within 1e-4
(HRNet's heatmaps, which reach ~7e3 on random weights, within 1e-4 of their
maximum). Any other suffix (the JAX package's flax checkpoints) raises.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu.models.hrnet import (
    PoseHighResolutionNet as JHRNet, torch_to_flax_hrnet)
from hierarchicalprobabilistic3dhuman_tpu.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as JPredictor, torch_to_flax_predictor)

from hierarchicalprobabilistic3dhuman_torch.cli.predict import resolve_svd_impl
from hierarchicalprobabilistic3dhuman_torch.models.hrnet import (
    PoseHighResolutionNet as THRNet)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as TPredictor)
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    init_weights, load_checkpoint, load_hrnet_state_dict,
    load_predictor_state_dict)

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

D = 64
# The W48 topology (the key set torch_to_flax_hrnet reads) at width 8.
HRNET_KW = dict(width=8)


def _randomise(module, seed):
    """Random weights, and BatchNorm statistics that are not the identity."""
    init_weights(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return module.eval()


def reference_tar(path, key, state_dict, extra=None):
    """torch.save in the reference's layout, numpy scalars included."""
    ckpt = {key: state_dict,
            "epoch": np.int64(7),
            "best_epoch": np.int64(5),
            "best_epoch_val_metrics": {"PVE-PA": np.float64(0.0612),
                                       "MPJPE": np.float32(0.081)},
            "optimiser_state_dict": {"state": {}, "param_groups": [
                {"lr": 1e-4, "betas": (0.9, 0.999)}]}}
    ckpt.update(extra or {})
    torch.save(ckpt, path)
    return str(path)


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def test_predictor_tar_loads_and_matches_jax(tmp_path):
    source = _randomise(TPredictor(embed_dim=64), 0)
    best = source.state_dict()
    stale = _randomise(TPredictor(embed_dim=64), 1).state_dict()
    path = reference_tar(tmp_path / "model.tar", "best_model_state_dict", best,
                         {"model_state_dict": stale})
    assert load_checkpoint(path)["epoch"] == 7
    loaded = TPredictor(embed_dim=64)
    loaded.load_state_dict(load_predictor_state_dict(path), strict=True)
    loaded.eval()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, best[k]), k

    x = np.random.RandomState(3).rand(2, 18, D, D).astype(np.float32)
    ref = jax.jit(JPredictor(embed_dim=64).apply)(
        torch_to_flax_predictor(_numpy_sd(best)), jnp.asarray(x))
    with torch.no_grad():
        port = loaded(torch.from_numpy(x))
    for k in sorted(ref):
        err = np.abs(port[k].numpy() - np.asarray(ref[k])).max()
        print(f"predictor from .tar, {k}: max abs diff from JAX {err:.2e} (tol 1e-4)")
        assert err <= 1e-4, k


def test_predictor_state_dict_fallbacks(tmp_path):
    """model_state_dict without a best one; a bare state dict."""
    sd = _randomise(TPredictor(embed_dim=64), 2).state_dict()
    for path in (reference_tar(tmp_path / "a.pth", "model_state_dict", sd),
                 str(tmp_path / "b.pt")):
        if path.endswith(".pt"):
            torch.save(sd, path)
        got = load_predictor_state_dict(path)
        assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)


def test_hrnet_tar_loads_and_matches_jax(tmp_path):
    """The reference HRNet checkpoint's `state_dict`, with its training
    loss's keys, which are dropped."""
    source = _randomise(THRNet(**HRNET_KW), 4)
    sd = dict(source.state_dict())
    sd["loss.criterion.weight"] = torch.ones(3)
    path = reference_tar(tmp_path / "pose_hrnet.pth", "state_dict", sd)
    loaded = THRNet(**HRNET_KW)
    loaded.load_state_dict(load_hrnet_state_dict(path), strict=True)
    loaded.eval()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k

    x = np.random.RandomState(5).randn(1, 3, D, D).astype(np.float32)
    jsd = _numpy_sd(load_hrnet_state_dict(path))
    ref = jax.jit(JHRNet(**HRNET_KW).apply)(torch_to_flax_hrnet(jsd),
                                           jnp.asarray(x))
    with torch.no_grad():
        port = loaded(torch.from_numpy(x))
    err = np.abs(port.numpy() - np.asarray(ref)).max()
    scale = np.abs(np.asarray(ref)).max()
    print(f"HRNet from .pth: max abs diff from JAX {err:.2e}, heatmap max "
          f"{scale:.2f} (tol 1e-4 of the max)")
    assert err <= 1e-4 * max(scale, 1.0)


@pytest.mark.parametrize("name", ["model.msgpack", "model.npz", "model"])
def test_other_formats_raise(tmp_path, name):
    with pytest.raises(NotImplementedError, match="training slice"):
        load_predictor_state_dict(str(tmp_path / name))


@pytest.mark.parametrize("weights,asked,expected", [
    ("model.tar", "auto", "lapack"),
    ("model.pth", "auto", "lapack"),
    ("model.pt", "auto", "lapack"),
    (None, "auto", "jacobi"),
    ("model.msgpack", "auto", "jacobi"),
    ("model.tar", "jacobi", "jacobi"),
    (None, "lapack_callback", "lapack_callback"),
])
def test_svd_impl_auto_rule(weights, asked, expected):
    """The JAX package's cli/evaluate.py:81-83, and no silent switch of an
    explicit choice."""
    assert resolve_svd_impl(asked, weights) == expected
