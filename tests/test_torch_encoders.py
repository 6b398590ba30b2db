"""Port vs JAX package: ResNet-18, HRNet (reduced), the distribution
predictor, and the weight converters between them.

The flax variables are initialised by JAX, their BatchNorm statistics and
affine terms re-drawn from a numpy seed (so BatchNorm is not the identity),
and carried into the port with models/weights.py. Inputs come from numpy.
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
from hierarchicalprobabilistic3dhuman_tpu.models.resnet import (
    resnet18 as j_resnet18, torch_to_flax_resnet)

from hierarchicalprobabilistic3dhuman_torch.models.hrnet import (
    PoseHighResolutionNet as THRNet)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet as TPredictor)
from hierarchicalprobabilistic3dhuman_torch.models.resnet import (
    resnet18 as t_resnet18)
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_hrnet, flax_to_torch_predictor, flax_to_torch_resnet,
    init_weights)

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _randomise_batchnorm(variables, seed):
    """Non-trivial BatchNorm: scale/bias/mean/var re-drawn from numpy."""
    rng = np.random.RandomState(seed)
    v = _numpy_tree(variables)

    def walk(params, stats):
        for name, sub in params.items():
            if "scale" in sub:
                n = sub["scale"].shape
                sub["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                sub["bias"] = (rng.randn(*n) * 0.1).astype(np.float32)
                stats[name]["mean"] = (rng.randn(*n) * 0.1).astype(np.float32)
                stats[name]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            elif isinstance(sub, dict) and "kernel" not in sub:
                walk(sub, stats.get(name, {}))

    walk(v["params"], v["batch_stats"])
    return v


def _report(name, port, ref, atol):
    port, ref = np.asarray(port), np.asarray(ref)
    print(f"{name}: max abs diff {np.abs(port - ref).max():.3e} (tol {atol})")
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol, err_msg=name)


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=str(path))


def test_resnet18_matches():
    x = np.random.RandomState(0).rand(2, 18, 64, 64).astype(np.float32)
    jmodel = j_resnet18()
    variables = _randomise_batchnorm(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 18, 64, 64))), 1)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    tmodel = t_resnet18().eval()
    tmodel.load_state_dict(flax_to_torch_resnet(variables, tmodel))
    with torch.no_grad():
        port = tmodel(torch.from_numpy(x))
    _report("resnet18 features", port, ref, 5e-5)  # measured 1.6e-6
    # and back: the JAX converter inverts ours
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    _assert_trees_equal(torch_to_flax_resnet(sd), variables)


def test_hrnet_reduced_matches():
    """width 8, one module per stage, 64x64 input; the JAX model runs its
    width-folded branch 0, the port the plain topology."""
    x = np.random.RandomState(2).randn(1, 3, 64, 64).astype(np.float32)
    jmodel = JHRNet(width=8, stage_modules=(1, 1, 1))
    variables = _randomise_batchnorm(
        jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, 3, 64, 64))), 3)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    tmodel = THRNet(width=8, stage_modules=(1, 1, 1)).eval()
    tmodel.load_state_dict(flax_to_torch_hrnet(variables, tmodel))
    with torch.no_grad():
        port = tmodel(torch.from_numpy(x))
    assert port.shape == ref.shape == (1, 17, 16, 16)
    # The README's conversion bar; measured 3.5e-5 (heatmaps of order 1-10,
    # the folded branch 0 reassociates its sums).
    _report("hrnet heatmaps", port, ref, 5e-4)


def test_hrnet_state_dict_keys_round_trip_through_jax_converter():
    """torch_to_flax_hrnet reads the reference checkpoint keys of the full
    W48 topology (1, 4, 3 modules); at width 8 the key set is the same, and
    our converter inverts it exactly."""
    tmodel = init_weights(THRNet(width=8), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(generator=torch.Generator().manual_seed(1))
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    flax_vars = torch_to_flax_hrnet(sd)
    back = flax_to_torch_hrnet(flax_vars, tmodel)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    _assert_trees_equal(torch_to_flax_hrnet(
        {k: v.numpy() for k, v in back.items()}), flax_vars)


@pytest.fixture(scope="module")
def predictor_pair():
    jmodel = JPredictor()
    variables = _randomise_batchnorm(
        jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((1, 18, 64, 64))), 4)
    tmodel = TPredictor().eval()
    tmodel.load_state_dict(flax_to_torch_predictor(variables, tmodel))
    return jmodel, variables, tmodel


def test_predictor_matches(predictor_pair):
    """Encoder, depth-grouped hierarchical head, delta-I and the Jacobi SVD
    at every kinematic depth, on a 64x64 proxy."""
    jmodel, variables, tmodel = predictor_pair
    x = np.random.RandomState(5).rand(2, 18, 64, 64).astype(np.float32)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        port = tmodel(torch.from_numpy(x))
    assert set(port) == set(ref)
    for k in sorted(ref):
        _report(k, port[k], ref[k], 2e-5)      # measured max 2.7e-6


def test_predictor_converter_inverts_jax_converter(predictor_pair):
    _, variables, tmodel = predictor_pair
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    _assert_trees_equal(torch_to_flax_predictor(sd), variables)
    back = flax_to_torch_predictor(torch_to_flax_predictor(sd), tmodel)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_init_weights_is_seeded():
    a = init_weights(t_resnet18(), torch.Generator().manual_seed(7)).state_dict()
    b = init_weights(t_resnet18(), torch.Generator().manual_seed(7)).state_dict()
    c = init_weights(t_resnet18(), torch.Generator().manual_seed(8)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
