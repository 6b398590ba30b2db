"""Two faults the training slice would have brought into the port, each
held against the JAX package on the CPU:

- the matrix-Fisher sampler's det signs carry no gradient (JAX's
  proper_svd_from_raw stops it); with the head's convention, which keeps
  it, d(loss)/dU differed from JAX's by up to ~1 on random rotations;
- BatchNorm in train mode normalises with the biased batch variance and
  updates its running variance with it, as flax's nn.BatchNorm does
  (torch's own uses the unbiased one for the update: n/(n-1) apart).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from hierarchicalprobabilistic3dhuman_tpu.models.resnet import resnet18 as j_resnet18
from hierarchicalprobabilistic3dhuman_tpu.ops import bingham_sampling as jbs

from hierarchicalprobabilistic3dhuman_torch.models.resnet import resnet18
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_resnet)
from hierarchicalprobabilistic3dhuman_torch.ops import bingham_sampling as tbs

torch.set_num_threads(2)


def _random_svd(rng, n):
    """U, S, V of n random F (dets of U and V of both signs)."""
    F = rng.randn(n, 3, 3).astype(np.float32)
    U, S, Vt = np.linalg.svd(F)
    return U, S, np.swapaxes(Vt, -1, -2)


def test_sampler_gradient_matches_jax():
    """d(sum(R * G))/d(U, S, V) through the sampler, with JAX's eps and w
    draws handed to the port, against jax.grad. Tolerance 1e-5 of each
    gradient's largest entry (measured: ~1e-7)."""
    B, J, N, K = 2, 4, 3, 8
    rng = np.random.RandomState(0)
    U, S, V = _random_svd(rng, B * J)
    U, V = U.reshape(B, J, 3, 3), V.reshape(B, J, 3, 3)
    S = S.reshape(B, J, 3) * 5.0
    G = rng.randn(B, N, J, 3, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    key_eps, key_w = jax.random.split(key)
    eps = np.array(jax.random.normal(key_eps, (B, J, N * K, 4)))
    w = np.array(jax.random.uniform(key_w, (B, J, N * K)))

    def jloss(U, S, V):
        R = jbs.pose_matrix_fisher_sampling(key, U, S, V, N, oversampling_ratio=K)
        return jnp.sum(R * G)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(U), jnp.asarray(S),
                                            jnp.asarray(V))
    tU, tS, tV = (torch.tensor(a, requires_grad=True) for a in (U, S, V))
    R = tbs.pose_matrix_fisher_sampling(tU, tS, tV, N, oversampling_ratio=K,
                                        eps=torch.from_numpy(eps),
                                        w=torch.from_numpy(w))
    torch.sum(R * torch.from_numpy(G)).backward()
    for name, t, j in (("U", tU, jg[0]), ("S", tS, jg[1]), ("V", tV, jg[2])):
        j = np.asarray(j)
        err = np.abs(t.grad.numpy() - j).max() / np.abs(j).max()
        print(f"sampler d/d{name}: max diff {err:.2e} of the largest")
        assert err <= 1e-5, (name, err)


def _flax_resnet(B, D, seed):
    """Flax ResNet-18 variables with non-trivial running statistics, an
    input, and one train-mode apply with its new statistics and every
    submodule's output (capture_intermediates)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 18, D, D).astype(np.float32)
    jmodel = j_resnet18(in_channels=18)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 18, D, D))))
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.rand(*a.shape).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    out, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats", "intermediates"],
                                capture_intermediates=True)
    mutated = jax.tree_util.tree_map(np.asarray, mutated)
    new_stats = {"params": variables["params"],
                 "batch_stats": mutated["batch_stats"]}
    return x, variables, np.asarray(out), new_stats, mutated["intermediates"]


def _stats_diff(model, new_sd):
    return max(float((v - new_sd[k]).abs().max())
               for k, v in model.state_dict().items()
               if k.endswith(("running_mean", "running_var")))


def test_batchnorm_train_mode_matches_flax():
    """Every BatchNorm of ResNet-18 at B=2, 32^2 (2 values a channel in the
    last stage, where torch's unbiased update would be 2x flax's) in train
    mode, fed flax's own input to that layer: outputs within 1e-5 of the
    layer's largest output (measured: 4.3e-6, the order of the float32
    sums over 128 values) and running_mean/running_var within 1e-5
    (measured: 7e-7) of flax's apply(..., mutable=["batch_stats"]).

    Layer by layer, because the whole float32 forward is chaotic at this
    size: a channel of two nearly equal values is normalised by ~1/sqrt(eps)
    and the next layers amplify the last bits of the convolutions' sums;
    flax's and the port's outputs are each 0.06-0.08 away from the port's
    float64 forward there (measured on the CPU). The whole network is held at
    B=2, 64^2 below."""
    x, variables, _, new_vars, inter = _flax_resnet(2, 32, seed=1)
    model = resnet18(in_channels=18)
    model.load_state_dict(flax_to_torch_resnet(variables, model))
    model.train()
    new_sd = flax_to_torch_resnet(new_vars, model)

    def nchw(a):
        return torch.from_numpy(np.array(a.transpose(0, 3, 1, 2)))

    checked, worst_out, worst_stats = 0, 0.0, 0.0
    for name, bn in model.named_modules():
        if not isinstance(bn, torch.nn.BatchNorm2d):
            continue
        *block, leaf = name.split(".")
        if leaf == "1":                                  # downsample.1
            block, bn_name, conv_name = block[:-1], "downsample_bn", "downsample_conv"
        else:
            bn_name, conv_name = leaf, leaf.replace("bn", "conv")
        node = inter
        if block:
            node = node[f"{block[0]}_{block[1]}"]
        with torch.no_grad():
            out = bn(nchw(node[conv_name]["__call__"][0]))
        ref = nchw(node[bn_name]["__call__"][0])
        worst_out = max(worst_out, float((out - ref).abs().max()
                                         / ref.abs().max()))
        for stat in ("running_mean", "running_var"):
            worst_stats = max(worst_stats, float(
                (getattr(bn, stat) - new_sd[f"{name}.{stat}"]).abs().max()))
        checked += 1
    print(f"{checked} BatchNorms: outputs max diff {worst_out:.2e} of the "
          f"largest, running "
          f"stats max diff {worst_stats:.2e}")
    assert checked == 20
    assert worst_out <= 1e-5 and worst_stats <= 1e-5


def test_resnet_train_forward_matches_flax():
    """The whole train-mode forward at B=2, 64^2 (8 values a channel in the
    last stage): every running_mean/running_var within 1e-5, outputs within
    1e-4 (float32: flax and the port are each 1-3e-5 from the port's
    float64 forward at this size, measured on the CPU)."""
    x, variables, jout, new_vars, _ = _flax_resnet(2, 64, seed=1)
    model = resnet18(in_channels=18)
    model.load_state_dict(flax_to_torch_resnet(variables, model))
    out = model.train()(torch.from_numpy(x)).detach().numpy()
    err = np.abs(out - jout).max()
    stats = _stats_diff(model, flax_to_torch_resnet(new_vars, model))
    print(f"train-mode forward: outputs max diff {err:.2e}, running stats "
          f"max diff {stats:.2e}")
    assert err <= 1e-4 and stats <= 1e-5


def test_batchnorm_eval_mode_is_torchs():
    """Eval mode is nn.BatchNorm2d's own, bit for bit."""
    from hierarchicalprobabilistic3dhuman_torch.models.resnet import BatchNorm2d
    bn, ref = BatchNorm2d(8), torch.nn.BatchNorm2d(8)
    with torch.no_grad():
        for m in (bn, ref):
            m.running_mean.copy_(torch.linspace(-1, 1, 8))
            m.running_var.copy_(torch.linspace(0.5, 2, 8))
            m.weight.copy_(torch.linspace(0.1, 3, 8))
    x = torch.randn(3, 8, 5, 5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(bn.eval()(x), ref.eval()(x))
