"""The port's parallel layer (parallel/mesh.py, parallel/sharded_train.py)
on the CPU: the mesh's layout and its refusals, then 2- and 4-rank gloo
groups (processes of chip_smoke.py, as tests/test_distributed.py starts
JAX's workers) against the 1-rank results:

  * the collectives: all-gathers in rank order with an uneven sample
    split, sums over the world and over each axis (exact);
  * the synced BatchNorm: outputs, input and affine gradients, running
    statistics of each rank's rows equal to the whole batch's; plain
    per-rank statistics (the same layer with `sync` off) fail that;
  * the loss's 2D-joint denominator: with unequal visible-joint counts on
    the ranks, the ranks' shares sum to the 1-rank loss; per-rank
    denominators, averaged as DDP averages, move the 2D-joint term;
  * make_sharded_apply of the predictor equal to its whole-batch forward.

Tolerance: max(1e-5, 10 x the port's float32-vs-float64 floor) of each
tensor's largest entry, the rule of the step tests; the floor here is the
float64 BatchNorm's distance from the float32 one (0.7-1.4e-7 on these
inputs, on the CPU), so 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults)
from hierarchicalprobabilistic3dhuman_torch.losses import PoseMFShapeGaussianLoss
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet)
from hierarchicalprobabilistic3dhuman_torch.models.resnet import BatchNorm2d
from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights
from hierarchicalprobabilistic3dhuman_torch.ops.svd3 import proper_svd3x3
from hierarchicalprobabilistic3dhuman_torch.parallel import (
    check_visible, make_mesh)
from hierarchicalprobabilistic3dhuman_torch.parallel.mesh import Mesh

torch.set_num_threads(2)

SCENARIOS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_torch_rank_scenarios.py")
TOL = 1e-5
B, D, N = 4, 48, 5


def test_mesh_layout_and_refusals(monkeypatch):
    """Rank r at (r // sample, r % sample); rows even, samples split as
    torch.tensor_split splits them (50 over 4: 13/13/12/12); a mesh of
    more devices than the world, or more cards than torch sees, raises."""
    mesh = Mesh(2, 2, 3, "cpu", {"data": None, "sample": None})
    assert (mesh.data_index, mesh.sample_index) == (1, 1)
    assert mesh.rows(8) == slice(4, 8)
    assert mesh.sample_sizes(5) == [3, 2] and mesh.samples(5) == slice(3, 5)
    assert Mesh(1, 4, 0, "cpu", {}).sample_sizes(50) == [13, 13, 12, 12]
    assert [len(t) for t in torch.arange(50).tensor_split(4)] == [13, 13, 12, 12]
    with pytest.raises(ValueError, match="must divide the mesh data axis"):
        mesh.rows(5)
    one = make_mesh()
    assert one.shape == {"data": 1, "sample": 1} and one.is_main
    x = torch.ones(3)
    assert one.all_reduce(x) is x and float(x.sum()) == 3.0
    with pytest.raises(RuntimeError, match="2 devices was asked for"):
        make_mesh(n_devices=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 cuda devices were asked for"):
        check_visible(2, "cuda")
    check_visible(1, "cuda")
    check_visible(64, "cpu")


def _inputs(seed=0):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    F = t(rng.randn(B, 23, 3, 3) * 2.0 + 3.0 * np.eye(3))
    svd = proper_svd3x3(F)
    vis = np.ones((B, 17), bool)
    vis[B // 2:, 3:] = False              # 17 and 3 visible joints per row
    pred = {"pose_params_F": F, "pose_params_U": svd["U"],
            "pose_params_S": svd["S"], "pose_params_V": svd["V"],
            "shape_mean": t(rng.randn(B, 10)),
            "shape_log_std": t(rng.randn(B, 10) * 0.1),
            "verts": t(rng.randn(B, 6890, 3)), "joints3D": t(rng.randn(B, 14, 3)),
            "joints2D": t(rng.rand(B, 1, 17, 2) * 2 - 1),
            "glob_rotmats": t(rng.randn(B, 3, 3))}
    R = proper_svd3x3(t(rng.randn(B, 23, 3, 3)))["mode"]
    target = {"pose_params_rotmats": R, "shape_params": t(rng.randn(B, 10)),
              "joints2D": t(rng.rand(B, 17, 2) * D),
              "joints2D_vis": torch.from_numpy(vis),
              "glob_rotmats": t(rng.randn(B, 3, 3)),
              "verts": t(rng.randn(B, 6890, 3)),
              "joints3D": t(rng.randn(B, 14, 3))}
    bn = {"x": t(rng.randn(B, 6, 5, 5) * 3 + 1), "upstream": t(rng.randn(B, 6, 5, 5)),
          "weight": t(rng.rand(6) + 0.5), "bias": t(rng.randn(6))}
    return {"num_samples": N, "img_wh": D, "pred": pred, "target": target,
            "bn": bn, "proxy": t(rng.rand(B, 18, D, D))}


def _one_rank_batchnorm(bn):
    layer = BatchNorm2d(6)
    with torch.no_grad():
        layer.weight.copy_(bn["weight"])
        layer.bias.copy_(bn["bias"])
    x = bn["x"].clone().requires_grad_(True)
    y = layer.train()(x)
    (y * bn["upstream"]).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "w_grad": layer.weight.grad,
            "b_grad": layer.bias.grad, "running_mean": layer.running_mean,
            "running_var": layer.running_var}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, inputs, tmp_path_factory):
    world = request.param
    inputs = dict(inputs, sample_parallel=2)
    outs = chip_smoke.run_ranks("basics", world, inputs,
                                str(tmp_path_factory.mktemp(f"basics{world}")),
                                module=SCENARIOS, timeout=300)
    return world, outs


def test_collectives(ranks):
    """Sums over the world and each axis, all-gathers over "data" and over
    "sample" with an uneven split (N = 5 over 2), in rank order."""
    world, outs = ranks
    data = world // 2
    for r, out in enumerate(outs):
        d, s = divmod(r, 2)
        assert out["position"] == (d, s)
        assert float(out["sum_world"]) == world * (world + 1) / 2
        assert float(out["sum_sample"]) == (2 * d + 1) + (2 * d + 2)
        assert float(out["sum_data"]) == sum(2 * k + s + 1 for k in range(data))
        assert out["gather_data"].tolist() == [float(2 * k + s) for k in range(data)]
        expect = torch.arange(N, dtype=torch.float32) + 100 * d
        assert torch.equal(out["gather_sample"], expect[None].repeat(2, 1))


def test_synced_batchnorm_matches_one_rank(ranks, inputs):
    """Each rank's rows through the synced BatchNorm equal the whole
    batch's through one; the same layer with per-rank statistics does not
    (rule 1: plain per-rank BatchNorm would fail)."""
    world, outs = ranks
    ref = _one_rank_batchnorm(inputs["bn"])
    rows = np.array_split(np.arange(B), world)
    for out, idx in zip(outs, rows):
        got = out["bn_synced"]
        for k in ("y", "x_grad"):
            assert chip_smoke.rel_diff(got[k], ref[k][idx]) <= TOL, k
        for k in ("w_grad", "b_grad", "running_mean", "running_var"):
            assert chip_smoke.rel_diff(got[k], ref[k]) <= TOL, k
        local = out["bn_local"]
        assert chip_smoke.rel_diff(local["y"], ref["y"][idx]) > 1e-2
        assert chip_smoke.rel_diff(local["running_var"], ref["running_var"]) > 1e-2


def test_loss_denominator_is_global(ranks, inputs):
    """Rows of 17 and of 3 visible joints on different ranks: the ranks'
    shares of the loss sum to the 1-rank loss, term by term; per-rank
    denominators averaged over the ranks (what DDP would make of a
    per-rank mean) give another 2D-joint term (rule 2)."""
    world, outs = ranks
    crit = PoseMFShapeGaussianLoss(get_pose_shape_cfg_defaults().LOSS.STAGE1,
                                   img_wh=D)
    total, terms = crit(inputs["target"], inputs["pred"])
    ref = {"total": total, **terms}
    for k, v in ref.items():
        shares = sum(out["loss_share"][k] for out in outs)
        assert chip_smoke.rel_diff(shares, v) <= TOL, k
    averaged = sum(out["loss_local"]["joints2D"] for out in outs) / world
    assert chip_smoke.rel_diff(averaged, ref["joints2D"]) > 0.1


def test_sharded_apply_matches_whole_batch(ranks, inputs):
    """make_sharded_apply: each rank's rows through the predictor, every
    row's outputs back on every rank, equal to one whole-batch forward."""
    _, outs = ranks
    model = PoseMFShapeGaussianNet(embed_dim=64)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = model.eval()(inputs["proxy"])
    for out in outs:
        for k, v in ref.items():
            assert chip_smoke.rel_diff(out["apply"][k], v) <= TOL, k

