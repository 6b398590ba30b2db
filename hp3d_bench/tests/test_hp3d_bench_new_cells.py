"""The two training cells added beside the first four, on the CPU at a tiny
size: the ViT-H/16 cell (paths/train_vit.py, its ViT cut to 2 blocks of
width 64) and the data-parallel cell (paths/train_ddp.py, 4 gloo ranks).
The port agrees with the reference and `correct` comes out true; a broken
path (in the data-parallel cell, the exchange between ranks left out) comes
out false; ranks that take different batches stop the run; a port whose predictor is not the config's stops in
set-up; the ViT's FLOPs at its published widths are those of its
equations."""

import copy
import time

import pytest
import torch
from conftest import tiny

from hp3d_bench import counts_vit, harness
from hp3d_bench.paths import train_vit

VIT = "vith.train.s2.b72"
DDP = "r18.train.s2.b72.ddp4"
SEED = 2 ** 31 + 977
SMALL = {"embed_dim": 64, "depth": 2, "num_heads": 4}


def vit_files():
    workload, config, traffic = tiny(VIT)
    traffic["params"].update(batch=4, poses=512, textures=16, backgrounds=16)
    config["vit"].update(SMALL, img_size=[32, 24])
    config["predictor_parameters"] = train_vit.parameter_count(
        train_vit.reference_model(config, "meta"))
    return workload, config, traffic


def ddp_files():
    workload, config, traffic = (copy.deepcopy(x) for x in harness.cell_files(DDP))
    small = tiny("r18.train.s2.b72")
    config = small[1]
    config["pose_shape_cfg"]["TRAIN"]["BATCH_SIZE"] = 8
    traffic["params"].update(batch=8, poses=512, textures=16, backgrounds=16)
    return workload, config, traffic


@pytest.fixture
def small_port_vit(monkeypatch):
    from hierarchicalprobabilistic3dhuman_torch.models import vit
    monkeypatch.setattr(vit, "VIT_H", dict(vit.VIT_H, **SMALL))


def run(cell, files, trace=0, wrap=None):
    torch.set_num_threads(2)
    ctx = harness.run_cell(cell, SEED, 1.0, trace, "cpu", time.monotonic(),
                           wrap=wrap, files=files)
    line, _ = harness.result_line(ctx, harness.benchmark(), {"platform": "cpu"})
    return ctx, line


def test_vit_port_matches_reference(small_port_vit):
    ctx, line = run(VIT, vit_files(), trace=1)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0
    assert harness.forbidden_modules() == []


def test_vit_untraced_line(small_port_vit):
    ctx, line = run(VIT, vit_files())
    assert set(line["metrics"]) == {"train_img_per_s", "setup_s"}


def half_batch(step):
    def call(draws, pose, background, texture):
        h = pose.shape[0] // 2
        return step(draws, pose[:h], background[:h], texture[:h])
    return call


def test_vit_half_batch_is_not_correct(small_port_vit):
    ctx, line = run(VIT, vit_files(), wrap={"train_step": half_batch})
    assert line["correct"] is False, line["compared"]


def test_port_without_the_vit_stops_in_set_up():
    """A port that builds its ResNet for MODEL.ENCODER vit_h (as one
    without the ViT does) is stopped by the parameter count before any
    stores are written or window opened."""
    workload, config, traffic = vit_files()
    config["pose_shape_cfg"]["MODEL"]["ENCODER"] = "resnet"
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="parameters"):
        run(VIT, (workload, config, traffic))
    assert time.monotonic() - t < 30


def test_vit_flops_at_published_widths():
    """Per 256 x 192 picture: 241.6 GFLOP in the linear layers (32 x 192
    tokens x 2 x 1280 x (3840 + 1280 + 5120 + 5120)), 6.04 in the two
    attention products (32 x 2 x 2 x 192^2 x 1280), 2.26 in the 18-channel
    patch embedding."""
    config = harness.cell_files(VIT)[1]
    meta = train_vit.reference_model(config, "meta")
    enc = counts_vit.vit_encoder_flops(meta.image_encoder, 18, 256)
    linear = 32 * 192 * 2 * 1280 * (3840 + 1280 + 5120 + 5120)
    assert enc["conv_linear"] - enc["patch_embed"] == linear
    assert enc["attention"] == 32 * 2 * 2 * 192 ** 2 * 1280
    assert enc["patch_embed"] == 2 * 192 * 1280 * 18 * 16 * 16
    assert abs(enc["total"] / 1e9 - 250.0) < 1.0
    assert counts_vit.encoder_train_flops(enc) == 3 * enc["total"] - enc["patch_embed"]
    assert train_vit.parameter_count(meta) == config["predictor_parameters"]


def test_ddp_ranks_match_the_single_process_reference():
    """4 gloo ranks of the sharded step, global B = 8 (2 rows a rank):
    rank 0's step against the single-process reference."""
    ctx, line = run(DDP, ddp_files(), trace=1)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0
    assert "data.wait_ms" in line["metrics"]


@pytest.mark.parametrize("fault", ["local_grads", "local_batchnorm"])
def test_ddp_without_the_exchange_is_not_correct(fault):
    """Every rank keeping its own gradients (a DDP hook that reduces
    nothing), or normalising over its own 2 rows: rank 0's step leaves the
    single-process reference's."""
    workload, config, traffic = ddp_files()
    traffic["params"]["fault"] = fault
    ctx, line = run(DDP, (workload, config, traffic))
    print(fault, line["compared"])
    assert line["correct"] is False, line["compared"]


def test_ddp_ranks_on_different_batches_stop():
    """Each rank's loader seeded apart: the first checked step raises on
    every rank, before any window."""
    workload, config, traffic = ddp_files()
    traffic["params"]["fault"] = "rank_batches"
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="different global batches"):
        run(DDP, (workload, config, traffic))
    assert time.monotonic() - t < 60
