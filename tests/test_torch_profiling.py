"""The port's profiling hooks (runtime/profiling.py) on the CPU: trace(None)
records nothing; trace(dir) writes one Chrome trace that parses, also when
its block raises; --profile_dir on a small training run from packed stores
and on a small SSP-3D evaluation each writes one; StageTimer.summary() has
the JAX package's keys and counts."""

import json
import os
import time

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_tpu.runtime.profiling import (
    StageTimer as JStageTimer)

from hierarchicalprobabilistic3dhuman_torch.cli.evaluate import main as eval_main
from hierarchicalprobabilistic3dhuman_torch.cli.train import main as train_main
from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import (
    StageTimer, TRACE_NAME, trace)
from test_torch_native_train import small_stores, small_train_argv

torch.set_num_threads(2)


def profiler_enabled():
    return torch.autograd.profiler._is_profiler_enabled


def read_trace(profile_dir):
    """The events of the one trace in profile_dir."""
    assert os.listdir(profile_dir) == [TRACE_NAME]
    with open(os.path.join(profile_dir, TRACE_NAME)) as f:
        return json.load(f)["traceEvents"]


def op_names(events):
    return {e.get("name", "") for e in events if e.get("cat") == "cpu_op"}


def test_trace_none_records_nothing(tmp_path):
    with trace(None):
        assert not profiler_enabled()
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "ok")):
        assert profiler_enabled()
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert not profiler_enabled()
    assert "aten::mm" in op_names(read_trace(tmp_path / "ok"))
    with pytest.raises(ValueError):
        with trace(str(tmp_path / "raised")):
            torch.ones(3).sum()
            raise ValueError("the block failed")
    assert not profiler_enabled()
    assert "aten::sum" in op_names(read_trace(tmp_path / "raised"))


def test_profile_dir_on_training(tmp_path):
    stores = small_stores(str(tmp_path))
    profile_dir = str(tmp_path / "profile")
    train_main(small_train_argv(str(tmp_path / "exp"), stores, epochs=1)
               + ["--profile_dir", profile_dir])
    names = op_names(read_trace(profile_dir))
    assert "aten::convolution_backward" in names and "aten::conv2d" in names


def test_profile_dir_on_evaluation(tmp_path):
    demo = sorted(f for f in os.listdir(chip_smoke.DEMO) if f.endswith(".png"))[:2]
    images = [cv2.resize(cv2.cvtColor(cv2.imread(os.path.join(chip_smoke.DEMO, f)),
                                      cv2.COLOR_BGR2RGB), (96, 96)) for f in demo]
    root = chip_smoke.write_ssp3d_folder(str(tmp_path / "ssp3d"), images)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("DATA:\n  PROXY_REP_SIZE: 32\n")
    profile_dir = str(tmp_path / "profile")
    eval_main(["--dataset", "ssp3d", "--dataset_path", root, "--device", "cpu",
               "--batch_size", "2", "-N", "2", "--pose_shape_cfg", str(cfg),
               "--save_path", str(tmp_path / "out"), "--num_workers", "0",
               "--profile_dir", profile_dir])
    assert "aten::conv2d" in op_names(read_trace(profile_dir))
    assert os.path.exists(tmp_path / "out" / "fname_per_frame.npy")


def test_stage_timer_summary_matches_jax():
    summaries = []
    for timer in (JStageTimer(), StageTimer()):
        for name in ("load", "step", "step", "save", "step"):
            with timer.stage(name):
                time.sleep(0.001)
        summaries.append(timer.summary())
    jax_summary, port_summary = summaries
    assert list(port_summary) == list(jax_summary) == ["load", "step", "save"]
    for name in jax_summary:
        assert sorted(port_summary[name]) == sorted(jax_summary[name])
        assert port_summary[name]["count"] == jax_summary[name]["count"]
        assert port_summary[name]["total_s"] >= 0.001 * port_summary[name]["count"]
        assert np.isclose(port_summary[name]["mean_s"],
                          port_summary[name]["total_s"] / port_summary[name]["count"],
                          atol=1e-4)
