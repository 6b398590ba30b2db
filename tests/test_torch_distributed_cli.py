"""The three CLIs of the port with the JAX package's multi-device flags, on
the CPU (ranks are processes joined through gloo; --device cpu):

  * run_train_torch.py: --coordinator_address with one process and one
    device (the process group and the mesh at world 1) writes the plain
    run's checkpoint and log.pkl, tensor for tensor and bit for bit;
    --num_devices 2 trains at data 2 and resumes with -R at data 1 x
    sample 2, rank 0 alone writing, its losses and metrics near the plain
    run's;
  * run_evaluate_torch.py --num_devices 2 on a synthetic SSP-3D folder:
    the per-frame files equal the 1-device run's, in dataset order, and
    the printed metrics too (run_predict_torch.py --num_devices 2 is held
    in tests/test_torch_sharded_predict.py);
(The refusals of more cards than torch sees and of an evaluation batch
that does not divide the data axis are in tests/test_torch_cli.py.)
"""

import os
import pickle
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_torch.parallel import free_port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_OPTS = ["DATA.PROXY_REP_SIZE", "24", "TRAIN.BATCH_SIZE", "16",
              "MODEL.EMBED_DIM", "64", "LOSS.STAGE_CHANGE_EPOCH", "1",
              "LOSS.NUM_SAMPLES", "4"]


def _run(script, *args, cwd, timeout=600):
    out = subprocess.run([sys.executable, os.path.join(REPO, script), *args],
                         capture_output=True, text=True, cwd=str(cwd),
                         timeout=timeout, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    return out.stdout


def _train(tmp_path, name, *flags, resume=False):
    exp = tmp_path / name
    args = ["-E", str(exp), "--device", "cpu", "--num_epochs", "2" if resume else "1",
            *flags]
    args += ["-R", "0"] if resume else ["-O", *TRAIN_OPTS]
    _run("run_train_torch.py", *args, cwd=tmp_path)
    with open(exp / "log.pkl", "rb") as f:
        log = pickle.load(f)
    ckpt = torch.load(exp / "saved_models" / "epoch_000.tar", weights_only=False)
    return log, ckpt


@pytest.fixture(scope="module")
def plain_train(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    return tmp, _train(tmp, "plain", "--num_devices", "1")


def test_train_world_one_equals_plain(plain_train):
    """The process group and the mesh at world 1 change no bit."""
    tmp, (log, ckpt) = plain_train
    log1, ckpt1 = _train(tmp, "world1", "--coordinator_address",
                         f"127.0.0.1:{free_port()}", "--num_processes", "1",
                         "--process_id", "0")
    assert log1 == log
    for key in ("model_state_dict", "best_model_state_dict"):
        for k, v in ckpt[key].items():
            assert torch.equal(ckpt1[key][k], v), (key, k)
    assert ckpt1["best_epoch_val_metrics"] == ckpt["best_epoch_val_metrics"]


def test_train_two_ranks(plain_train):
    """Two ranks at data 2 for an epoch of stage 1, then -R 0 at data 1 x
    sample 2 for an epoch of stage 2: log.pkl and epoch_000.tar written
    once, by rank 0, in the reference's layout; the first epoch's losses
    and metrics within 1e-3 relative of the plain run's (four Adam steps
    on a 24^2 proxy, where rounding alone moves the float32 step's
    encoder gradients by percents: tests/test_torch_train_step.py)."""
    tmp, (log, ckpt) = plain_train
    log2, ckpt2 = _train(tmp, "ranks2", "--num_devices", "2")
    assert sorted(ckpt2) == sorted(ckpt) and sorted(log2) == sorted(log)
    for k, v in log.items():
        if v and v[0]:
            assert abs(log2[k][0] - v[0]) <= 1e-3 * abs(v[0]), (k, log2[k], v)
    resumed, _ = _train(tmp, "ranks2", "--num_devices", "2", "--sample_parallel",
                        "2", resume=True)
    assert len(resumed["train_losses"]) == 2
    assert resumed["train_losses"][0] == log2["train_losses"][0]
    assert np.isfinite(resumed["train_joints2Dsamples-L2E"][1])
    assert os.listdir(tmp / "ranks2" / "saved_models") == ["epoch_000.tar"]


def _ssp3d(tmp_path, n=4):
    demo = sorted(os.listdir(os.path.join(REPO, "demo")))
    images = [cv2.resize(cv2.cvtColor(cv2.imread(os.path.join(REPO, "demo", f)),
                                      cv2.COLOR_BGR2RGB), (96, 96))
              for f in demo[:n]]
    root = chip_smoke.write_ssp3d_folder(str(tmp_path / "ssp3d"), images)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("DATA:\n  PROXY_REP_SIZE: 48\nMODEL:\n  EMBED_DIM: 64\n")
    return root, cfg


def _evaluate(tmp_path, root, cfg, name, *flags):
    save = tmp_path / name
    stdout = _run("run_evaluate_torch.py", "--dataset", "ssp3d", "--dataset_path",
                  root, "--device", "cpu", "--batch_size", "2", "-N", "3",
                  "--pose_shape_cfg", str(cfg), "--save_path", str(save),
                  "--num_workers", "0", *flags, cwd=tmp_path)
    printed = [line for line in stdout.splitlines()
               if len(line.split()) == 2 and line.split()[1][-3:-2] == "."]
    files = {f: np.load(save / f) for f in sorted(os.listdir(save))}
    return printed, files


def test_evaluate_ranks_match_one_device(tmp_path):
    """Data 2 (a batch of 2 frames, one a rank) against one device: every
    per-frame file within 1e-5 (the IOU's 2e-3), in dataset order, and the
    printed metrics equal. (The sample axis is held at the step in
    tests/test_torch_sharded_eval.py.)"""
    root, cfg = _ssp3d(tmp_path)
    printed, files = _evaluate(tmp_path, root, cfg, "one", "--num_devices", "1")
    assert len(printed) == 6 and list(files["fname_per_frame.npy"]) == [
        f"frame_{i:03d}.png" for i in range(4)]
    printed2, files2 = _evaluate(tmp_path, root, cfg, "two", "--num_devices", "2")
    assert printed2 == printed
    assert sorted(files2) == sorted(files)
    for name, a in files.items():
        if name == "fname_per_frame.npy":
            assert list(files2[name]) == list(a)
            continue
        tol = 2e-3 if "IOU" in name else 1e-5
        np.testing.assert_allclose(files2[name], a, rtol=0, atol=tol, err_msg=name)
