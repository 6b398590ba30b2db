"""The port's evaluation driver vs the JAX package's, unsorted pass; and
run_evaluate_torch.py end to end on the CPU.

The unsorted pass runs every batch of the gender-interleaved tiny dataset
through the mixed-gender step (smpl_forward_mixed). Inputs, weights, draws
and tolerances as in tests/test_torch_eval_driver.py; here JAX keeps its
host-tracker metrics (on_device_metrics=False) and the port runs both.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_eval_driver import compare, run_jax, run_port

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mixed_jax(tmp_path_factory):
    jax_dir = tmp_path_factory.mktemp("jax_mixed")
    metrics, variables = run_jax(jax_dir, sort_by_gender=False,
                                 on_device_metrics=False)
    return jax_dir, metrics, variables


@pytest.mark.parametrize("on_device_metrics", [True, False])
def test_mixed_pass_matches_jax(mixed_jax, tmp_path, on_device_metrics):
    jax_dir, ref, variables = mixed_jax
    port = run_port(tmp_path, variables, False, on_device_metrics)
    compare(tmp_path, port, jax_dir, ref, f"mixed, on_device={on_device_metrics}")


def test_missing_ground_truth_raises(mixed_jax, tmp_path, monkeypatch):
    """A requested metric whose ground truth the batch lacks fails loudly
    (the JAX driver's :400-407)."""
    from test_eval_driver import _TinyEvalDataset
    item = _TinyEvalDataset.__getitem__

    def no_silhouette(self, i):
        out = item(self, i)
        del out["silhouette"]
        return out

    monkeypatch.setattr(_TinyEvalDataset, "__getitem__", no_silhouette)
    with pytest.raises(KeyError, match="silhouette"):
        run_port(tmp_path, mixed_jax[2], False, True)


def test_run_evaluate_torch_on_cpu(tmp_path):
    """run_evaluate_torch.py --dataset ssp3d --device cpu on 4 demo photos in
    SSP-3D's layout, 32^2 proxy, embed 64, 2 samples, batch 2: the six
    metrics finite, the IOUs in [0, 1], the per-frame files in dataset
    order."""
    demo = [f for f in sorted(os.listdir(os.path.join(REPO, "demo")))
            if cv2.imread(os.path.join(REPO, "demo", f)).shape[:2] == (512, 512)]
    images = [cv2.resize(cv2.cvtColor(cv2.imread(os.path.join(REPO, "demo", f)),
                                      cv2.COLOR_BGR2RGB), (96, 96))
              for f in demo[:4]]
    root = chip_smoke.write_ssp3d_folder(str(tmp_path / "ssp3d"), images)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("DATA:\n  PROXY_REP_SIZE: 32\nMODEL:\n  EMBED_DIM: 64\n")
    save = tmp_path / "out"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "run_evaluate_torch.py"),
         "--dataset", "ssp3d", "--dataset_path", root, "--device", "cpu",
         "--batch_size", "2", "-N", "2", "--pose_shape_cfg", str(cfg),
         "--save_path", str(save), "--num_workers", "1"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stdout + out.stderr
    ssp3d = ["PVE-PA", "PVE-T-SC", "silhouette-IOU", "joints2D-L2E",
             "joints2Dsamples-L2E", "silhouettesamples-IOU"]
    printed = dict(line.split() for line in out.stdout.splitlines()
                   if len(line.split()) == 2 and line.split()[0] in ssp3d)
    assert sorted(printed) == sorted(ssp3d), out.stdout
    values = {k: float(v) for k, v in printed.items()}
    assert all(np.isfinite(v) for v in values.values())
    assert 0.0 <= values["silhouette-IOU"] <= 1.0
    assert 0.0 <= values["silhouettesamples-IOU"] <= 1.0
    assert list(np.load(save / "fname_per_frame.npy")) == [
        f"frame_{i:03d}.png" for i in range(4)]
    assert np.load(save / "pose_per_frame.npy").shape == (4, 24, 3, 3)
    assert "3x3 SVD of the pose head: jacobi" in out.stdout
