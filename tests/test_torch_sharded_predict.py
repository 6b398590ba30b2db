"""The port's sample-parallel predict core on the CPU against its 1-rank
core: every rank on the "sample" axis (JAX's cli/predict.py:194-202), the
sampler run on every lane on every rank and only the SMPL of the samples
split, uneven where N does not divide (5 over 2 ranks: 3 / 2; 6 over 4:
2 / 2 / 1 / 1).

Two 288 x 384 crops with their joints, a 48^2 proxy, EMBED_DIM 64,
weights from seed 0 and the sampler's draws from seed 4. Compared: the
per-vertex uncertainty (its mean vertices and distances summed over
"sample"), the mode mesh and the gathered sample meshes and joints, each
within max(1e-5, 10 x float32 floor) of its largest value: 1e-5 here, the
sums being only reordered. Then the CLI, `run_predict_torch.py
--num_devices 2 --no_vis` against --num_devices 1.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

B, D = 2, 48


def _inputs(num_samples, seed=0):
    rng = np.random.RandomState(seed)
    joints = np.stack([rng.rand(B, 17) * 200 + 44, rng.rand(B, 17) * 300 + 42], -1)
    return {"cfg": ["DATA.PROXY_REP_SIZE", D, "MODEL.EMBED_DIM", 64],
            "num_samples": num_samples, "seed": 4,
            "hr": torch.from_numpy(rng.rand(B, 3, 384, 288).astype(np.float32)),
            "joints2D": torch.from_numpy(joints.astype(np.float32)),
            "confs": torch.from_numpy(rng.rand(B, 17).astype(np.float32))}


@pytest.mark.parametrize("world, num_samples", [(2, 5), (4, 6)])
def test_sample_parallel_core_matches_one_rank(world, num_samples, tmp_path):
    inputs = _inputs(num_samples)
    ref = chip_smoke.par_predict_core(torch.device("cpu"), inputs)
    assert ref["verts_samples"].shape[:2] == (B, num_samples)
    outs = chip_smoke.run_ranks("predict", world, inputs, str(tmp_path),
                                threads=2, timeout=600)
    for rank, (got,) in enumerate(outs):
        worst = chip_smoke.compare_predict(
            f"predict core, sample {world}, N = {num_samples}, rank {rank}",
            ref, got)
        assert worst <= 1.0


def test_predict_ranks_match_one_device(tmp_path):
    """--no_vis --batch_size 2 on two demo photos, 5 samples over 2 ranks
    (3 / 2): outputs.npz equal to the 1-device run's within 1e-5."""
    image_dir = tmp_path / "imgs"
    image_dir.mkdir()
    for f in ("00000.png", "00003.png"):
        cv2.imwrite(str(image_dir / f), cv2.imread(os.path.join(REPO, "demo", f)))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("DATA:\n  PROXY_REP_SIZE: 48\nMODEL:\n  EMBED_DIM: 64\n")
    outs = {}
    for n in (1, 2):
        save = tmp_path / f"out{n}"
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "run_predict_torch.py"),
             "--image_dir", str(image_dir), "--save_dir", str(save),
             "--cropped_images", "--device", "cpu", "--batch_size", "2",
             "--no_vis", "--num_uncertainty_samples", "5", "--pose_shape_cfg",
             str(cfg), "--num_devices", str(n)],
            capture_output=True, text=True, cwd=str(tmp_path), timeout=600,
            env=dict(os.environ, OMP_NUM_THREADS="2"))
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
        outs[n] = dict(np.load(save / "outputs.npz"))
    assert sorted(outs[2]) == sorted(outs[1])
    assert list(outs[2]["fnames"]) == list(outs[1]["fnames"])
    for k, v in outs[1].items():
        if k != "fnames":
            np.testing.assert_allclose(outs[2][k], v, rtol=0,
                                       atol=1e-5 * np.abs(v).max(), err_msg=k)
