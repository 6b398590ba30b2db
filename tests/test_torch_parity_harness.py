"""run_parity_torch.py, the port's real-assets harness, on the CPU.

Without the assets it prints the checklist and PARITY SKIPPED and exits 0
(it never needs the card for that). With stand-ins for every asset (the
three SMPL files written from the synthetic SMPL arrays in the official
npz layout, a reference-layout checkpoint of random weights, a synthetic
SSP-3D folder) it evaluates through the port's evaluation CLI with the
LAPACK-sign SVD on two CPU ranks and diffs the metrics against a
reference JSON in the reference's units (millimetres for PVE/MPJPE): the
1-device run's own metrics pass, the same moved by 2 mm or 0.02 fail.
"""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
import run_parity_torch
from hierarchicalprobabilistic3dhuman_torch.models.smpl import synthetic_smpl_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parity(*args, env=None, cwd=REPO):
    return subprocess.run([sys.executable, os.path.join(REPO, "run_parity_torch.py"),
                           *args], capture_output=True, text=True, cwd=str(cwd),
                          timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="2", **(env or {})))


def test_skips_cleanly_without_assets(tmp_path):
    out = _parity("--pose_shape_weights", str(tmp_path / "none.tar"),
                  env={"HP3D_SMPL_DIR": str(tmp_path / "smpl"),
                       "HP3D_PW3D_PATH": str(tmp_path / "3dpw"),
                       "HP3D_SSP3D_PATH": str(tmp_path / "ssp3d")})
    assert out.returncode == 0, out.stderr
    assert "Asset checklist" in out.stdout and "MISSING" in out.stdout
    assert "PARITY SKIPPED" in out.stdout


def test_metric_units():
    assert run_parity_torch._is_mm("PVE-PA")
    assert run_parity_torch._is_mm("MPJPE-SC_samples_min")
    assert not run_parity_torch._is_mm("silhouette-IOU")
    assert not run_parity_torch._is_mm("joints2D-L2E")
    assert run_parity_torch._in_reference_units("PVE-T-SC", 0.0125) == 12.5
    assert run_parity_torch._in_reference_units("joints2Dsamples-L2E", 3.5) == 3.5


def _smpl_files(root):
    os.makedirs(root)
    for seed, gender in enumerate(("NEUTRAL", "MALE", "FEMALE")):
        a = synthetic_smpl_params(seed=seed)
        V = a["v_template"].shape[0]
        np.savez(os.path.join(root, f"SMPL_{gender}.npz"),
                 v_template=a["v_template"], shapedirs=a["shapedirs"],
                 posedirs=a["posedirs"].T.reshape(V, 3, -1),
                 J_regressor=a["J_regressor"], weights=a["lbs_weights"],
                 f=a["faces"].astype(np.uint32),
                 kintree_table=np.stack([np.arange(24) - 1, np.arange(24)]))
    return root


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("assets")
    images = [cv2.resize(cv2.cvtColor(cv2.imread(os.path.join(REPO, "demo", f)),
                                      cv2.COLOR_BGR2RGB), (96, 96))
              for f in sorted(os.listdir(os.path.join(REPO, "demo")))[:4]]
    cfg = tmp / "cfg.yaml"
    cfg.write_text("DATA:\n  PROXY_REP_SIZE: 48\n")
    return {"smpl": _smpl_files(str(tmp / "smpl")),
            "ssp3d": chip_smoke.write_ssp3d_folder(str(tmp / "ssp3d"), images),
            "weights": chip_smoke.reference_checkpoint(str(tmp / "model.tar")),
            "cfg": str(cfg), "tmp": tmp}


def _args(assets, *extra):
    return ["--pose_shape_weights", assets["weights"], "--pose_shape_cfg",
            assets["cfg"], "--ssp3d_path", assets["ssp3d"], "--batch_size", "2",
            "--num_samples", "2", "--num_workers", "0", "--device", "cpu",
            "--save_dir", str(assets["tmp"] / "runs"), *extra]


def test_two_ranks_against_reference_metrics(assets, monkeypatch):
    """The 1-device metrics as the reference's JSON: two ranks give PARITY
    OK; the JSON moved past either tolerance gives PARITY FAILED, exit 1."""
    from hierarchicalprobabilistic3dhuman_torch.configs import paths
    monkeypatch.setattr(paths, "SMPL", assets["smpl"])
    monkeypatch.setattr(paths, "PW3D_PATH", str(assets["tmp"] / "no_3dpw"))
    args = run_parity_torch.build_parser().parse_args(_args(assets, "--num_devices", "1"))
    checklist = run_parity_torch._asset_checklist(args)
    assert all(checklist[k] for k in ("smpl_neutral", "smpl_male", "smpl_female",
                                      "pose_shape_weights", "ssp3d"))
    ours = run_parity_torch._run_dataset_eval("ssp3d", assets["ssp3d"], args)
    assert len(ours) == 6 and all(np.isfinite(v) for v in ours.values())
    reference = {"ssp3d": {k: run_parity_torch._in_reference_units(k, float(v))
                           for k, v in ours.items()}}
    env = {"HP3D_SMPL_DIR": assets["smpl"],
           "HP3D_PW3D_PATH": str(assets["tmp"] / "no_3dpw")}
    good = assets["tmp"] / "reference.json"
    good.write_text(json.dumps(reference))
    out = _parity(*_args(assets, "--num_devices", "2", "--reference_metrics",
                         str(good)), env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "svd_impl=lapack" in out.stdout and "PARITY OK" in out.stdout

    moved = {"ssp3d": {k: v + (2.0 if run_parity_torch._is_mm(k) else 0.02)
                       for k, v in reference["ssp3d"].items()}}
    bad = assets["tmp"] / "moved.json"
    bad.write_text(json.dumps(moved))
    out = _parity(*_args(assets, "--num_devices", "2", "--reference_metrics",
                         str(bad)), env=env)
    assert out.returncode == 1, out.stdout[-3000:] + out.stderr[-3000:]
    assert "PARITY FAILED: 6 metric(s)" in out.stdout
