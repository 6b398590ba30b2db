"""The port's offline 3DPW preprocessing (data/pw3d_preprocess.py) against
the JAX package's on the CPU.

A synthetic sequence pkl in 3DPW's layout: 2 people (one male, one female)
over 3 frames, the second person's frame 1 without a valid camera pose,
small random poses, a moving camera, and smooth synthetic jpgs. Both
packages run their own synthetic SMPL with the same parameters (the JAX
package's, carried across). Held: 3dpw_test.npz's names and genders
exactly, the bbox centres and sizes within 1e-3 px (the SMPL vertices
agree to ~1e-6 m and project through a 500 px focal length), pose and shape
within 1e-5, and the PNG crops within 1 grey level: a bbox moved by 1e-3 px
moves the resampling grid by ~2e-4 of a pixel on images whose gradient is
at most ~2 levels a pixel, which can flip a rounding but no more.
"""

import os
import pickle
from dataclasses import fields

import cv2
import numpy as np
import pytest
import torch

from hierarchicalprobabilistic3dhuman_tpu.data.pw3d_preprocess import (
    pw3d_eval_extract as j_extract)
from hierarchicalprobabilistic3dhuman_tpu.models.smpl import SMPL as JSMPL

from hierarchicalprobabilistic3dhuman_torch.data.pw3d_preprocess import (
    pw3d_eval_extract as t_extract)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL as TSMPL, SMPLParams

torch.set_num_threads(2)

SEQ = "downtown_synthetic_00"
H, W = 240, 320
CROP_WH = 96


def write_sequence(root):
    rng = np.random.RandomState(8)
    F = 3
    poses = [(rng.randn(F, 72) * 0.2).astype(np.float64) for _ in range(2)]
    for p in poses:
        p[:, :3] = [np.pi, 0.0, 0.0] + 0.1 * rng.randn(F, 3)
    cam_poses = np.tile(np.eye(4), (F, 1, 1))
    for f in range(F):
        angle = 0.05 * f
        cam_poses[f, :3, :3] = cv2.Rodrigues(np.array([0.02, angle, 0.01]))[0]
        cam_poses[f, :3, 3] = [0.05 * f, 0.1, 6.0]
    data = {
        "sequence": SEQ,
        "poses": poses,
        "betas": [rng.randn(16) * 0.5 for _ in range(2)],
        "trans": [np.c_[[-0.6, 0.6][i] + 0.02 * np.arange(F), np.zeros(F),
                        np.zeros(F)] for i in range(2)],
        "cam_poses": cam_poses,
        "cam_intrinsics": np.array([[500.0, 0.0, W / 2], [0.0, 500.0, H / 2],
                                    [0.0, 0.0, 1.0]]),
        "genders": ["m", "f"],
        "campose_valid": [np.ones(F), np.array([1.0, 0.0, 1.0])],
    }
    os.makedirs(root / "sequenceFiles" / "test")
    with open(root / "sequenceFiles" / "test" / f"{SEQ}.pkl", "wb") as f:
        pickle.dump(data, f, protocol=2)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    os.makedirs(root / "imageFiles" / SEQ)
    for f in range(F):
        img = np.stack([xx * 0.6 + 20 * f, yy * 0.8,
                        100 + 60 * np.sin(xx / 40.0 + yy / 50.0 + f)], axis=-1)
        cv2.imwrite(str(root / "imageFiles" / SEQ / f"image_{f:05d}.jpg"),
                    np.clip(img, 0, 255).astype(np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("3dpw")
    write_sequence(root)
    jmodels = {"m": JSMPL.synthetic(seed=0), "f": JSMPL.synthetic(seed=1)}
    tmodels = {g: TSMPL(SMPLParams.from_numpy(
        {f.name: np.asarray(getattr(m.params, f.name)) for f in fields(SMPLParams)},
        "cpu")) for g, m in jmodels.items()}
    out = {}
    for name, extract, models in (("jax", j_extract, jmodels),
                                  ("port", t_extract, tmodels)):
        out_path = root / name
        os.makedirs(out_path / "cropped_frames")
        kwargs = {"device": "cpu"} if name == "port" else {}
        extract(str(root), str(out_path), crop_wh=CROP_WH, smpl_models=models,
                **kwargs)
        out[name] = out_path
    return out


def test_npz_matches_jax(outputs):
    j = np.load(outputs["jax"] / "3dpw_test.npz")
    t = np.load(outputs["port"] / "3dpw_test.npz")
    assert sorted(j.files) == sorted(t.files)
    assert list(t["imgname"]) == list(j["imgname"])
    assert len(t["imgname"]) == 5        # 3 + 2 valid frames
    assert list(t["gender"]) == list(j["gender"]) == ["m"] * 3 + ["f"] * 2
    errs = {k: float(np.abs(t[k] - j[k]).max()) for k in ("center", "wh", "pose", "shape")}
    print(f"3dpw_test.npz, port vs JAX max abs diffs: {errs}; wh "
          f"{t['wh'].round(2).tolist()} px")
    assert errs["center"] <= 1e-3 and errs["wh"] <= 1e-3
    assert errs["pose"] <= 1e-5 and errs["shape"] <= 1e-5
    assert (t["wh"] > 20).all() and (t["wh"] < 2 * H).all()


def test_crops_match_jax(outputs):
    names = sorted(os.listdir(outputs["jax"] / "cropped_frames"))
    assert names == sorted(os.listdir(outputs["port"] / "cropped_frames"))
    assert len(names) == 5
    worst = 0
    for name in names:
        j = cv2.imread(str(outputs["jax"] / "cropped_frames" / name)).astype(int)
        t = cv2.imread(str(outputs["port"] / "cropped_frames" / name)).astype(int)
        assert t.shape == (CROP_WH, CROP_WH, 3)
        assert t.std() > 1.0
        worst = max(worst, int(np.abs(t - j).max()))
    print(f"crops: max abs diff {worst} grey levels")
    assert worst <= 1
