"""The port's training entry point fed by the native input pipeline on the
CPU: stores packed by the port's pack_training_stores (train/ and val/,
each with three different record counts), then `run_train_torch.py
--device cpu --native_data_dir` at 32^2, B = 2, EMBED_DIM 64 for 2 epochs
(stage 1, then stage 2): n_poses // B steps an epoch in each split, finite
log.pkl values, and utils/plot_loss_curves.py drawing that log.pkl."""

import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_torch.cli.train import main as train_main
from hierarchicalprobabilistic3dhuman_torch.train import (
    train_pose_mf_shape_gaussian_net as driver)

torch.set_num_threads(2)

# poses, (grey, non-grey) atlases, backgrounds a split
SPLITS = {"train": (8, (1, 2), 5), "val": (4, (1, 2), 2)}
B = 2


def small_stores(root, img_wh=32):
    """Packed train/ and val/ stores under root/stores (60 x 40 atlases,
    48 x 64 jpgs), with the record counts of SPLITS."""
    for i, (split, (n_poses, (grey, nongrey), n_bgs)) in enumerate(SPLITS.items()):
        sources = chip_smoke.write_train_sources(
            os.path.join(root, f"sources_{split}"), n_poses, grey, nongrey, n_bgs,
            texture_hw=(60, 40), background_hw=(48, 64), seed=i)
        chip_smoke.pack_split(os.path.join(root, "stores", split), sources, img_wh)
    return os.path.join(root, "stores")


def small_train_argv(exp, stores, epochs):
    return ["-E", exp, "--device", "cpu", "--num_epochs", str(epochs),
            "--native_data_dir", stores, "-O", "DATA.PROXY_REP_SIZE", "32",
            "TRAIN.BATCH_SIZE", str(B), "LOSS.STAGE_CHANGE_EPOCH", "1",
            "MODEL.EMBED_DIM", "64"]


@pytest.fixture(scope="module")
def native_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_train")
    stores = small_stores(str(root))
    steps = {True: 0, False: 0}
    call = driver.TrainStep.__call__

    def counted(self, *args, **kwargs):
        steps[self.train] += 1
        return call(self, *args, **kwargs)

    exp = str(root / "exp")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver.TrainStep, "__call__", counted)
        train_main(small_train_argv(exp, stores, epochs=2))
    return exp, stores, steps


def test_native_training_cli(native_run):
    exp, stores, steps = native_run
    counts = {split: [int(np.load(os.path.join(stores, split, f + ".meta.npy"),
                                  allow_pickle=True).item()["shape"][0])
                      for f in ("poses.bin", "textures.bin", "backgrounds.bin")]
              for split in SPLITS}
    assert counts == {"train": [8, 3, 5], "val": [4, 3, 2]}
    assert steps == {True: 2 * (8 // B), False: 2 * (4 // B)}
    with open(os.path.join(exp, "log.pkl"), "rb") as f:
        log = pickle.load(f)
    assert len(log["train_losses"]) == len(log["val_losses"]) == 2
    assert all(np.isfinite(log[k]).all() for k in log)
    assert "train_joints2Dsamples-L2E" in log
    assert os.path.exists(os.path.join(exp, "saved_models", "epoch_000.tar"))


def test_plot_loss_curves_draws_the_ports_log(native_run, tmp_path):
    import cv2
    from hierarchicalprobabilistic3dhuman_torch.utils.plot_loss_curves import (
        plot_loss_curves)
    exp, _, _ = native_run
    path = str(tmp_path / "curves.png")
    plot_loss_curves([exp], metrics=("losses", "PVE-SC"), save_path=path)
    img = cv2.imread(path)
    assert img is not None and img.shape[0] > 100 and img.std() > 1.0
