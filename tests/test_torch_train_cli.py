"""The port's training entry point on the CPU: run_train_torch.py end to
end (one epoch of each loss stage), the loop's resume, the checkpoint file
(the reference's dict, loaded strict=True by the predict/eval loader) and
the log.pkl tracker against the JAX package's."""

import os
import pickle
import subprocess
import sys

import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_tpu.metrics.train_loss_and_metrics_tracker import (
    TrainingLossesAndMetricsTracker as JTracker)
from hierarchicalprobabilistic3dhuman_tpu.runtime import checkpointing as jckpt

from hierarchicalprobabilistic3dhuman_torch.configs import get_pose_shape_cfg_defaults
from hierarchicalprobabilistic3dhuman_torch.metrics import (
    TrainingLossesAndMetricsTracker as TTracker)
from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
    CannyEdgeDetector)
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    load_predictor_state_dict)
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer)
from hierarchicalprobabilistic3dhuman_torch.runtime import checkpointing as tckpt
from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
    train_pose_mf_shape_gaussian_net)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_KEYS = {"epoch", "best_epoch", "best_epoch_val_metrics", "model_state_dict",
             "best_model_state_dict", "optimiser_state_dict"}
METRICS = ['PVE', 'PVE-SC', 'PVE-T-SC', 'MPJPE', 'MPJPE-SC', 'MPJPE-PA',
           'joints2D-L2E']


def test_run_train_torch_both_stages_on_cpu(tmp_path):
    """run_train_torch.py --device cpu at 32^2, TRAIN.BATCH_SIZE 2, EMBED_DIM
    64: epoch 0 in stage 1, epoch 1 in stage 2, on the synthetic fallback
    (64 train and 32 val poses). log.pkl holds 2 epochs of finite losses,
    stage 2 tracks joints2Dsamples-L2E, and epoch_000.tar is the
    reference's dict, which load_predictor_state_dict loads strict=True."""
    exp = tmp_path / "exp"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "run_train_torch.py"), "-E", str(exp),
         "--device", "cpu", "--num_epochs", "2", "-O", "DATA.PROXY_REP_SIZE", "32",
         "TRAIN.BATCH_SIZE", "2", "LOSS.STAGE_CHANGE_EPOCH", "1",
         "MODEL.EMBED_DIM", "64", "TRAIN.NUM_WORKERS", "0"],
        check=True, cwd=str(tmp_path), timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    with open(exp / "log.pkl", "rb") as f:
        log = pickle.load(f)
    assert len(log["train_losses"]) == len(log["val_losses"]) == 2
    assert all(np.isfinite(log[k]).all() for k in log)
    assert log["train_joints2Dsamples-L2E"][0] == 0.0
    assert log["train_joints2Dsamples-L2E"][1] > 0.0
    ckpt = tckpt.load_training_checkpoint(str(exp / "saved_models" / "epoch_000.tar"))
    assert set(ckpt) == CKPT_KEYS and ckpt["epoch"] == 0
    model = PoseMFShapeGaussianNet(embed_dim=64)
    model.load_state_dict(load_predictor_state_dict(
        str(exp / "saved_models" / "epoch_000.tar"), model), strict=True)
    assert (exp / "encoder_precision.txt").read_text() == "float32"


class _Loaders:
    """One batch a split, from a seed."""

    def __init__(self, D, B=2):
        rng = np.random.RandomState(0)
        self.batch = {"pose": (rng.randn(B, 72) * 0.3).astype(np.float32),
                      "background": (rng.rand(B, 3, D, D) * 255).astype(np.uint8),
                      "texture": (rng.rand(B, 40, 30, 3) * 255).astype(np.uint8)}

    def __getitem__(self, split):
        return [self.batch]


def test_training_loop_resumes(tmp_path):
    """Two epochs of the loop (one step a split each), then a resume from
    epoch 0's checkpoint as the CLI does it: epoch 1 runs again, log.pkl
    keeps 2 epochs with epoch 0's values, and the optimiser resumes at its
    saved step."""
    cfg = get_pose_shape_cfg_defaults()
    D = 32
    cfg.DATA.PROXY_REP_SIZE = D
    cfg.MODEL.EMBED_DIM = 64
    cfg.LOSS.STAGE_CHANGE_EPOCH = 1
    cfg.TRAIN.EPOCHS_PER_SAVE = 1
    dev = torch.device("cpu")
    parts = dict(pose_shape_cfg=cfg, smpl_model=SMPL.synthetic(dev),
                 edge_detect_model=CannyEdgeDetector(dev),
                 renderer=TexturedIUVRenderer(dev, img_wh=D,
                                              projection_type="perspective",
                                              render_rgb=True),
                 train_dataset=None, val_dataset=None, metrics=METRICS,
                 model_save_dir=str(tmp_path), device=dev,
                 logs_save_path=str(tmp_path / "log.pkl"), loaders=_Loaders(D),
                 num_epochs=2)

    def run(checkpoint=None):
        model = PoseMFShapeGaussianNet(embed_dim=64)
        optimizer = torch.optim.Adam(model.parameters(), lr=1e-4)
        if checkpoint is not None:
            model.load_state_dict(checkpoint["model_state_dict"])
            optimizer.load_state_dict(checkpoint["optimiser_state_dict"])
        train_pose_mf_shape_gaussian_net(pose_shape_model=model,
                                         optimizer=optimizer,
                                         checkpoint=checkpoint, **parts)
        with open(tmp_path / "log.pkl", "rb") as f:
            return pickle.load(f), optimizer

    first, _ = run()
    ckpt = tckpt.load_training_checkpoint(tckpt.checkpoint_path(str(tmp_path), 0))
    assert set(ckpt) == CKPT_KEYS
    resumed, optimizer = run(ckpt)
    assert len(resumed["train_losses"]) == 2
    assert resumed["train_losses"][0] == first["train_losses"][0]
    assert np.isfinite(resumed["train_losses"][1])
    steps = {float(s["step"]) for s in optimizer.state_dict()["state"].values()}
    assert steps == {2.0}
    assert tckpt.load_training_checkpoint(
        tckpt.checkpoint_path(str(tmp_path), 1))["epoch"] == 1


def test_tracker_and_checkpoint_info_match_jax(tmp_path):
    """The tracker's per-epoch means from the same per-batch sums, log.pkl's
    keys and values, resume truncation (with a metric missing from an old
    log zero-filled) against JAX's load_history, the host path's per-batch
    sums of every metric family (within 1e-4 relative), and the resume
    bookkeeping of a checkpoint against JAX's
    load_training_info_from_checkpoint."""
    rng = np.random.RandomState(3)
    trackers = {}
    for name, cls in (("jax", JTracker), ("port", TTracker)):
        tr = cls(list(METRICS), img_wh=32, log_save_path=str(tmp_path / f"{name}.pkl"))
        for epoch in range(3):
            if epoch == 2:
                tr.metrics_to_track.append("joints2Dsamples-L2E")
            tr.initialise_loss_metric_sums()
            r = np.random.RandomState(epoch)
            for split in ("train", "val"):
                for _ in range(2):
                    sums = {m: float(r.rand()) for m in tr.metrics_to_track}
                    sums["num_visib_joints2Dsamples"] = 30.0
                    tr.update_per_batch_sums(split, float(r.rand()), 2, sums)
            tr.update_per_epoch()
        trackers[name] = tr
    with open(tmp_path / "jax.pkl", "rb") as f:
        jlog = pickle.load(f)
    with open(tmp_path / "port.pkl", "rb") as f:
        tlog = pickle.load(f)
    assert jlog == tlog
    del tlog["val_PVE-T"]                          # an old log without it
    with open(tmp_path / "old.pkl", "wb") as f:
        pickle.dump(tlog, f)
    j = JTracker(METRICS, 32, None).load_history(str(tmp_path / "old.pkl"), 2)
    t = TTracker(METRICS, 32, None).load_history(str(tmp_path / "old.pkl"), 2)
    assert j == t and t["val_PVE-T"] == [0.0, 0.0]
    assert (trackers["port"].determine_save_model_weights_this_epoch(
        ["PVE-SC"], {"PVE-SC": 1.0})
        == trackers["jax"].determine_save_model_weights_this_epoch(
            ["PVE-SC"], {"PVE-SC": 1.0}))

    # The host path: the same per-batch sums from fetched arrays.
    B, N = 2, 3
    pred = {"verts": rng.randn(B, 6890, 3), "joints3D": rng.randn(B, 14, 3),
            "joints2D": rng.rand(B, 17, 2) * 2 - 1,
            "joints2Dsamples": rng.rand(B, N, 17, 2) * 2 - 1}
    target = {"verts": rng.randn(B, 6890, 3), "joints3D": rng.randn(B, 14, 3),
              "joints2D": rng.rand(B, 17, 2) * 32, "joints2D_vis": rng.rand(B, 17) > 0.3}
    reposed = (rng.randn(B, 6890, 3), rng.randn(B, 6890, 3))
    pred, target = ({k: v.astype(np.float32) if v.dtype == np.float64 else v
                     for k, v in d.items()} for d in (pred, target))
    reposed = [a.astype(np.float32) for a in reposed]
    all_metrics = [m[len("train_"):] for m in JTracker(METRICS, 32, None).all_metrics_types
                   if m.startswith("train_")]
    sums = []
    for cls in (JTracker, TTracker):
        tr = cls(all_metrics, img_wh=32, log_save_path=None)
        tr.initialise_loss_metric_sums()
        tr.update_per_batch("val", 0.5, pred, target, B, *reposed)
        sums.append(tr.loss_metric_sums)
    assert sums[0].keys() == sums[1].keys()
    for k in sums[0]:
        assert abs(sums[0][k] - sums[1][k]) <= 1e-4 * max(abs(sums[0][k]), 1.0), k

    ckpt = {"epoch": 4, "best_epoch": 2, "best_epoch_val_metrics": {"PVE-SC": 0.3},
            "best_model_state_dict": {}}
    jinfo = jckpt.load_training_info_from_checkpoint(ckpt, ["PVE-SC", "MPJPE-PA"])
    tinfo = tckpt.load_training_info_from_checkpoint(ckpt, ["PVE-SC", "MPJPE-PA"])
    assert jinfo == tinfo and tinfo[3]["MPJPE-PA"] == np.inf
    assert (tckpt.checkpoint_path("d", 7) == jckpt.checkpoint_path("d", 7)
            == os.path.join("d", "epoch_007.tar"))
