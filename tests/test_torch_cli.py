"""The port's CLI on a demo photo, its refusal to run without the card it
was asked for, and the rule that it imports nothing of JAX."""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

REPO =os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "hierarchicalprobabilistic3dhuman_torch"
D, WH, N = 64, 64, 4


def test_cli_on_a_demo_photo(tmp_path):
    """run_predict_torch.py --device cpu on one demo photo at small sizes."""
    image_dir = tmp_path / "imgs"
    image_dir.mkdir()
    img = cv2.imread(os.path.join(REPO, "demo", "00007.png"))
    cv2.imwrite(str(image_dir / "00007.png"), img)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"DATA:\n  PROXY_REP_SIZE: {D}\n")
    save_dir = tmp_path / "out"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "run_predict_torch.py"),
         "--image_dir", str(image_dir), "--save_dir", str(save_dir),
         "--cropped_images", "--device", "cpu", "--visualise_wh", str(WH),
         "--num_uncertainty_samples", str(N), "--pose_shape_cfg", str(cfg)],
        check=True, cwd=str(tmp_path), timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    fig = cv2.imread(str(save_dir / "00007.png"))
    assert fig is not None and fig.shape == (2 * WH, 4 * WH, 3)
    assert np.isfinite(fig).all() and fig.std() > 1.0
    # the rendered views (right half) hold a body
    assert (fig[:, 2 * WH:] > 0).mean() > 0.01


def test_cuda_is_never_replaced_by_the_cpu(tmp_path):
    from hierarchicalprobabilistic3dhuman_torch.cli.predict import main
    from hierarchicalprobabilistic3dhuman_torch.utils.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--image_dir", REPO, "--save_dir", REPO, "--cropped_images"])
    from hierarchicalprobabilistic3dhuman_torch.cli.train import main as train_main
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(["-E", str(tmp_path / "exp")])
    assert not (tmp_path / "exp").exists()


def test_port_imports_nothing_of_jax():
    """Every module of the port (the evaluation and training slices', the
    checkpoint codec and the parallel layer included), the entry scripts
    with run_parity_torch.py and chip_smoke.py, imported in a fresh
    interpreter, load neither jax/flax/optax/msgpack nor the JAX
    package."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {REPO!r})
import {PORT}
names = [m.name for m in pkgutil.walk_packages({PORT}.__path__, "{PORT}.")]
for name in names + ["run_predict_torch", "run_evaluate_torch",
                     "run_train_torch", "run_parity_torch", "chip_smoke"]:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "optax", "msgpack",
        "hierarchicalprobabilistic3dhuman_tpu")]
print(len(names), bad)
evaluation = ["cli.evaluate", "evaluate.evaluate_pose_mf_shape_gaussian_net",
              "metrics.metric_sums", "metrics.eval_metrics_tracker",
              "ops.lapack_svd3", "utils.eval_utils", "data.loader",
              "data.crop_utils_np", "data.ssp3d_eval_dataset",
              "data.pw3d_eval_dataset"]
training = ["cli.train", "train.train_pose_mf_shape_gaussian_net",
            "losses.matrix_fisher_loss", "ops.matrix_fisher",
            "utils.augmentation.smpl_augmentation",
            "utils.augmentation.cam_augmentation",
            "utils.augmentation.lighting_augmentation",
            "utils.augmentation.proxy_rep_augmentation",
            "utils.augmentation.rgb_augmentation", "utils.random_draws",
            "metrics.train_loss_and_metrics_tracker", "runtime.checkpointing",
            "data.on_the_fly_smpl_train_dataset"]
checkpoints = ["runtime.flax_msgpack", "models.resnet", "models.weights"]
parallel = ["parallel", "parallel.mesh", "parallel.sharded_train",
            "parallel.launch"]
missing = [m for m in evaluation + training + checkpoints + parallel
           if "{PORT}." + m not in names]
assert len(names) >= 50 and not missing and not bad, (missing, bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr


def test_more_cards_than_visible_raise(tmp_path, monkeypatch):
    """--num_devices 2 where torch sees one card: each CLI raises before it
    starts a rank."""
    from hierarchicalprobabilistic3dhuman_torch.cli import evaluate, predict, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    match = "2 cuda devices were asked for but torch sees 1"
    with pytest.raises(RuntimeError, match=match):
        train.main(["-E", str(tmp_path / "exp"), "--num_devices", "2"])
    assert not (tmp_path / "exp").exists()
    with pytest.raises(RuntimeError, match=match):
        evaluate.main(["--dataset", "ssp3d", "--num_devices", "2",
                       "--batch_size", "2"])
    with pytest.raises(RuntimeError, match=match):
        predict.main(["--image_dir", str(tmp_path), "--save_dir", str(tmp_path),
                      "--num_devices", "2"])


@pytest.mark.parametrize("flags", [["--num_devices", "2", "--batch_size", "3"],
                                   ["--num_devices", "4", "--sample_parallel", "2",
                                    "--batch_size", "1"]])
def test_eval_batch_must_divide_data_axis(flags):
    """A batch size that does not divide the data axis raises (JAX's CLI
    quietly evaluates on one device instead)."""
    from hierarchicalprobabilistic3dhuman_torch.cli import evaluate
    with pytest.raises(ValueError, match="must divide the mesh data axis"):
        evaluate.main(["--dataset", "ssp3d", "--device", "cpu", *flags])
