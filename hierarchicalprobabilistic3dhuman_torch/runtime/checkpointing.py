"""Training checkpoints in the reference's layout.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/runtime/checkpointing.py
(checkpoint_path :35, save_training_checkpoint :40, load_training_checkpoint
:56, load_training_info_from_checkpoint :61). The file is the reference's
own: a torch.save of {epoch, best_epoch, best_epoch_val_metrics,
model_state_dict, best_model_state_dict, optimiser_state_dict} with the
state dicts under the reference checkpoint's key names, at
saved_models/epoch_{N:03d}.tar. models/weights.py::load_predictor_state_dict
then loads it strict=True. The JAX package's own checkpoints (pickled flax
pytrees and optax state) are not read.
"""

import os

import torch

from hierarchicalprobabilistic3dhuman_torch.models.weights import load_checkpoint


def checkpoint_path(model_save_dir, epoch):
    """The reference's naming: epoch_{N:03d}.tar."""
    return os.path.join(model_save_dir, f"epoch_{epoch:03d}.tar")


def state_dict_on_cpu(module):
    """A copy of a module's state dict on the CPU (for best weights and
    checkpoints)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}


def save_training_checkpoint(path, *, epoch, best_epoch, best_epoch_val_metrics,
                             model_state_dict, best_model_state_dict,
                             optimiser_state_dict):
    """Write the reference's training checkpoint dict with torch.save."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({
        "epoch": int(epoch),
        "best_epoch": int(best_epoch),
        "best_epoch_val_metrics": {k: float(v)
                                   for k, v in best_epoch_val_metrics.items()},
        "model_state_dict": model_state_dict,
        "best_model_state_dict": best_model_state_dict,
        "optimiser_state_dict": optimiser_state_dict,
    }, path)


def load_training_checkpoint(path):
    """A training checkpoint's dict, its tensors on the CPU."""
    return load_checkpoint(path)


def load_training_info_from_checkpoint(checkpoint, save_val_metrics):
    """Resume bookkeeping: start epoch, best epoch, best model weights and
    best metric values, a save metric the checkpoint lacks reset to inf."""
    current_epoch = checkpoint["epoch"] + 1
    best_epoch = checkpoint["best_epoch"]
    best_model_wts = checkpoint["best_model_state_dict"]
    best_epoch_val_metrics = {}
    for metric in save_val_metrics:
        if metric in checkpoint["best_epoch_val_metrics"]:
            best_epoch_val_metrics[metric] = checkpoint["best_epoch_val_metrics"][metric]
        else:
            print(f"{metric} not in best_epoch_val_metrics — resetting to inf.")
            best_epoch_val_metrics[metric] = float("inf")
    return current_epoch, best_epoch, best_model_wts, best_epoch_val_metrics
