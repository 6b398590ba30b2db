"""Offline loss/metric curve plotting from log.pkl files
(reference: utils/plot_loss_curves.py:7-42).

A copy of hierarchicalprobabilistic3dhuman_tpu/utils/plot_loss_curves.py,
which imports no JAX; it reads the log.pkl that the port's training tracker
writes (metrics/train_loss_and_metrics_tracker.py). Needs matplotlib.

Usage: python -m hierarchicalprobabilistic3dhuman_torch.utils.plot_loss_curves \
           --experiment_dirs exp1 exp2 --metrics losses PVE-SC MPJPE-PA
"""

import argparse
import os
import pickle


def plot_loss_curves(experiment_dirs, metrics=("losses",), save_path=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(metrics), 1, figsize=(10, 4 * len(metrics)),
                             squeeze=False)
    for ax, metric in zip(axes[:, 0], metrics):
        for exp_dir in experiment_dirs:
            with open(os.path.join(exp_dir, "log.pkl"), "rb") as f:
                history = pickle.load(f)
            label = os.path.basename(os.path.normpath(exp_dir))
            for split in ("train", "val"):
                key = f"{split}_{metric}"
                if key in history and len(history[key]):
                    ax.plot(history[key], label=f"{label} {split}")
        ax.set_title(metric)
        ax.set_xlabel("epoch")
        ax.legend()
    fig.tight_layout()
    save_path = save_path or "loss_curves.png"
    fig.savefig(save_path, dpi=120)
    print(f"Saved {save_path}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment_dirs", "-E", nargs="+", required=True)
    parser.add_argument("--metrics", "-M", nargs="+", default=["losses"])
    parser.add_argument("--save_path", "-S", type=str, default=None)
    args = parser.parse_args()
    plot_loss_curves(args.experiment_dirs, args.metrics, args.save_path)
