"""Evaluation metrics tracker — same metric set, normalisation and artifact
formats as the reference (metrics/eval_metrics_tracker.py:7-368).

Counterpart of hierarchicalprobabilistic3dhuman_tpu/metrics/
eval_metrics_tracker.py, line for line. The host path (update_per_batch)
takes numpy arrays and runs the alignments through the port's torch
functions on the CPU; update_per_batch_device takes the per-frame values
of metrics/metric_sums.py.

Mode metrics: PVE / PVE-SC / PVE-PA / PVE-T / PVE-T-SC / MPJPE(-SC/-PA) /
joints2D-L2E / silhouette-IOU. Sample metrics: `<m>_samples_min` (best of N
samples) and joints2Dsamples-L2E / silhouettesamples-IOU (mean over N).
Final 3D metrics print in millimetres (x1000); per-frame metrics save as
`<metric>_per_frame.npy`. Unlike the reference, sample-min metrics accept
batch size > 1. On a parallel Mesh the sharded eval step hands every rank
the global batch's per-frame values in frame order and its sample sums
summed over the world (parallel/sharded_train.py::gather_rows), so every
rank's tracker holds the same sums and ordered lists; the driver lets
rank 0 alone save them.
"""

import os

import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.metrics.metric_sums import align

# metric family -> (pred key, target key, alignment, points per example)
_POINT_METRICS = {
    "PVE": ("verts", "verts", None, 6890),
    "PVE-SC": ("verts", "verts", "sc", 6890),
    "PVE-PA": ("verts", "verts", "pa", 6890),
    "PVE-T": ("reposed_verts", "reposed_verts", None, 6890),
    "PVE-T-SC": ("reposed_verts", "reposed_verts", "sc", 6890),
    "MPJPE": ("joints3D", "joints3D", None, 14),
    "MPJPE-SC": ("joints3D", "joints3D", "sc", 14),
    "MPJPE-PA": ("joints3D", "joints3D", "pa", 14),
}
_SAMPLES_KEY = {
    "PVE": "verts_samples", "PVE-SC": "verts_samples", "PVE-PA": "verts_samples",
    "PVE-T": "reposed_verts_samples", "PVE-T-SC": "reposed_verts_samples",
    "MPJPE": "joints3D_samples", "MPJPE-SC": "joints3D_samples",
    "MPJPE-PA": "joints3D_samples",
}


def _align(pred, target, mode):
    """numpy pred aligned to numpy target, through the port's functions."""
    if mode is None:
        return pred
    return align(torch.from_numpy(np.asarray(pred)),
                 torch.from_numpy(np.asarray(target)), mode).numpy()


class EvalMetricsTracker:
    def __init__(self, metrics_to_track, img_wh=None, save_path=None,
                 save_per_frame_metrics=False):
        self.metrics_to_track = metrics_to_track
        self.img_wh = img_wh
        self.save_path = save_path
        self.save_per_frame_metrics = save_per_frame_metrics
        self.metric_sums = None
        self.total_samples = 0

    def initialise_metric_sums(self):
        self.metric_sums = {}
        for metric_type in self.metrics_to_track:
            if metric_type == "silhouette-IOU":
                for k in ("num_true_positives", "num_false_positives",
                          "num_true_negatives", "num_false_negatives"):
                    self.metric_sums[k] = 0.0
            elif metric_type == "silhouettesamples-IOU":
                for k in ("num_samples_true_positives", "num_samples_false_positives",
                          "num_samples_true_negatives", "num_samples_false_negatives"):
                    self.metric_sums[k] = 0.0
            elif metric_type == "joints2Dsamples-L2E":
                self.metric_sums["num_vis_joints2Dsamples"] = 0.0
                self.metric_sums[metric_type] = 0.0
            else:
                self.metric_sums[metric_type] = 0.0

    def initialise_per_frame_metric_lists(self):
        self.per_frame_metrics = {m: [] for m in self.metrics_to_track}

    def _update_point_metric(self, name, pred, target, mode):
        pred_aligned = _align(np.asarray(pred), np.asarray(target), mode)
        err = np.linalg.norm(pred_aligned - np.asarray(target), axis=-1)  # (B, P)
        self.metric_sums[name] += float(np.sum(err))
        self.per_frame_metrics[name].append(np.mean(err, axis=-1))

    def _update_samples_min_metric(self, name, base, pred_samples, target, mode):
        """Best-of-N sample metric; batched over B (reference asserts B == 1)."""
        pred_samples = np.asarray(pred_samples)   # (B, N, P, 3)
        target = np.asarray(target)               # (B, P, 3)
        B, N = pred_samples.shape[:2]
        flat = pred_samples.reshape(B * N, *pred_samples.shape[2:])
        tiled = np.repeat(target[:, None], N, axis=1).reshape(B * N, *target.shape[1:])
        aligned = _align(flat, tiled, mode)
        err = np.linalg.norm(aligned - tiled, axis=-1).reshape(B, N, -1)  # (B, N, P)
        best = np.argmin(err.mean(axis=-1), axis=1)                        # (B,)
        best_err = err[np.arange(B), best]                                 # (B, P)
        self.metric_sums[name] += float(np.sum(best_err))
        self.per_frame_metrics[name].append(np.mean(best_err, axis=-1))

    @staticmethod
    def _confusion(pred_sil, target_sil):
        pred = np.asarray(pred_sil).astype(bool)
        target = np.asarray(target_sil).astype(bool)
        tp = np.logical_and(pred, target)
        fp = np.logical_and(pred, ~target)
        tn = np.logical_and(~pred, ~target)
        fn = np.logical_and(~pred, target)
        return tp, fp, tn, fn

    def update_per_batch(self, pred_dict, target_dict, num_input_samples,
                         return_transformed_points=False,
                         return_per_frame_metrics=False):
        self.total_samples += num_input_samples
        per_frame_return = {} if return_per_frame_metrics else None

        for metric_type in self.metrics_to_track:
            if metric_type in _POINT_METRICS:
                pk, tk, mode, _ = _POINT_METRICS[metric_type]
                self._update_point_metric(metric_type, pred_dict[pk],
                                          target_dict[tk], mode)
                if return_per_frame_metrics:
                    per_frame_return[metric_type] = self.per_frame_metrics[metric_type][-1]

            elif metric_type.endswith("_samples_min"):
                base = metric_type[:-len("_samples_min")]
                pk, tk, mode, _ = _POINT_METRICS[base]
                self._update_samples_min_metric(metric_type, base,
                                                pred_dict[_SAMPLES_KEY[base]],
                                                target_dict[tk], mode)

            elif metric_type == "joints2D-L2E":
                err = np.linalg.norm(np.asarray(pred_dict["joints2D"])
                                     - np.asarray(target_dict["joints2D"]), axis=-1)
                self.metric_sums[metric_type] += float(np.sum(err))
                self.per_frame_metrics[metric_type].append(np.mean(err, axis=-1))
                if return_per_frame_metrics:
                    per_frame_return[metric_type] = self.per_frame_metrics[metric_type][-1]

            elif metric_type == "joints2Dsamples-L2E":
                pred = np.asarray(pred_dict["joints2Dsamples"])  # (B, N, 17, 2)
                target = np.repeat(np.asarray(target_dict["joints2D"])[:, None],
                                   pred.shape[1], axis=1)
                err = np.linalg.norm(pred - target, axis=-1)      # (B, N, 17)
                if "joints2D_vis" in target_dict:
                    vis = np.repeat(np.asarray(target_dict["joints2D_vis"])[:, None],
                                    pred.shape[1], axis=1)
                    err = err[vis]
                err = err.reshape(-1)
                self.metric_sums[metric_type] += float(np.sum(err))
                self.metric_sums["num_vis_joints2Dsamples"] += err.shape[0]

            elif metric_type == "silhouette-IOU":
                tp, fp, tn, fn = self._confusion(pred_dict["silhouettes"],
                                                 target_dict["silhouettes"])
                num_tp = tp.sum(axis=(1, 2))
                num_fp = fp.sum(axis=(1, 2))
                num_fn = fn.sum(axis=(1, 2))
                self.metric_sums["num_true_positives"] += float(num_tp.sum())
                self.metric_sums["num_false_positives"] += float(num_fp.sum())
                self.metric_sums["num_true_negatives"] += float(tn.sum())
                self.metric_sums["num_false_negatives"] += float(num_fn.sum())
                iou = num_tp / (num_tp + num_fp + num_fn)
                self.per_frame_metrics[metric_type].append(iou)
                if return_per_frame_metrics:
                    per_frame_return[metric_type] = iou

            elif metric_type == "silhouettesamples-IOU":
                pred = np.asarray(pred_dict["silhouettessamples"])  # (B, N, wh, wh)
                target = np.repeat(np.asarray(target_dict["silhouettes"])[:, None],
                                   pred.shape[1], axis=1)
                tp, fp, tn, fn = self._confusion(pred, target)
                self.metric_sums["num_samples_true_positives"] += float(tp.sum())
                self.metric_sums["num_samples_false_positives"] += float(fp.sum())
                self.metric_sums["num_samples_true_negatives"] += float(tn.sum())
                self.metric_sums["num_samples_false_negatives"] += float(fn.sum())

        return None, per_frame_return

    def update_per_batch_device(self, frame_metrics, num_input_samples):
        """Accumulate from ON-DEVICE per-frame metrics (metric_sums.
        make_eval_frame_metrics_fn) instead of fetched tensors: point metrics
        arrive as (B,) per-frame mean errors, IOUs as per-frame confusion
        counts, joints2Dsamples-L2E as scalar sums. Numerically identical to
        update_per_batch (pinned by tests/test_eval_driver.py) but the host
        fetch per batch is a few KB instead of the full vertex/sample/
        silhouette tensors."""
        self.total_samples += num_input_samples
        for metric_type in self.metrics_to_track:
            if metric_type == "silhouette-IOU":
                for k in ("num_true_positives", "num_false_positives",
                          "num_true_negatives", "num_false_negatives"):
                    self.metric_sums[k] += float(np.sum(frame_metrics[k]))
                self.per_frame_metrics[metric_type].append(
                    np.asarray(frame_metrics[metric_type]))
            elif metric_type == "silhouettesamples-IOU":
                for k in ("num_samples_true_positives",
                          "num_samples_false_positives",
                          "num_samples_true_negatives",
                          "num_samples_false_negatives"):
                    self.metric_sums[k] += float(frame_metrics[k])
            elif metric_type == "joints2Dsamples-L2E":
                self.metric_sums[metric_type] += float(frame_metrics[metric_type])
                self.metric_sums["num_vis_joints2Dsamples"] += \
                    float(frame_metrics["num_vis_joints2Dsamples"])
            else:
                per_frame = np.asarray(frame_metrics[metric_type])
                if "PVE" in metric_type:
                    num_points = 6890
                elif "MPJPE" in metric_type:
                    num_points = 14
                else:  # joints2D-L2E
                    num_points = 17
                self.metric_sums[metric_type] += \
                    float(np.sum(per_frame)) * num_points
                self.per_frame_metrics[metric_type].append(per_frame)

    def compute_final_metrics(self, frame_order=None):
        """frame_order: optional permutation applied to the per-frame metric
        arrays before saving (the eval driver iterates gender-sorted, then
        restores dataset order here). Metric sums are order-invariant."""
        final_metrics = {}
        for metric_type in self.metrics_to_track:
            mult = 1.0
            if metric_type == "silhouette-IOU":
                s = self.metric_sums
                final_metrics[metric_type] = s["num_true_positives"] / (
                    s["num_true_positives"] + s["num_false_negatives"]
                    + s["num_false_positives"])
            elif metric_type == "silhouettesamples-IOU":
                s = self.metric_sums
                final_metrics[metric_type] = s["num_samples_true_positives"] / (
                    s["num_samples_true_positives"] + s["num_samples_false_negatives"]
                    + s["num_samples_false_positives"])
            elif metric_type == "joints2Dsamples-L2E":
                final_metrics[metric_type] = (self.metric_sums[metric_type]
                                              / max(self.metric_sums["num_vis_joints2Dsamples"], 1))
            else:
                if "PVE" in metric_type:
                    num_per_sample = 6890
                    mult = 1000.0
                elif "MPJPE" in metric_type:
                    num_per_sample = 14
                    mult = 1000.0
                elif "joints2D" in metric_type:
                    num_per_sample = 17
                final_metrics[metric_type] = self.metric_sums[metric_type] / (
                    self.total_samples * num_per_sample)
            print(metric_type, "{:.2f}".format(final_metrics[metric_type] * mult))

        if self.save_per_frame_metrics:
            for metric_type in self.metrics_to_track:
                if "samples" not in metric_type:
                    per_frame = np.concatenate(self.per_frame_metrics[metric_type], axis=0)
                    if frame_order is not None and len(frame_order) == len(per_frame):
                        per_frame = per_frame[frame_order]
                    np.save(os.path.join(self.save_path,
                                         metric_type + "_per_frame.npy"), per_frame)
        return final_metrics
