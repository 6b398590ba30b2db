"""Per-batch metrics computed where the tensors are: training sums and
evaluation per-frame values, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/metrics/metric_sums.py
(make_eval_frame_metrics_fn :54, _eval_frame_metrics :79,
make_metric_sums_fn :147, _metric_sums :166): the eval step computes the
per-frame metric values (Procrustes and scale alignments, sample minima,
IOU confusion counts) and the train step the per-batch metric sums, so the
host fetches a few numbers instead of the meshes, samples and silhouettes.
They feed EvalMetricsTracker.update_per_batch_device and
TrainingLossesAndMetricsTracker.update_per_batch_sums. On a parallel Mesh
the eval frame metrics of a rank cover its rows and its part of the
samples: a best-sample metric takes its minimum over the per-sample errors
gathered from the "sample" axis, and the sample sums are this rank's share
(parallel/gather_rows sums them over the world).
"""

import torch

from hierarchicalprobabilistic3dhuman_torch.utils.eval_utils import (
    procrustes_analysis_batch, scale_and_translation_transform_batch)
from hierarchicalprobabilistic3dhuman_torch.utils.device import full_f32_matmul
from hierarchicalprobabilistic3dhuman_torch.utils.joints2d_utils import (
    undo_keypoint_normalisation)

# metric family -> (pred key, target key, alignment) — mirrors
# eval_metrics_tracker._POINT_METRICS.
EVAL_POINT_METRICS = {
    "PVE": ("verts", "verts", None),
    "PVE-SC": ("verts", "verts", "sc"),
    "PVE-PA": ("verts", "verts", "pa"),
    "PVE-T": ("reposed_verts", "reposed_verts", None),
    "PVE-T-SC": ("reposed_verts", "reposed_verts", "sc"),
    "MPJPE": ("joints3D", "joints3D", None),
    "MPJPE-SC": ("joints3D", "joints3D", "sc"),
    "MPJPE-PA": ("joints3D", "joints3D", "pa"),
}
EVAL_SAMPLES_KEY = {
    "PVE": "verts_samples", "PVE-SC": "verts_samples",
    "PVE-PA": "verts_samples", "PVE-T": "reposed_verts_samples",
    "PVE-T-SC": "reposed_verts_samples", "MPJPE": "joints3D_samples",
    "MPJPE-SC": "joints3D_samples", "MPJPE-PA": "joints3D_samples",
}


def align(pred, target, mode):
    """pred aligned to target: "sc" scale and translation, "pa"
    Procrustes, None as it is."""
    if mode == "sc":
        return scale_and_translation_transform_batch(pred, target)
    if mode == "pa":
        return procrustes_analysis_batch(pred, target)
    return pred


def make_eval_frame_metrics_fn(metrics_to_track, mesh=None, num_samples=None):
    """Build a fn (pred_dict, target_dict) -> per-frame metrics.

    Returns, per tracked metric, the (B,) per-frame mean point error, plus
    per-frame confusion counts for the IOU metrics and scalar sums for
    joints2Dsamples-L2E: the quantities EvalMetricsTracker.update_per_batch
    computes from fetched tensors. The alignments run with TF32 off. With
    a mesh the samples are this rank's part of `num_samples`.
    """
    track = list(metrics_to_track)

    def f(pred, target):
        with full_f32_matmul():
            return _eval_frame_metrics(pred, target, track, mesh, num_samples)

    return f


def _eval_frame_metrics(pred, target, track, mesh=None, num_samples=None):
    out = {}
    for m in track:
        if m in EVAL_POINT_METRICS:
            pk, tk, mode = EVAL_POINT_METRICS[m]
            aligned = align(pred[pk], target[tk], mode)
            err = torch.linalg.vector_norm(aligned - target[tk], dim=-1)  # (B, P)
            out[m] = err.mean(dim=-1)

        elif m.endswith("_samples_min"):
            base = m[:-len("_samples_min")]
            pk, tk, mode = EVAL_POINT_METRICS[base]
            samples = pred[EVAL_SAMPLES_KEY[base]]            # (B, N, P, 3)
            B, N = samples.shape[:2]
            flat = samples.reshape(B * N, *samples.shape[2:])
            tiled = target[tk][:, None].expand(B, N, *target[tk].shape[1:]) \
                .reshape(B * N, *target[tk].shape[1:])
            err = torch.linalg.vector_norm(align(flat, tiled, mode) - tiled,
                                           dim=-1).reshape(B, N, -1)
            mean_err = err.mean(dim=-1)                       # (B, N)
            if mesh is not None:
                mean_err = mesh.all_gather(mean_err, "sample", dim=1,
                                           sizes=mesh.sample_sizes(num_samples))
            best = torch.argmin(mean_err, dim=1)
            out[m] = mean_err[torch.arange(B, device=best.device), best]

        elif m == "joints2D-L2E":
            err = torch.linalg.vector_norm(pred["joints2D"] - target["joints2D"],
                                           dim=-1)            # (B, 17)
            out[m] = err.mean(dim=-1)

        elif m == "joints2Dsamples-L2E":
            p = pred["joints2Dsamples"]                       # (B, N, 17, 2)
            err = torch.linalg.vector_norm(p - target["joints2D"][:, None], dim=-1)
            if "joints2D_vis" in target:
                vis = target["joints2D_vis"][:, None, :]
                err = err * vis
                out["num_vis_joints2Dsamples"] = (
                    torch.sum(vis) * p.shape[1]).to(torch.float32)
            else:
                out["num_vis_joints2Dsamples"] = torch.tensor(
                    float(err.numel()), device=err.device)
            out[m] = torch.sum(err)

        elif m == "silhouette-IOU":
            ps = pred["silhouettes"] > 0.5
            ts = target["silhouettes"] > 0.5

            def count(mask):
                return torch.sum(mask, dim=(1, 2)).to(torch.float32)

            tp, fp = count(ps & ts), count(ps & ~ts)
            tn, fn = count(~ps & ~ts), count(~ps & ts)
            out["silhouette-IOU"] = tp / (tp + fp + fn)
            out["num_true_positives"] = tp
            out["num_false_positives"] = fp
            out["num_true_negatives"] = tn
            out["num_false_negatives"] = fn

        elif m == "silhouettesamples-IOU":
            ps = pred["silhouettessamples"] > 0.5             # (B, N, wh, wh)
            ts = target["silhouettes"][:, None] > 0.5
            for name, mask in (("true_positives", ps & ts),
                               ("false_positives", ps & ~ts),
                               ("true_negatives", ~ps & ~ts),
                               ("false_negatives", ~ps & ts)):
                out[f"num_samples_{name}"] = torch.sum(mask).to(torch.float32)
    return out


def make_metric_sums_fn(metrics_to_track, img_wh):
    """Build a fn (pred, target, pred_reposed_vertices,
    target_reposed_vertices) -> dict of scalar sums, one per tracked metric,
    plus the visible-sample count for joints2Dsamples-L2E. The key
    conventions are the train step's metric data and targets. The
    alignments run with TF32 off."""
    track = list(metrics_to_track)

    def f(pred, target, pred_reposed_vertices, target_reposed_vertices):
        with full_f32_matmul():
            return _metric_sums(pred, target, pred_reposed_vertices,
                                target_reposed_vertices, track, img_wh)

    return f


def _metric_sums(pred, target, pred_reposed, target_reposed, track, img_wh):
    def l2sum(a, b):
        return torch.sum(torch.linalg.vector_norm(a - b, dim=-1))

    pred = {**pred, "reposed_verts": pred_reposed}
    target = {**target, "reposed_verts": target_reposed}
    sums = {}
    for m, (pk, tk, mode) in EVAL_POINT_METRICS.items():
        if m in track:
            sums[m] = l2sum(align(pred[pk], target[tk], mode), target[tk])
    if "joints2D-L2E" in track:
        p2d = undo_keypoint_normalisation(pred["joints2D"], img_wh)
        sums["joints2D-L2E"] = l2sum(p2d, target["joints2D"])
    if "joints2Dsamples-L2E" in track and "joints2Dsamples" in pred:
        p = undo_keypoint_normalisation(pred["joints2Dsamples"], img_wh)
        vis = target["joints2D_vis"][:, None, :]                     # (B, 1, 17)
        err = torch.linalg.vector_norm(p - target["joints2D"][:, None],
                                       dim=-1) * vis                 # (B, N, 17)
        sums["joints2Dsamples-L2E"] = torch.sum(err)
        sums["num_visib_joints2Dsamples"] = (
            torch.sum(vis) * p.shape[1]).to(torch.float32)
    return sums
