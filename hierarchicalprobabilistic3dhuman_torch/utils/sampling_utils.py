"""Per-vertex uncertainty by sampling, and sample meshes sorted by 2D joint
error, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/sampling_utils.py
(compute_vertex_uncertainties_by_sampling :21 on the predict path, which
samples poses and keeps the mean shape (use_mean_shape=True there), and
joints2D_error_sorted_verts_sampling :84). On a parallel Mesh the SMPL of
the samples splits over "sample" after the sampler has run on every lane
(JAX constrains pose_samples only after pose_matrix_fisher_sampling,
:56-70): the mean vertices and the distances are summed over "sample", and
the sample meshes gathered back.
"""

import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.ops.bingham_sampling import (
    pose_matrix_fisher_sampling)
from hierarchicalprobabilistic3dhuman_torch.utils.cam_utils import (
    orthographic_project)
from hierarchicalprobabilistic3dhuman_torch.utils.joints2d_utils import (
    undo_keypoint_normalisation)
from hierarchicalprobabilistic3dhuman_torch.utils.label_conversions import (
    ALL_JOINTS_TO_COCO_MAP, convert_heatmaps_to_2Djoints_coordinates)
from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import (
    aa_rotate_translate_points)


def compute_vertex_uncertainties_by_sampling(pose_U, pose_S, pose_V,
                                             shape_mean, glob_rotmats,
                                             num_samples, smpl, b=1.5,
                                             oversampling_ratio=8,
                                             generator=None, eps=None, w=None,
                                             mesh=None):
    """Per-vertex mean distance-from-mean over N pose samples at the mean
    shape; the (B x N) SMPL evaluations run as one batched LBS, on a mesh
    this rank's part of the N.

    :param pose_U/S/V: (B, 23, 3, 3) / (B, 23, 3) / (B, 23, 3, 3)
    :param shape_mean: (B, num_betas)
    :param glob_rotmats: (B, 3, 3)
    :param eps, w: optional pre-drawn sampler draws (see bingham_sampling)
    :param mesh: optional parallel Mesh whose "sample" axis splits the N
    :return: avg_distance (B, 6890), vertices_samples (B, N, 6890, 3),
             joints_samples (B, N, 90, 3)
    """
    B = pose_U.shape[0]
    pose_samples = pose_matrix_fisher_sampling(
        pose_U, pose_S, pose_V, num_samples, b=b,
        oversampling_ratio=oversampling_ratio, generator=generator,
        eps=eps, w=w)
    if mesh is not None:
        pose_samples = pose_samples[:, mesh.samples(num_samples)]
    n = pose_samples.shape[1]
    flat_shape = shape_mean[:, None].expand(B, n, shape_mean.shape[-1])
    flat_glob = glob_rotmats[:, None].expand(B, n, 3, 3)
    out = smpl(body_pose=pose_samples.reshape(B * n, 23, 3, 3),
               global_orient=flat_glob.reshape(B * n, 1, 3, 3),
               betas=flat_shape.reshape(B * n, -1), pose2rot=False)
    verts = out["vertices"].reshape(B, n, -1, 3)
    joints = out["joints"].reshape(B, n, -1, 3)
    if mesh is None:
        mean_verts = verts.mean(dim=1, keepdim=True)
        avg_distance = torch.linalg.vector_norm(verts - mean_verts,
                                                dim=-1).mean(dim=1)
        return avg_distance, verts, joints
    mean_verts = mesh.all_reduce(verts.sum(dim=1, keepdim=True), "sample") / num_samples
    avg_distance = mesh.all_reduce(
        torch.linalg.vector_norm(verts - mean_verts, dim=-1).sum(dim=1),
        "sample") / num_samples
    sizes = mesh.sample_sizes(num_samples)
    return (avg_distance, mesh.all_gather(verts, "sample", dim=1, sizes=sizes),
            mesh.all_gather(joints, "sample", dim=1, sizes=sizes))


def joints2D_error_sorted_verts_sampling(pred_vertices_samples,
                                         pred_joints_samples,
                                         input_joints2D_heatmaps,
                                         pred_cam_wp):
    """Sort sample meshes by their largest visible-joint 2D reprojection
    error, ascending. Invisible joints count as -inf, so a heatmap with no
    visible joint leaves every error at -inf and the order as drawn: the
    sort is stable, as jnp.argsort is.

    :param pred_vertices_samples: (N, 6890, 3)
    :param pred_joints_samples: (N, 90, 3)
    :param input_joints2D_heatmaps: (1, 17, D, D)
    :param pred_cam_wp: (1, 3)
    :return: (N, 6890, 3) sorted ascending by error
    """
    N = pred_vertices_samples.shape[0]
    coco = pred_joints_samples[:, ALL_JOINTS_TO_COCO_MAP, :]
    coco = aa_rotate_translate_points(coco, [1.0, 0.0, 0.0], np.pi,
                                      [0.0, 0.0, 0.0])
    j2d = orthographic_project(coco, pred_cam_wp.expand(N, 3))
    j2d = undo_keypoint_normalisation(j2d, input_joints2D_heatmaps.shape[-1])
    input_j2d, input_vis = convert_heatmaps_to_2Djoints_coordinates(
        input_joints2D_heatmaps, eps=1e-6)                  # (1, 17, 2), (1, 17)
    err = torch.linalg.vector_norm(j2d - input_j2d, dim=-1)  # (N, 17)
    err = torch.where(input_vis, err, -torch.inf)
    max_err = torch.amax(err, dim=-1)                        # (N,)
    order = torch.argsort(max_err, stable=True)
    return pred_vertices_samples[order]
