"""Per-vertex uncertainty by sampling, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/sampling_utils.py
::compute_vertex_uncertainties_by_sampling :21 on the predict path, which
samples poses and keeps the mean shape (use_mean_shape=True there).
"""

import torch

from hierarchicalprobabilistic3dhuman_torch.ops.bingham_sampling import (
    pose_matrix_fisher_sampling)


def compute_vertex_uncertainties_by_sampling(pose_U, pose_S, pose_V,
                                             shape_mean, glob_rotmats,
                                             num_samples, smpl, b=1.5,
                                             oversampling_ratio=8,
                                             generator=None, eps=None, w=None):
    """Per-vertex mean distance-from-mean over N pose samples at the mean
    shape; the (B x N) SMPL evaluations run as one batched LBS.

    :param pose_U/S/V: (B, 23, 3, 3) / (B, 23, 3) / (B, 23, 3, 3)
    :param shape_mean: (B, num_betas)
    :param glob_rotmats: (B, 3, 3)
    :param eps, w: optional pre-drawn sampler draws (see bingham_sampling)
    :return: avg_distance (B, 6890), vertices_samples (B, N, 6890, 3),
             joints_samples (B, N, 90, 3)
    """
    B = pose_U.shape[0]
    pose_samples = pose_matrix_fisher_sampling(
        pose_U, pose_S, pose_V, num_samples, b=b,
        oversampling_ratio=oversampling_ratio, generator=generator,
        eps=eps, w=w)
    flat_shape = shape_mean[:, None].expand(B, num_samples, shape_mean.shape[-1])
    flat_glob = glob_rotmats[:, None].expand(B, num_samples, 3, 3)
    out = smpl(body_pose=pose_samples.reshape(B * num_samples, 23, 3, 3),
               global_orient=flat_glob.reshape(B * num_samples, 1, 3, 3),
               betas=flat_shape.reshape(B * num_samples, -1), pose2rot=False)
    verts = out["vertices"].reshape(B, num_samples, -1, 3)
    joints = out["joints"].reshape(B, num_samples, -1, 3)
    mean_verts = verts.mean(dim=1, keepdim=True)
    avg_distance = torch.linalg.vector_norm(verts - mean_verts, dim=-1).mean(dim=1)
    return avg_distance, verts, joints

