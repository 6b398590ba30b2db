"""Evaluation alignment math in torch: Procrustes and scale+translation.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/eval_utils.py
(compute_similarity_transform :14, procrustes_analysis_batch :48,
scale_and_translation_transform_batch :82, shape_parameters_to_a_pose :100,
make_xz_ground_plane :115). The batched Procrustes solve
runs the port's Jacobi SVD (ops/svd3.py), as the JAX function runs its own:
R = V Z U^T does not depend on the SVD's column signs.
"""

import numpy as np
import torch

from hp3d_bench.reference.ops.svd3 import det3x3, svd3x3


def compute_similarity_transform(S1, S2):
    """Similarity transform (sR, t) aligning S1 to S2 (orthogonal Procrustes),
    with the det-sign fix.

    :param S1, S2: (N, D) point sets (also (D, N) for D in {2, 3})
    :return: S1_hat aligned to S2, same layout as input.
    """
    transposed = S1.shape[0] not in (2, 3)
    if transposed:
        S1, S2 = S1.T, S2.T
    mu1 = S1.mean(dim=1, keepdim=True)
    mu2 = S2.mean(dim=1, keepdim=True)
    X1 = S1 - mu1
    X2 = S2 - mu2
    var1 = torch.sum(X1 ** 2)

    K = X1 @ X2.T
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.T
    Z = torch.eye(U.shape[0], dtype=S1.dtype, device=S1.device)
    Z[-1, -1] = torch.sign(torch.linalg.det(U @ V.T))
    R = V @ (Z @ U.T)

    scale = torch.trace(R @ K) / var1
    t = mu2 - scale * (R @ mu1)
    S1_hat = scale * (R @ S1) + t
    return S1_hat.T if transposed else S1_hat


def procrustes_analysis_batch(S1, S2):
    """Batched Procrustes alignment of S1 to S2.

    :param S1, S2: (B, N, 3) (other point dimensions go one by one through
        compute_similarity_transform)
    :return: (B, N, 3) S1 aligned to S2
    """
    if S1.shape[-1] != 3:
        return torch.stack([compute_similarity_transform(a, b)
                            for a, b in zip(S1, S2)])
    mu1 = S1.mean(dim=1, keepdim=True)
    mu2 = S2.mean(dim=1, keepdim=True)
    X1 = S1 - mu1
    X2 = S2 - mu2
    var1 = torch.sum(X1 ** 2, dim=(1, 2))                       # (B,)
    K = torch.einsum("bni,bnj->bij", X1, X2)                    # (B, 3, 3)
    U, _, V = svd3x3(K)
    sign = torch.sign(det3x3(U @ V.transpose(-1, -2)))
    Vz = torch.cat([V[..., :, :2], V[..., :, 2:] * sign[..., None, None]], dim=-1)
    R = Vz @ U.transpose(-1, -2)                                # (B, 3, 3)
    scale = torch.einsum("bij,bji->b", R, K) / var1             # (B,)
    t = mu2 - scale[:, None, None] * torch.einsum("bij,bnj->bni", R, mu1)
    return scale[:, None, None] * torch.einsum("bij,bnj->bni", R, S1) + t


def scale_and_translation_transform_batch(P, T):
    """Align the mean and RMS scale of P to T.

    :param P: (B, N, 3) meshes to transform
    :param T: (B, N, 3) reference meshes
    :return: (B, N, 3)
    """
    P_mean = P.mean(dim=1, keepdim=True)
    P_trans = P - P_mean
    P_scale = torch.sqrt(torch.sum(P_trans ** 2, dim=(1, 2), keepdim=True)
                         / P.shape[1])
    P_normalised = P_trans / P_scale

    T_mean = T.mean(dim=1, keepdim=True)
    T_scale = torch.sqrt(torch.sum((T - T_mean) ** 2, dim=(1, 2), keepdim=True)
                         / T.shape[1])
    return P_normalised * T_scale + T_mean


def shape_parameters_to_a_pose(body_shape, smpl):
    """Mesh of a person in A-pose given betas: body-pose entries 47 and 50
    (the shoulders' z rotations) at -pi/3 and pi/3.

    :param body_shape: (B, num_betas)
    :param smpl: a models.smpl.SMPL instance
    :return: (B, 6890, 3) vertices
    """
    a_pose = body_shape.new_zeros((body_shape.shape[0], 69))
    a_pose[:, 47] = -np.pi / 3.0
    a_pose[:, 50] = np.pi / 3.0
    return smpl(betas=body_shape, body_pose=a_pose)["vertices"]


def make_xz_ground_plane(vertices):
    """Translate meshes so that their lowest y-coordinate sits on the x-z
    plane. A numpy array is copied and a tensor returned new; the input is
    not changed.

    :param vertices: (B, 6890, 3) numpy array or tensor
    :return: the same type and shape
    """
    if isinstance(vertices, np.ndarray):
        vertices = vertices.copy()
        vertices[:, :, 1] -= vertices[:, :, 1].min(axis=-1, keepdims=True)
        return vertices
    vertices = vertices.clone()
    vertices[:, :, 1] -= vertices[:, :, 1].amin(dim=-1, keepdim=True)
    return vertices
