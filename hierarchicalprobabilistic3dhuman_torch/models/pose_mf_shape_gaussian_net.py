"""Hierarchical kinematic matrix-Fisher pose + Gaussian shape predictor.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/models/
pose_mf_shape_gaussian_net.py::PoseMFShapeGaussianNet (:81-241):

  * an image encoder over the 18-channel proxy representation, chosen by
    name (`encoder`): "resnet", ResNet-18 or ResNet-50 by num_resnet_layers
    (the JAX package's :110-118), 512 features and fc1 512 wide, or 2048
    features and fc1 1024 wide; or "vit_h", ViT-H/16 (models/vit.py; the
    JAX package has none), 1280 mean-pooled token features and fc1 1024
    wide, whose drop path takes the step's draw source (`forward(inputs,
    draws)`; a ResNet draws nothing);
  * shape head -> diagonal Gaussian (mean, log std) over SMPL betas;
  * glob/cam heads predict deltas against fixed initial estimates
    (identity rot6d, [0.9, 0, 0] weak-perspective cam);
  * hierarchical pose head: one 2-layer MLP per body joint, fed the
    embedding plus all ancestors' (U_proper, S_proper, mode), evaluated
    depth-grouped (joints at one kinematic depth share an input width, so
    each depth is one batched product and one batched 3x3 SVD);
  * delta-I: the identity is added to each joint's F;
  * svd_impl (:98, :205-210): "jacobi" (the default), "lapack" (sgesdd's
    signs on the device, ops/lapack_svd3.py) or "lapack_callback" (numpy's
    sgesdd on a host copy), the last two for reference checkpoints;
  * encoder_bf16 (the JAX package's encoder_dtype=bfloat16, :107): the
    encoder alone under torch.autocast to bfloat16; its parameters,
    BatchNorm (LayerNorm) and the head stay float32;
  * on the card the Jacobi head runs as CUDA graphs of its forward and
    backward (models/graphed_head.py), the same kernels replayed.

The head runs in full float32: on the card its matmuls run with TF32 off.
Parameter names are the reference checkpoint's state-dict keys
(image_encoder.*, fc1, fc_shape, fc_cam, fc_glob, fc_embed,
fc_pose.{j}.0 / fc_pose.{j}.2).
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hierarchicalprobabilistic3dhuman_torch.models.graphed_head import graphed_head
from hierarchicalprobabilistic3dhuman_torch.models.resnet import resnet18, resnet50
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL_PARENTS
from hierarchicalprobabilistic3dhuman_torch.models.vit import vit_h
from hierarchicalprobabilistic3dhuman_torch.ops.svd3 import (
    proper_svd3x3, proper_svd3x3_gesdd, proper_svd3x3_lapack)
from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import span
from hierarchicalprobabilistic3dhuman_torch.utils.device import full_f32_matmul

SVD_IMPLS = ("jacobi", "lapack", "lapack_callback")
# num_resnet_layers -> (encoder, fc1 width)
ENCODERS = {18: (resnet18, 512), 50: (resnet50, 1024)}
# The encoders by name; "resnet" takes its depth from num_resnet_layers.
ENCODER_NAMES = ("resnet", "vit_h")
VIT_FC1_DIM = 1024
# The modules whose parameters `_head` reads.
HEAD_MODULES = ("fc1", "fc_shape", "fc_cam", "fc_glob", "fc_embed", "fc_pose")


def immediate_parents_to_all_parents(immediate_parents):
    """Per-body-joint ancestor lists: body-joint index (0..22) -> list of
    ancestor body-joint indices, nearest first."""
    parents_dict = {}
    for i in range(1, len(immediate_parents)):
        joint = i - 1
        immediate_parent = immediate_parents[i] - 1
        if immediate_parent >= 0:
            parents_dict[joint] = ([immediate_parent]
                                   + parents_dict.get(immediate_parent, []))
        else:
            parents_dict[joint] = []
    return parents_dict


# rot6d of the identity rotation in the row-interleaved layout.
_INIT_GLOB = np.array([1.0, 0.0, 0.0, 1.0, 0.0, 0.0], dtype=np.float32)
_INIT_CAM = np.array([0.9, 0.0, 0.0], dtype=np.float32)


class PoseMFShapeGaussianNet(nn.Module):
    """Input (B, C, D, D) proxy representation -> distribution parameters."""

    def __init__(self, num_in_channels=18, num_resnet_layers=18, embed_dim=256,
                 delta_i=True, delta_i_weight=1.0, num_smpl_betas=10,
                 svd_sweeps=8, svd_impl="jacobi", encoder_bf16=False,
                 encoder="resnet", proxy_size=256):
        super().__init__()
        if svd_impl not in SVD_IMPLS:
            raise ValueError(f"svd_impl must be one of {SVD_IMPLS}, got "
                             f"{svd_impl!r}")
        if encoder not in ENCODER_NAMES:
            raise ValueError(f"encoder must be one of {ENCODER_NAMES}, got "
                             f"{encoder!r}")
        if encoder == "resnet" and num_resnet_layers not in ENCODERS:
            raise ValueError(f"Unsupported resnet depth {num_resnet_layers}")
        self.encoder = encoder
        self.svd_impl = svd_impl
        self.encoder_bf16 = encoder_bf16
        self.parents_dict = immediate_parents_to_all_parents(
            [int(p) for p in SMPL_PARENTS])
        self.num_joints = len(self.parents_dict)
        self.num_smpl_betas = num_smpl_betas
        self.delta_i = delta_i
        self.delta_i_weight = delta_i_weight
        self.svd_sweeps = svd_sweeps

        if encoder == "vit_h":
            self.image_encoder = vit_h(num_in_channels, proxy_size)
            fc1_dim = VIT_FC1_DIM
        else:
            make_resnet, fc1_dim = ENCODERS[num_resnet_layers]
            self.image_encoder = make_resnet(in_channels=num_in_channels)
        feat_dim = self.image_encoder.num_features
        self.fc1 = nn.Linear(feat_dim, fc1_dim)
        self.fc_shape = nn.Linear(fc1_dim, num_smpl_betas * 2)
        self.fc_cam = nn.Linear(fc1_dim, 3)
        self.fc_glob = nn.Linear(fc1_dim, 6)
        self.fc_embed = nn.Linear(feat_dim + num_smpl_betas * 2 + 6 + 3, embed_dim)
        hidden = embed_dim // 2
        self.fc_pose = nn.ModuleList(
            nn.Sequential(nn.Linear(embed_dim + 21 * len(self.parents_dict[j]),
                                    hidden),
                          nn.ELU(),
                          nn.Linear(hidden, 9))
            for j in range(self.num_joints))
        self.register_buffer("init_glob", torch.from_numpy(_INIT_GLOB),
                             persistent=False)
        self.register_buffer("init_cam", torch.from_numpy(_INIT_CAM),
                             persistent=False)

        depth_groups = {}
        for joint in range(self.num_joints):
            depth_groups.setdefault(len(self.parents_dict[joint]), []).append(joint)
        self.depth_groups = [depth_groups[d] for d in sorted(depth_groups)]

    @property
    def takes_draws(self):
        """Whether a train step hands the forward its draw source (a ViT's
        drop path); a ResNet draws nothing and is called without one."""
        return self.encoder != "resnet"

    def forward(self, inputs, draws=None):
        """:param draws: the step's draw source, handed to the encoder where
        given (`takes_draws`)"""
        with span("encoder"), torch.autocast(
                inputs.device.type, dtype=torch.bfloat16, enabled=self.encoder_bf16):
            # float32 out: each BatchNorm (the ViT's LayerNorm) normalises in
            # float32.
            feats = (self.image_encoder(inputs) if draws is None
                     else self.image_encoder(inputs, draws))
        with full_f32_matmul(), span("pose_head"):
            return graphed_head(self, feats)

    def head_modules(self):
        """The modules whose parameters `_head` reads."""
        return [getattr(self, name) for name in HEAD_MODULES]

    def head_parameters(self):
        """The parameters `_head` reads, in a fixed order."""
        return [p for m in self.head_modules() for p in m.parameters()]

    def head_buffers(self):
        """The buffers `_head` reads."""
        return [self.init_glob, self.init_cam]

    def _head(self, feats):
        B = feats.shape[0]
        x = F.elu(self.fc1(feats))
        shape_params = self.fc_shape(x)
        glob = self.fc_glob(x) + self.init_glob
        cam = self.fc_cam(x) + self.init_cam
        embed = F.elu(self.fc_embed(torch.cat([feats, shape_params, glob, cam],
                                              dim=1)))
        eye = torch.eye(3, dtype=embed.dtype, device=embed.device)

        out_j = {k: {} for k in ("F", "U", "S", "V", "U_proper", "S_proper",
                                 "mode")}
        for group in self.depth_groups:
            ins = []
            for joint in group:
                parents = self.parents_dict[joint]
                ins.append(torch.cat(
                    [embed]
                    + [out_j["U_proper"][p].reshape(B, 9) for p in parents]
                    + [out_j["S_proper"][p] for p in parents]
                    + [out_j["mode"][p].reshape(B, 9) for p in parents], dim=1))
            x = torch.stack(ins, dim=1)                         # (B, G, d_in)
            layers = [self.fc_pose[j] for j in group]
            W0 = torch.stack([m[0].weight for m in layers])     # (G, H, d_in)
            b0 = torch.stack([m[0].bias for m in layers])
            W1 = torch.stack([m[2].weight for m in layers])     # (G, 9, H)
            b1 = torch.stack([m[2].bias for m in layers])
            h = F.elu(torch.einsum("bgi,ghi->bgh", x, W0) + b0)
            group_F = (torch.einsum("bgh,goh->bgo", h, W1) + b1
                       ).reshape(B, len(group), 3, 3)
            if self.delta_i:
                group_F = group_F + self.delta_i_weight * eye
            if self.svd_impl == "lapack":
                svd = proper_svd3x3_gesdd(group_F)
            elif self.svd_impl == "lapack_callback":
                svd = proper_svd3x3_lapack(group_F)
            else:
                svd = proper_svd3x3(group_F, n_sweeps=self.svd_sweeps)
            svd["F"] = group_F
            for gi, joint in enumerate(group):
                for k in out_j:
                    out_j[k][joint] = svd[k][:, gi]

        def stack(k):
            return torch.stack([out_j[k][j] for j in range(self.num_joints)],
                               dim=1)

        return {
            "pose_params_F": stack("F"),
            "pose_params_U": stack("U"),
            "pose_params_S": stack("S"),
            "pose_params_V": stack("V"),
            "pose_params_U_proper": stack("U_proper"),
            "pose_params_S_proper": stack("S_proper"),
            "pose_rotmats_mode": stack("mode"),
            "shape_mean": shape_params[:, :self.num_smpl_betas],
            "shape_log_std": shape_params[:, self.num_smpl_betas:],
            "glob": glob,
            "cam": cam,
        }
