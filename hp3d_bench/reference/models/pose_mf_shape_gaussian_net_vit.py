"""The reference predictor with ViT-H/16 (models/vit.py) as its image
encoder: the hierarchical matrix-Fisher pose and Gaussian shape head of
models/pose_mf_shape_gaussian_net.py on the ViT's 1280 mean-pooled token
features, fc1 1024 wide (the ResNet-50 head's width; the ViT has no
published width for this head).

The layers whose widths follow the encoder's (fc1, the shape, camera and
global heads, fc_embed) are made again for the ViT's features after the
ResNet predictor's constructor; the parameter names are the ResNet
predictor's, with the ViT's under image_encoder.*. The drop path draws from
`image_encoder.draws`, which the caller sets to the step's draw source.
"""

import torch.nn as nn

from hp3d_bench.reference.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet)
from hp3d_bench.reference.models.vit import ViT


class ViTPoseMFShapeGaussianNet(PoseMFShapeGaussianNet):
    """Input (B, C, D, D) proxy -> distribution parameters, through ViT(**vit).

    :param vit: the ViT's keyword arguments (img_size, patch_size, in_chans,
        embed_dim, depth, num_heads, mlp_ratio, qkv_bias, drop_path_rate, eps)
    :param fc1_dim: the head's first layer's width
    """

    def __init__(self, vit, fc1_dim=1024, embed_dim=256, num_smpl_betas=10,
                 **head):
        super().__init__(num_in_channels=vit["in_chans"], num_resnet_layers=18,
                         embed_dim=embed_dim, num_smpl_betas=num_smpl_betas,
                         **head)
        self.image_encoder = ViT(**vit)
        feat_dim = self.image_encoder.num_features
        self.fc1 = nn.Linear(feat_dim, fc1_dim)
        self.fc_shape = nn.Linear(fc1_dim, num_smpl_betas * 2)
        self.fc_cam = nn.Linear(fc1_dim, 3)
        self.fc_glob = nn.Linear(fc1_dim, 6)
        self.fc_embed = nn.Linear(feat_dim + num_smpl_betas * 2 + 6 + 3, embed_dim)
