from hierarchicalprobabilistic3dhuman_torch.configs.cfg_node import CfgNode
from hierarchicalprobabilistic3dhuman_torch.configs.pose_shape_config import (
    get_pose_shape_cfg_defaults,
    get_poseMF_shapeGaussian_cfg_defaults,
)
from hierarchicalprobabilistic3dhuman_torch.configs.pose2d_hrnet_config import (
    get_pose2d_hrnet_cfg_defaults,
    get_pose2D_hrnet_cfg_defaults,
)
from hierarchicalprobabilistic3dhuman_torch.configs import paths

__all__ = [
    "CfgNode",
    "get_pose_shape_cfg_defaults",
    "get_poseMF_shapeGaussian_cfg_defaults",
    "get_pose2d_hrnet_cfg_defaults",
    "get_pose2D_hrnet_cfg_defaults",
    "paths",
]
