from hp3d_bench.reference.configs.cfg_node import CfgNode
from hp3d_bench.reference.configs.pose_shape_config import (
    get_pose_shape_cfg_defaults,
    get_poseMF_shapeGaussian_cfg_defaults,
)
from hp3d_bench.reference.configs.pose2d_hrnet_config import (
    get_pose2d_hrnet_cfg_defaults,
    get_pose2D_hrnet_cfg_defaults,
)
from hp3d_bench.reference.configs import paths

__all__ = [
    "CfgNode",
    "get_pose_shape_cfg_defaults",
    "get_poseMF_shapeGaussian_cfg_defaults",
    "get_pose2d_hrnet_cfg_defaults",
    "get_pose2D_hrnet_cfg_defaults",
    "paths",
]
