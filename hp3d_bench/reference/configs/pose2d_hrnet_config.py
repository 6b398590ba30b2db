"""Default config for the HRNet-W48 2D pose network.

Key names/values mirror the reference (reference: configs/pose2D_hrnet_config.py:15-56)
so HRNet YAML overrides carry over unchanged.
"""

from hp3d_bench.reference.configs.cfg_node import CfgNode

_C = CfgNode()

# Model
_C.MODEL = CfgNode()
_C.MODEL.NUM_JOINTS = 17
_C.MODEL.IMAGE_SIZE = [288, 384]  # width * height
_C.MODEL.HEATMAP_SIZE = [72, 96]  # width * height

_C.MODEL.EXTRA = CfgNode()
_C.MODEL.EXTRA.PRETRAINED_LAYERS = ['conv1', 'bn1', 'conv2', 'bn2', 'layer1', 'transition1',
                                    'stage2', 'transition2', 'stage3', 'transition3', 'stage4']
_C.MODEL.EXTRA.FINAL_CONV_KERNEL = 1

_C.MODEL.EXTRA.STAGE2 = CfgNode()
_C.MODEL.EXTRA.STAGE2.NUM_MODULES = 1
_C.MODEL.EXTRA.STAGE2.NUM_BRANCHES = 2
_C.MODEL.EXTRA.STAGE2.BLOCK = 'BASIC'
_C.MODEL.EXTRA.STAGE2.NUM_BLOCKS = [4, 4]
_C.MODEL.EXTRA.STAGE2.NUM_CHANNELS = [48, 96]
_C.MODEL.EXTRA.STAGE2.FUSE_METHOD = 'SUM'

_C.MODEL.EXTRA.STAGE3 = CfgNode()
_C.MODEL.EXTRA.STAGE3.NUM_MODULES = 4
_C.MODEL.EXTRA.STAGE3.NUM_BRANCHES = 3
_C.MODEL.EXTRA.STAGE3.BLOCK = 'BASIC'
_C.MODEL.EXTRA.STAGE3.NUM_BLOCKS = [4, 4, 4]
_C.MODEL.EXTRA.STAGE3.NUM_CHANNELS = [48, 96, 192]
_C.MODEL.EXTRA.STAGE3.FUSE_METHOD = 'SUM'

_C.MODEL.EXTRA.STAGE4 = CfgNode()
_C.MODEL.EXTRA.STAGE4.NUM_MODULES = 3
_C.MODEL.EXTRA.STAGE4.NUM_BRANCHES = 4
_C.MODEL.EXTRA.STAGE4.BLOCK = 'BASIC'
_C.MODEL.EXTRA.STAGE4.NUM_BLOCKS = [4, 4, 4, 4]
_C.MODEL.EXTRA.STAGE4.NUM_CHANNELS = [48, 96, 192, 384]
_C.MODEL.EXTRA.STAGE4.FUSE_METHOD = 'SUM'

# Testing
_C.TEST = CfgNode()
_C.TEST.POST_PROCESS = False
_C.TEST.OBJECT_DET_THRESH = 0.95


def get_pose2d_hrnet_cfg_defaults():
    return _C.clone()


# Reference-compatible alias (reference: configs/pose2D_hrnet_config.py:58).
get_pose2D_hrnet_cfg_defaults = get_pose2d_hrnet_cfg_defaults
