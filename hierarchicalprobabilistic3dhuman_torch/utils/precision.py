"""bfloat16 inference for the encoders, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/precision.py
(bf16_apply_pure :44, bf16_apply :28): the network runs with its parameters
AND its activations in bfloat16, and returns float32. In torch that is a
bfloat16 copy of the module fed bfloat16 input, not `torch.autocast` (which
keeps float32 parameters and picks the precision per op).
"""

import copy

import torch


def bf16_apply(module):
    """Wrap a module: a bfloat16 copy of it (the float32 original is left as
    it is), called on input cast to bfloat16, with floating outputs cast back
    to float32.

    >>> hrnet_bf16 = bf16_apply(hrnet)
    >>> heatmaps = hrnet_bf16(images_f32)      # float32 (B, 17, 96, 72)
    """
    module_bf16 = copy.deepcopy(module).to(torch.bfloat16)

    def wrapped(x, *args, **kwargs):
        out = module_bf16(x.to(torch.bfloat16), *args, **kwargs)
        return out.to(torch.float32) if out.is_floating_point() else out
    return wrapped
