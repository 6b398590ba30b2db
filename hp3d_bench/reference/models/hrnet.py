"""HRNet-W48 2D-pose network, inference only.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/models/hrnet.py
::PoseHighResolutionNet :311 in its plain (unfolded) topology: stem (two
stride-2 3x3 convs) -> layer1 (4 Bottlenecks, 256 ch) -> transitions + 3
multi-resolution stages of BASIC blocks at widths width x (1, 2, 4, 8) with
sum-fused exchange units -> 1x1 conv to 17 joint heatmaps. Input (B, 3, H, W),
heatmaps (B, 17, H/4, W/4).

The module tree follows MSRA's reference implementation, so parameter names
are the published checkpoints' state-dict keys (transition1.0.0,
stage2.0.branches.0.0.conv1, stage2.0.fuse_layers.0.1.0, final_layer, ...).
`width` and `stage_modules` parameterise reduced variants for tests; the
defaults are HRNet-W48.
"""

import torch.nn as nn
import torch.nn.functional as F


def _conv_bn(cin, cout, k, stride, relu):
    layers = [nn.Conv2d(cin, cout, k, stride, k // 2, bias=False),
              nn.BatchNorm2d(cout)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class BasicBlock(nn.Module):
    def __init__(self, planes):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + x)


class Bottleneck(nn.Module):
    def __init__(self, in_planes, planes):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if in_planes != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes * 4, 1, bias=False),
                nn.BatchNorm2d(planes * 4))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class HighResolutionModule(nn.Module):
    """One exchange unit: 4 BASIC blocks per branch + sum fusion.

    fuse_layers[i][j]: j > i is 1x1 conv + BN then nearest upsampling by
    2^(j-i); j < i is a chain of i-j stride-2 3x3 conv + BN (ReLU on all but
    the last); j == i is the identity (None, as in MSRA's tree).
    """

    def __init__(self, channels, multi_scale_output=True, num_blocks=4):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c) for _ in range(num_blocks)])
            for c in channels)
        fuse_layers = []
        for i in range(n if multi_scale_output else 1):
            row = []
            for j in range(n):
                if j > i:
                    row.append(_conv_bn(channels[j], channels[i], 1, 1, False))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*[
                        _conv_bn(channels[j],
                                 channels[i] if k == i - j - 1 else channels[j],
                                 3, 2, k != i - j - 1)
                        for k in range(i - j)]))
            fuse_layers.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse_layers)

    def forward(self, xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                if j == i:
                    v = ys[j]
                elif j > i:
                    v = F.interpolate(layer(ys[j]), scale_factor=2 ** (j - i),
                                      mode="nearest")
                else:
                    v = layer(ys[j])
                acc = v if acc is None else acc + v
            fused.append(F.relu(acc))
        return fused


class PoseHighResolutionNet(nn.Module):
    """Input (B, 3, H, W) ImageNet-normalised; output (B, 17, H/4, W/4)."""

    def __init__(self, num_joints=17, width=48, stage_modules=(1, 4, 3)):
        super().__init__()
        self.width = width
        self.stage_modules = tuple(stage_modules)
        w = width
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(Bottleneck(64, 64), Bottleneck(256, 64),
                                    Bottleneck(256, 64), Bottleneck(256, 64))

        # transition1: 256 -> [w, 2w]; later transitions add one branch,
        # strided from the last existing one (MSRA keeps None placeholders).
        self.transition1 = nn.ModuleList([
            _conv_bn(256, w, 3, 1, True),
            nn.Sequential(_conv_bn(256, 2 * w, 3, 2, True))])
        self.transition2 = nn.ModuleList([
            None, None, nn.Sequential(_conv_bn(2 * w, 4 * w, 3, 2, True))])
        self.transition3 = nn.ModuleList([
            None, None, None, nn.Sequential(_conv_bn(4 * w, 8 * w, 3, 2, True))])
        widths = [w * 2 ** b for b in range(4)]
        self.stage2 = nn.Sequential(*[HighResolutionModule(widths[:2])
                                      for _ in range(stage_modules[0])])
        self.stage3 = nn.Sequential(*[HighResolutionModule(widths[:3])
                                      for _ in range(stage_modules[1])])
        self.stage4 = nn.Sequential(*[
            HighResolutionModule(widths, multi_scale_output=m < stage_modules[2] - 1)
            for m in range(stage_modules[2])])
        self.final_layer = nn.Conv2d(w, num_joints, 1)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [t(x) for t in self.transition1]
        for module in self.stage2:
            xs = module(xs)
        xs = xs + [self.transition2[2](xs[-1])]
        for module in self.stage3:
            xs = module(xs)
        xs = xs + [self.transition3[3](xs[-1])]
        for module in self.stage4:
            xs = module(xs)
        return self.final_layer(xs[0])
