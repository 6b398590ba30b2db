"""ResNet-18/50 image encoder for the 18-channel proxy representation.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/models/resnet.py:17-131
(BasicBlock, Bottleneck, ResNet, resnet18, resnet50): the torchvision
layout with the first conv taking `in_channels` inputs, no final FC,
global-average-pooled features out (512 for ResNet-18, 2048 for ResNet-50).
The first block of a stage has a downsample when its stride or its width
changes, so every stage of ResNet-50 has one, stage 1's at stride 1
(64 -> 256). Parameter names are the reference checkpoint's state-dict keys
(conv1, bn1, layer{s}.{i}.conv1 ... conv3, downsample.0/.1).

BatchNorm in train mode follows flax's nn.BatchNorm(momentum=0.9) (the JAX
package's :30-68), not torch's: the batch is normalised with the biased
variance E[x^2] - E[x]^2, and the running variance is updated with that
same biased variance. Under a sharded jit flax's statistics are the global
batch's; the port's ranks get the same through `sync` (a parallel Mesh):
the moments are summed over the mesh's "data" axis, with a backward that
sums their two gradients there (torch's SyncBatchNorm would all-gather and
update the running variance with the unbiased variance).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class _SyncedMoments(torch.autograd.Function):
    """E[x] and E[x^2] per channel over the rows of every rank of the
    mesh's "data" axis. Backward: the two upstream gradients are summed
    over the same ranks (each rank's loss uses the shared moments), then
    dx = (g_mean + 2 x g_ex2) / n for the global count n."""

    @staticmethod
    def forward(ctx, x, mesh):
        c = x.shape[1]
        count = torch.full((1,), float(x.numel() // c), dtype=x.dtype,
                           device=x.device)
        sums = mesh.all_reduce(torch.cat([x.sum(dim=(0, 2, 3)),
                                          (x * x).sum(dim=(0, 2, 3)), count]),
                               "data")
        n = sums[2 * c]
        ctx.save_for_backward(x, n)
        ctx.mesh = mesh
        return sums[:c] / n, sums[c:2 * c] / n

    @staticmethod
    def backward(ctx, g_mean, g_ex2):
        x, n = ctx.saved_tensors
        c = x.shape[1]
        g = ctx.mesh.all_reduce(torch.cat([g_mean, g_ex2]), "data")
        g_mean, g_ex2 = (g[:c] / n)[None, :, None, None], (g[c:] / n)[None, :, None, None]
        return g_mean + 2.0 * x * g_ex2, None


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d with flax's train-mode statistics; the same parameter
    and buffer names, and the same eval mode.

    Train mode: mean = E[x], var = max(E[x^2] - E[x]^2, 0) over (N, H, W),
    y = (x - mean) * weight / sqrt(var + eps) + bias, and under no_grad
    running = (1 - momentum) * running + momentum * batch for both, with the
    biased var (torch would use the unbiased one). Input of another dtype
    (bfloat16 from an autocast conv) is normalised in the parameters' dtype.
    With `sync` set to a Mesh whose "data" axis holds more than one rank,
    the moments are the global batch's.
    """

    sync = None

    def forward(self, x):
        if x.dtype != self.weight.dtype:
            x = x.to(self.weight.dtype)
        if not self.training:
            return super().forward(x)
        if self.sync is not None and self.sync.shape["data"] > 1:
            mean, ex2 = _SyncedMoments.apply(x, self.sync)
        else:
            mean, ex2 = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.bias[None, :, None, None])


def _downsample(in_planes, out_planes, stride):
    """The residual's 1x1 conv + BatchNorm where the block changes the
    stride or the width, else None."""
    if stride == 1 and in_planes == out_planes:
        return None
    return nn.Sequential(nn.Conv2d(in_planes, out_planes, 1, stride, bias=False),
                         BatchNorm2d(out_planes))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _downsample(in_planes, planes, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with the stride -> 1x1 at 4x the width (the JAX
    package's :49-89)."""
    expansion = 4

    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out_planes, 1, bias=False)
        self.bn3 = BatchNorm2d(out_planes)
        self.downsample = _downsample(in_planes, out_planes, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Encoder trunk: (B, C, H, W) -> (B, 512 * block.expansion) pooled
    features."""

    def __init__(self, block=BasicBlock, layers=(2, 2, 2, 2), in_channels=18):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        in_planes = 64
        for stage, num_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            blocks = []
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(in_planes, planes, stride))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.layers = tuple(layers)
        self.num_features = in_planes

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(len(self.layers)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3))


def resnet18(in_channels=18):
    return ResNet(BasicBlock, (2, 2, 2, 2), in_channels)


def resnet50(in_channels=18):
    return ResNet(Bottleneck, (3, 4, 6, 3), in_channels)
