"""The plain reference of ViT-H/16, HMR 2.0's backbone, as the predictor's
image encoder.

Written from the published description: 4D-Humans'
hmr2/models/backbones/vit.py, function vit() (Goel et al., "Humans in 4D:
Reconstructing and Tracking Humans with Transformers", ICCV 2023), which
builds ViTPose-H's backbone (Xu et al., NeurIPS 2022) as
ViT(img_size=(256, 192), patch_size=16, embed_dim=1280, depth=32,
num_heads=16, ratio=1, mlp_ratio=4, qkv_bias=True, drop_path_rate=0.55):

  * HMR 2.0 slices its 256^2 crop to x[..., 32:-32] (a D^2 input: D/8
    columns off each side);
  * PatchEmbed: Conv2d(in_chans, embed_dim, kernel 16, stride 16 // ratio,
    padding 4 + 2 * (ratio // 2 - 1)), i.e. padding 2 at ratio 1; the
    tokens flattened row by row;
  * x + pos_embed[:, 1:] + pos_embed[:, :1], pos_embed (1, patches + 1, C);
  * Blocks: x = x + drop_path(attn(norm1(x))), x = x + drop_path(mlp(norm2(x)))
    with LayerNorm(eps=1e-6); Attention: qkv Linear with bias, q scaled by
    head_dim^-0.5, softmax(q k^T) v written out as products (no fused
    kernel), proj Linear; Mlp: fc1, GELU (erf), fc2;
  * drop-path rates torch.linspace(0, drop_path_rate, depth); timm's
    drop_path: random_tensor = floor(keep_prob + u), x / keep_prob *
    random_tensor, per sample, in train mode alone;
  * last_norm, a LayerNorm over the tokens.

Departures, for the distribution predictor (also in the configuration's
`assumed`):
  * the input is the 18-channel proxy (edges and joint heatmaps), not RGB;
  * the tokens after last_norm are mean-pooled to one 1280 vector, where
    HMR 2.0 hands the token map to its transformer decoder head: the
    hierarchical head takes one feature vector;
  * u, the drop-path draw of each branch, is taken from `draws` (set by the
    caller to the run's draw source: one (B,) uniform draw a branch with a
    rate above 0, in block order) so that the port and this reference drop
    the same samples;
  * weights come from the run's seed (hp3d_bench/paths/train_vit.py), not
    from ViTPose's checkpoint.

Plain torch float32: the model's constructor turns TF32 off for matmuls and
cuDNN convolutions.
"""

import torch
import torch.nn as nn


def drop_path(x, drop_prob, training, draws):
    if drop_prob == 0.0 or not training:
        return x
    keep_prob = 1 - drop_prob
    random_tensor = keep_prob + draws.uniform((x.shape[0],))
    random_tensor = random_tensor.floor().to(x.dtype)
    return x.div(keep_prob) * random_tensor.reshape(-1, 1, 1)


class PatchEmbed(nn.Module):
    def __init__(self, img_size, patch_size, in_chans, embed_dim, ratio=1):
        super().__init__()
        self.num_patches = ((img_size[1] // patch_size) * (img_size[0] // patch_size)
                            * ratio ** 2)
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=patch_size,
                              stride=patch_size // ratio,
                              padding=4 + 2 * (ratio // 2 - 1))

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, qkv_bias):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B, N, -1)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, in_features, hidden_features):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, qkv_bias, drop_path_rate, eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.drop_path_rate = drop_path_rate
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, draws):
        x = x + drop_path(self.attn(self.norm1(x)), self.drop_path_rate,
                          self.training, draws)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path_rate,
                             self.training, draws)


class ViT(nn.Module):
    """(B, C, D, D) proxy -> (B, embed_dim): sliced, embedded, the blocks,
    last_norm, the tokens' mean. `draws` (an attribute) is the drop path's
    draw source in train mode."""

    def __init__(self, img_size=(256, 192), patch_size=16, in_chans=18,
                 embed_dim=1280, depth=32, num_heads=16, ratio=1, mlp_ratio=4,
                 qkv_bias=True, drop_path_rate=0.55, eps=1e-6):
        super().__init__()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.img_size = tuple(img_size)
        self.patch_embed = PatchEmbed(self.img_size, patch_size, in_chans, embed_dim,
                                      ratio)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.patch_embed.num_patches + 1,
                                                  embed_dim))
        dpr = [x.item() for x in torch.linspace(0, drop_path_rate, depth,
                                                device="cpu")]
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, dpr[i], eps)
            for i in range(depth))
        self.last_norm = nn.LayerNorm(embed_dim, eps=eps)
        self.num_features = embed_dim
        self.draws = None

    def forward(self, x):
        cut = (x.shape[-1] - self.img_size[1]) // 2
        x = self.patch_embed(x[..., cut:x.shape[-1] - cut])
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x, self.draws)
        return self.last_norm(x).mean(dim=1)
