"""ViT-H/16, the backbone of HMR 2.0, as the distribution predictor's image
encoder.

The architecture of 4D-Humans' hmr2/models/backbones/vit.py::vit() (Goel et
al., "Humans in 4D", ICCV 2023; the same backbone as ViTPose-H, Xu et al.,
NeurIPS 2022): ViT(img_size=(256, 192), patch_size=16, embed_dim=1280,
depth=32, num_heads=16, ratio=1, mlp_ratio=4, qkv_bias=True,
drop_path_rate=0.55). The JAX package has no counterpart.

  * the square proxy is sliced to its central 3/4 columns, as HMR 2.0
    slices its 256^2 crop to x[..., 32:-32];
  * patch embedding: Conv2d(C_in, width, 16, stride 16, padding 2), giving
    16 x 12 = 192 tokens at 256 x 192;
  * x + pos_embed[:, 1:] + pos_embed[:, :1], pos_embed (1, tokens + 1, width);
  * `depth` pre-norm blocks, x = x + DropPath(Attn(LN1(x))) and
    x = x + DropPath(MLP(LN2(x))): LayerNorm eps 1e-6; attention of
    `num_heads` heads with a qkv projection with bias, through
    torch.nn.functional.scaled_dot_product_attention (scale head_dim^-0.5),
    and an output projection; MLP width -> 4 width -> GELU (erf) -> width;
  * the final LayerNorm (`last_norm`), then the tokens' mean: one feature
    vector of `width` a picture for the hierarchical head (HMR 2.0 feeds the
    token map to a transformer decoder instead).

Drop path (stochastic depth): block i's two branches drop with rate
drop_path_rate * i / (depth - 1), each sample kept with a per-sample mask
floor(keep + u) divided by keep. It runs in train mode only, and its draws
come from the step's draw source (utils/random_draws.py) at the encoder's
forward: one (B,) uniform draw a branch whose rate is above 0, in block
order, the attention branch before the MLP's. In eval mode, or at rate 0,
nothing is drawn.

Parameter names are 4D-Humans' (patch_embed.proj, pos_embed,
blocks.{i}.norm1 / attn.qkv / attn.proj / norm2 / mlp.fc1 / mlp.fc2,
last_norm).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

# vit() of 4D-Humans' hmr2/models/backbones/vit.py, at its 256 x 192 input.
VIT_H = {"img_size": (256, 192), "patch_size": 16, "padding": 2,
         "embed_dim": 1280, "depth": 32, "num_heads": 16, "mlp_ratio": 4,
         "qkv_bias": True, "drop_path_rate": 0.55, "eps": 1e-6}


class DropPath(nn.Module):
    """Per-sample stochastic depth of one residual branch."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, draws):
        if not self.training or self.rate == 0.0:
            return x
        if draws is None:
            raise ValueError("drop path in train mode needs the step's draw "
                             "source (model(inputs, draws=...))")
        keep = 1.0 - self.rate
        mask = torch.floor(keep + draws.uniform((x.shape[0],)))
        return x.div(keep) * mask.to(x.dtype)[:, None, None]


class Attention(nn.Module):
    def __init__(self, dim, num_heads, qkv_bias):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                 # (B, heads, N, hd)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, qkv_bias, drop_path, eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path)

    def forward(self, x, draws):
        x = x + self.drop_path(self.attn(self.norm1(x)), draws)
        return x + self.drop_path(self.mlp(self.norm2(x)), draws)


class ViT(nn.Module):
    """(B, C, D, D) proxy -> (B, embed_dim) features; see the module
    docstring. `img_size` is the (height, width) after the slice."""

    def __init__(self, in_channels=18, img_size=(256, 192), patch_size=16,
                 padding=2, embed_dim=1280, depth=32, num_heads=16, mlp_ratio=4,
                 qkv_bias=True, drop_path_rate=0.55, eps=1e-6):
        super().__init__()
        self.img_size = tuple(img_size)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(in_channels, embed_dim, patch_size,
                                          patch_size, padding)
        tokens = 1
        for n in self.img_size:
            tokens *= (n + 2 * padding - patch_size) // patch_size + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens + 1, embed_dim))
        rates = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, rate, eps)
            for rate in rates)
        self.last_norm = nn.LayerNorm(embed_dim, eps=eps)
        self.num_features = embed_dim

    def forward(self, x, draws=None):
        H, W = self.img_size
        if x.shape[-2] != H or x.shape[-1] < W or (x.shape[-1] - W) % 2:
            raise ValueError(f"a {tuple(x.shape[-2:])} proxy does not slice to "
                             f"{self.img_size}")
        cut = (x.shape[-1] - W) // 2
        x = self.patch_embed.proj(x[..., cut:cut + W])
        x = x.flatten(2).transpose(1, 2)                      # (B, tokens, C)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for block in self.blocks:
            x = block(x, draws)
        return self.last_norm(x).mean(dim=1)


def vit_h(in_channels=18, proxy_size=256):
    """ViT-H/16 at its published widths over a `proxy_size`^2 proxy, sliced
    to proxy_size x 3/4 proxy_size (256 x 192 at the config's 256)."""
    spec = dict(VIT_H, img_size=(proxy_size, proxy_size * 3 // 4))
    return ViT(in_channels=in_channels, **spec)
