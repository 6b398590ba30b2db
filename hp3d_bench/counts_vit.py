"""Operations of the ViT-H/16 predictor (configs/hp3d-vith.json), beside
counts.py: the conv and linear FLOPs of its layers from their shapes
(counts.conv_linear_flops), and the attention's two batched products,
which no Conv2d or Linear hook sees.
"""

from torch import nn

from hp3d_bench import counts


def attention_flops(tokens, width, depth):
    """2 x multiply-adds of q k^T and of softmax(q k^T) v over all heads of
    `depth` blocks, for one picture: each is tokens^2 x width products a
    block. The softmax and the scaling are left out, as elementwise work is
    in counts.py."""
    return depth * 2 * (2 * tokens * tokens * width)


def vit_encoder_flops(encoder, proxy_channels, proxy_wh):
    """Forward FLOPs of a reference ViT (reference/models/vit.py) for one
    picture: {"conv_linear": its patch embedding and linear layers (from
    their shapes, the encoder run on the meta device in eval mode),
    "attention": the two attention products, "patch_embed": the patch
    embedding's convolution alone, "total"}."""
    encoder = encoder.eval()
    conv_linear = counts.conv_linear_flops(encoder, (1, proxy_channels, proxy_wh,
                                                     proxy_wh))
    proj = encoder.patch_embed.proj
    tokens = encoder.patch_embed.num_patches
    hp, wp = (n // proj.kernel_size[0] for n in encoder.img_size)
    patch = counts.conv2d_flops(1, proj.in_channels, proj.out_channels,
                                proj.kernel_size, (hp, wp))
    attention = attention_flops(tokens, encoder.num_features, len(encoder.blocks))
    return {"conv_linear": conv_linear, "attention": attention,
            "patch_embed": patch, "total": conv_linear + attention}


def predictor_flops(model, proxy_channels, proxy_wh):
    """Forward FLOPs of the ViT predictor for one picture: the encoder's
    (vit_encoder_flops) and 2 FLOPs per weight of each linear layer of the
    head, as counts.predictor_flops counts a ResNet predictor's head."""
    encoder = vit_encoder_flops(model.image_encoder, proxy_channels, proxy_wh)
    head = sum(2 * m.weight.numel() for name, m in model.named_modules()
               if isinstance(m, nn.Linear) and not name.startswith("image_encoder"))
    return encoder["total"] + head, encoder


def encoder_train_flops(encoder):
    """FLOPs of the encoder's forward and backward for one picture: the
    forward, and twice it for the backward, less the patch embedding's input
    gradient (the proxy needs none; its weight gradient is counted).

    :param encoder: vit_encoder_flops' dict
    """
    return 3 * encoder["total"] - encoder["patch_embed"]
