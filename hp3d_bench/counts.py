"""The yardstick's arithmetic: operations and bytes from shapes, and the
H100's published peaks.

Peaks: NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates: 67
TFLOP/s in float32 outside the tensor cores (what float32 with TF32 off
runs on) and 3.35 TB/s of HBM3, at the full 700 W power limit. A card set
below it is slower; runs print its limit beside the shares.

Model FLOPs count convolutions and matrix products only: the encoder and
HRNet (from their layers' shapes), the head's linear layers, SMPL's blend
shapes, joint regressors and skinning. Elementwise work, BatchNorm,
pooling, the SVDs, Canny, the sampler and the rasterizer are left out, so
an `mfu` share is a floor of the model's own arithmetic. A trained
predictor's backward counts twice its forward; so does that of the SMPL
calls the loss back-propagates through.
"""

import copy

import torch
from torch import nn

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAKS_SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, SXM, dense: "
                "67 TFLOP/s float32 (no tensor cores), 3.35 TB/s HBM3, 700 W")

# K1's arithmetic (a copy of the port's tools' raster_bound): the
# operations of one pixel-face test, the geometry rows a face's test reads.
OPS_PER_TEST = 19
GEOM_ROWS_READ = 9
# K1c (pack_faces): operations a face, and the geometry rows it writes.
OPS_PER_FACE_PACK = 113 + 36 + 8
GEOM_ROWS_WRITTEN = 16
FACE_CHUNK = 128

SMPL_VERTS = 6890
SMPL_JOINTS = 24
SMPL_POSE_FEATURES = 207
# Rows of the extra, COCO-plus and H36M regressors the 90 joints take.
SMPL_EXTRA_JOINT_ROWS = 9 + 19 + 17


def conv2d_flops(batch, in_channels, out_channels, kernel_hw, out_hw, groups=1):
    """2 x multiply-adds of a convolution: every output value sums
    in_channels / groups x kh x kw products. The bias is left out."""
    kh, kw = kernel_hw
    ho, wo = out_hw
    return 2 * batch * out_channels * ho * wo * (in_channels // groups) * kh * kw


def linear_flops(rows, in_features, out_features):
    """2 x multiply-adds of a linear layer over `rows` inputs, bias left out."""
    return 2 * rows * in_features * out_features


def conv_linear_flops(module, input_shape):
    """The conv and linear FLOPs of one forward of `module` at
    `input_shape`, from the shapes each layer sees: the module runs on the
    meta device (no arithmetic is done; a module elsewhere is copied there)
    with hooks on its Conv2d and Linear layers. `module` must run on meta
    tensors, as plain conv nets do."""
    if any(not t.is_meta for t in module.parameters()):
        module = copy.deepcopy(module).to("meta")
    flops = [0]

    def conv_hook(m, inputs, output):
        flops[0] += conv2d_flops(output.shape[0], m.in_channels, m.out_channels,
                                 m.kernel_size, output.shape[2:], m.groups)

    def linear_hook(m, inputs, output):
        flops[0] += linear_flops(output.numel() // m.out_features,
                                 m.in_features, m.out_features)

    hooks = []
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(linear_hook))
    try:
        with torch.no_grad():
            module(torch.empty(input_shape, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return flops[0]


def predictor_flops(model, proxy_channels, proxy_wh):
    """Forward FLOPs of the distribution predictor for one image: its
    encoder's convolutions at the proxy's shape, and 2 FLOPs per weight of
    each linear layer outside the encoder (each is applied once an image:
    fc1, the shape, camera, global and embedding heads and the 23 joints'
    MLPs)."""
    encoder = conv_linear_flops(model.image_encoder,
                                (1, proxy_channels, proxy_wh, proxy_wh))
    head = sum(2 * m.weight.numel() for name, m in model.named_modules()
               if isinstance(m, nn.Linear) and not name.startswith("image_encoder"))
    return encoder + head


def smpl_flops(num_betas=10):
    """Forward FLOPs of one SMPL mesh: shape and pose blend shapes, the
    24-joint regressor, linear blend skinning (a 4 x 4 transform blended
    from 24 per vertex, then applied) and the 90 joints' regressors."""
    V = SMPL_VERTS
    return (2 * V * 3 * num_betas + 2 * V * 3 * SMPL_POSE_FEATURES
            + 2 * SMPL_JOINTS * V * 3 + 2 * V * SMPL_JOINTS * 16 + 2 * V * 3 * 4
            + 2 * (SMPL_JOINTS + SMPL_EXTRA_JOINT_ROWS) * V * 3)


def train_step_flops(predictor_image_flops, batch, num_samples, num_betas=10):
    """A stage-2 train step: the predictor forward and backward (3x) over
    the batch; SMPL of the mode and of the samples in the loss, forward and
    backward (3x); SMPL of the synthetic targets, their reposed shapes and
    the reposed mean for the metrics, forward only."""
    smpl = smpl_flops(num_betas)
    return (3 * batch * predictor_image_flops
            + 3 * batch * (1 + num_samples) * smpl + 3 * batch * smpl)


def predict_batch_flops(hrnet_image_flops, predictor_image_flops, batch,
                        num_samples, num_betas=10):
    """A `--no_vis` predict batch: HRNet and the predictor forward per
    image, SMPL of the mode and of each uncertainty sample."""
    return (batch * (hrnet_image_flops + predictor_image_flops)
            + batch * (1 + num_samples) * smpl_flops(num_betas))


def eval_batch_flops(predictor_image_flops, batch, num_samples, num_betas=10):
    """An evaluation batch: the predictor forward per frame; SMPL of the
    gendered targets and their reposed shapes, the mode and its reposed
    mean, and each sample posed and reposed."""
    return (batch * predictor_image_flops
            + batch * (4 + 2 * num_samples) * smpl_flops(num_betas))


def pixel_face_tests(screen, faces, hw):
    """The pixel-face tests the rasterizer needs: for each non-degenerate
    face, the pixel centres inside its screen bounding box, clipped to the
    image (no face can cover a pixel outside its box)."""
    H, W = hw
    fv = screen[:, faces]                                # (B, F, 3, 3)
    x, y = fv[..., 0], fv[..., 1]
    area2 = ((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
             - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))

    def centres(lo, hi, n):
        first = torch.clamp(torch.ceil(lo - 0.5), min=0)
        last = torch.clamp(torch.floor(hi - 0.5), max=n - 1)
        return torch.clamp(last - first + 1, min=0).to(torch.int64)

    tests = (centres(x.amin(-1), x.amax(-1), W)
             * centres(y.amin(-1), y.amax(-1), H))
    return int(tests[area2.abs() > 1e-9].sum())


def raster_bound_s(batch, faces, attrs, hw, tests, covered):
    """The least time the card could take for one K1 call (`raster_faces`
    + `resolve`): each input read once (the 9 geometry rows a face's test
    uses and its 3 x `attrs` attributes, for the mesh's `faces` faces), each
    output written once (A attributes, depth and mask a pixel), over the
    memory rate; or the pixel-face tests (`tests`, from pixel_face_tests)
    and the interpolation of A attributes at each of the `covered` pixels,
    over the float32 rate; the larger of the two. The kernel's own scratch
    (its keys, the per-face boxes, padding faces) is not counted, so the
    bound does not move with the design.

    :return: dict s, bytes, ops, by ("bytes" or "operations")
    """
    H, W = hw
    bytes_moved = (4 * batch * GEOM_ROWS_READ * faces + 4 * batch * faces * 3 * attrs
                   + batch * H * W * (4 * attrs + 4 + 1))
    ops = tests * OPS_PER_TEST + covered * 5 * attrs
    bytes_s = bytes_moved / PEAK_BYTES_PER_S
    ops_s = ops / PEAK_F32_FLOPS
    return {"s": max(bytes_s, ops_s), "bytes": bytes_moved, "ops": ops,
            "by": "bytes" if bytes_s >= ops_s else "operations"}


def pack_bound_s(batch, faces, used_vertices, attrs):
    """The least time the card could take for one K1c call (`pack_faces`):
    the four tables written (per face 16 geometry rows, 3 x A attributes, a
    16-byte box; 16 bytes a chunk of FACE_CHUNK faces), the faces read once
    and each mesh's used vertices and attributes read once, over the
    memory rate; or OPS_PER_FACE_PACK operations a face over the float32
    rate. Padding faces are not counted."""
    bytes_moved = (batch * faces * (4 * GEOM_ROWS_WRITTEN + 12 * attrs + 16)
                   + batch * (-(-faces // FACE_CHUNK)) * 16 + 8 * 3 * faces
                   + batch * used_vertices * 4 * (3 + attrs))
    ops = batch * faces * OPS_PER_FACE_PACK
    bytes_s = bytes_moved / PEAK_BYTES_PER_S
    ops_s = ops / PEAK_F32_FLOPS
    return {"s": max(bytes_s, ops_s), "bytes": bytes_moved, "ops": ops,
            "by": "bytes" if bytes_s >= ops_s else "operations"}
