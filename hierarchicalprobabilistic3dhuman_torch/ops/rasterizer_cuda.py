"""Packed face tables and the hand-written CUDA kernels' wrappers.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer_pallas.py:
`pack_face_tables` (:97), with a fourth table of per-face screen boxes for
the CUDA design, and `rasterize_packed`, which takes the place of
`rasterize_batched_pallas` (:428). The kernels are in csrc/rasterize.cu:
`pack_faces`, which builds all four tables in one launch, and the
rasterizer (it replaces `_raster_kernel`, :240-345), a per-face scatter into
a 64-bit z-key buffer and a resolve pass. The file is compiled with nvcc at
first use into build/hp3d_torch_kernels/ (ops/cuda_build.py) and loaded with
ctypes.

Dispatch is by the tensors' device: CUDA tensors launch the kernels (or
raise), CPU tensors go to the plain torch versions (`pack_face_tables_plain`
and ops/rasterizer.py). There is no fall-back from one to the other.
"""

import ctypes
import os
from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from hierarchicalprobabilistic3dhuman_torch.ops.cuda_build import (
    BUILD_DIR, CSRC_DIR, NVCC_FLAGS, build_library)
from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer import (
    rasterize_packed_one)

FACE_CHUNK = 128     # faces per chunk box; the face tables pad to a multiple
GEOM_ROWS = 16       # packed geometry rows per face (9 used)

SRC_PATH = os.path.join(CSRC_DIR, "rasterize.cu")
LIB_PATH = os.path.join(BUILD_DIR, "librasterize.so")
LOG_PATH = os.path.join(BUILD_DIR, "librasterize.log")


class FaceTables(NamedTuple):
    """What pack_face_tables returns and the rasterizers take. The boxes are
    clipped to `image_hw`, so the tables carry it to the rasterizer."""
    geom_t: torch.Tensor
    face_attrs: torch.Tensor
    chunk_ranges: torch.Tensor
    face_boxes: torch.Tensor
    image_hw: Tuple[int, int]

    def to(self, device):
        return FaceTables(*[t.to(device) for t in self[:4]], self.image_hw)


def face_vertices(verts_screen, faces):
    """The faces' vertices, padded with [0, 0, 0] faces to a FACE_CHUNK
    multiple: (B, Fp, 3, 3) [vertex][x_pix, y_pix, z], and the padded faces."""
    pad = (-faces.shape[0]) % FACE_CHUNK
    if pad:
        faces = torch.cat([faces, faces.new_zeros((pad, 3))], dim=0)
    return verts_screen[:, faces], faces


def pack_face_tables_plain(verts_screen, faces, vert_attrs, image_hw):
    """Per-face geometry + attribute tables, per-chunk and per-face screen
    boxes, as torch ops: the plain version of the `pack_faces` kernel, which
    rounds every operation as this does, in this order, so the two give the
    same bits.

    Faces keep their natural (part-contiguous) order, padded with [0, 0, 0]
    faces to a FACE_CHUNK multiple; each chunk gets a screen bounding box
    (the JAX package's table, which the CUDA rasterizer does not read) and
    each face a box of the pixels it can cover (see face_boxes_plain), which
    is all the rasterizer tests.

    :param verts_screen: (B, V, 3) [x_pix, y_pix, z]
    :param faces: (F, 3) int64
    :param vert_attrs: (B, V, A)
    :param image_hw: (H, W) of the image the tables will be rasterized to
    :return: FaceTables: geom_t (B, 16, Fp) rows [wa0, wb0, wc0, wa1, wb1,
             wc1, za, zb, zc, 0 x 7] with w_k(x, y) = wa_k x + wb_k y + wc_k
             the k-th barycentric weight and z(x, y) = za x + zb y + zc the
             depth plane; face_attrs (B, Fp, 3A) [attr_v0 | attr_v1 |
             attr_v2]; chunk_ranges (B, NC, 4) int32 [row_min, row_max,
             col_min, col_max], inclusive; face_boxes (B, Fp, 4) int32, the
             same layout per face in pixel indices, clipped to the image,
             empty ([0, -1, 0, -1]) for degenerate and padding faces; and
             image_hw
    """
    fv, faces = face_vertices(verts_screen, faces)      # (B, Fp, 3, 3)
    fa = vert_attrs[:, faces]                           # (B, Fp, 3, A)
    x, y, z = fv[..., 0], fv[..., 1], fv[..., 2]

    def edge(i, j):
        return (y[..., i] - y[..., j], x[..., j] - x[..., i],
                x[..., i] * y[..., j] - y[..., i] * x[..., j])

    a0, b0, c0 = edge(1, 2)
    a1, b1, c1 = edge(2, 0)
    # denom = 2 x signed area from the vertex coordinates; degenerate faces
    # (incl. padding) pack as w0 == -1 everywhere and are never covered.
    denom = ((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
             - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))
    degenerate = torch.abs(denom) <= 1e-9
    inv = 1.0 / torch.where(degenerate, torch.ones_like(denom), denom)
    zero = torch.zeros_like(denom)
    wa0 = torch.where(degenerate, zero, a0 * inv)
    wb0 = torch.where(degenerate, zero, b0 * inv)
    wc0 = torch.where(degenerate, -torch.ones_like(denom), c0 * inv)
    wa1 = torch.where(degenerate, zero, a1 * inv)
    wb1 = torch.where(degenerate, zero, b1 * inv)
    wc1 = torch.where(degenerate, zero, c1 * inv)
    # z = z2 + w0 (z0 - z2) + w1 (z1 - z2) as a plane in (x, y).
    dz0 = z[..., 0] - z[..., 2]
    dz1 = z[..., 1] - z[..., 2]
    za = wa0 * dz0 + wa1 * dz1
    zb = wb0 * dz0 + wb1 * dz1
    zc = torch.where(degenerate, zero, z[..., 2] + wc0 * dz0 + wc1 * dz1)
    geom_t = torch.stack([wa0, wb0, wc0, wa1, wb1, wc1, za, zb, zc]
                         + [zero] * (GEOM_ROWS - 9), dim=-2)   # (B, 16, Fp)
    B, Fp = x.shape[:2]
    face_attrs = fa.reshape(B, Fp, -1)

    # Per-chunk screen boxes; degenerate faces get an empty range, so a
    # chunk of padding never runs.
    NC = Fp // FACE_CHUNK

    def axis_ranges(coord):
        lo = torch.where(degenerate, 1e9, torch.amin(coord, dim=-1))
        hi = torch.where(degenerate, -1e9, torch.amax(coord, dim=-1))
        lo = torch.floor(torch.amin(lo.reshape(B, NC, FACE_CHUNK), dim=-1))
        hi = torch.ceil(torch.amax(hi.reshape(B, NC, FACE_CHUNK), dim=-1))
        return torch.clamp(lo, -1e9, 1e9), torch.clamp(hi, -1e9, 1e9)

    rmin, rmax = axis_ranges(y)
    cmin, cmax = axis_ranges(x)
    chunk_ranges = torch.stack([rmin, rmax, cmin, cmax], dim=-1).to(torch.int32)
    H, W = image_hw
    return FaceTables(geom_t, face_attrs, chunk_ranges,
                      face_boxes_plain(fv, (H, W)), (H, W))


def face_boxes_plain(face_verts, image_hw):
    """Per-face boxes of the pixels a face can cover, as torch ops: the fourth
    table of pack_face_tables_plain, which the `pack_faces` kernel computes
    with every operation rounded as here, in this order.

    The rule. Coverage is decided from the *rounded* float32 planes of
    pack_face_tables, not from the exact triangle, so a face can cover a
    pixel centre outside the bounding box of its vertices. Let W_k be the
    exact barycentric weights of the float vertices, d the computed denom
    and u = 2^-24. Over the image's pixel centres the computed weights are
    s W_k + e_k with |s - 1| <= rho and
        rho  = 8u (|dx10 dy20| + |dy10 dx20|) / |d|     (denom's cancellation)
        e_k <= u (6 (|a_k| W + |b_k| H) + 1.5 S_k + 5 |c_k|) / |d|
    where S_k = |x_i y_j| + |y_i x_j| are the products whose difference is
    c_k. A covered pixel has all computed weights >= 0, hence every
    W_k >= -E with E = (rho + e_0 + e_1 + 4u) / (1 - rho): it lies in the
    triangle scaled about its centroid by 1 + 3E, whose bounding box is the
    vertices' box grown by at most 2E times its extent on each side. The
    boxes take twice that E (and a few ulp of the coordinates, for the
    box's own rounding). Where rho >= 1/2 or anything is not finite, the
    sign of d itself is in doubt and the face gets the whole image. On SMPL
    at 512^2 the margin is ~0.01 px; a sliver of 100 x 0.01 px gets tens of
    pixels, and one with |d| ~ 1e-8 the whole image.
    tests/test_torch_raster_boxes.py holds every covered (pixel, face) pair
    inside these boxes.

    :param face_verts: (B, Fp, 3, 3) [vertex][x_pix, y_pix, z]
    :return: (B, Fp, 4) int32 [row_min, row_max, col_min, col_max] of pixel
             indices, inclusive, clipped to the image; [0, -1, 0, -1] for
             degenerate faces
    """
    H, W = image_hw
    x, y = face_verts[..., 0], face_verts[..., 1]
    u = 2.0 ** -24

    def plane_error(i, j):
        a, b = y[..., i] - y[..., j], x[..., j] - x[..., i]
        q, r = x[..., i] * y[..., j], y[..., i] * x[..., j]
        s = torch.abs(q) + torch.abs(r)
        return (6.0 * (torch.abs(a) * W + torch.abs(b) * H) + 1.5 * s
                + 5.0 * torch.abs(q - r))

    p1 = (x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
    p2 = (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0])
    denom = p1 - p2
    degenerate = torch.abs(denom) <= 1e-9
    scale = u / torch.abs(denom)
    rho = 8.0 * scale * (torch.abs(p1) + torch.abs(p2))
    E = 2.0 * (rho + scale * (plane_error(1, 2) + plane_error(2, 0))
               + 4.0 * u) / (1.0 - rho)
    E = torch.where(torch.isfinite(E) & (rho < 0.5), E, torch.inf)

    def axis_box(coord, n):
        lo, hi = torch.amin(coord, dim=-1), torch.amax(coord, dim=-1)
        margin = (2.0 * E * (hi - lo)
                  + 8.0 * u * torch.maximum(torch.abs(lo), torch.abs(hi)))
        # The whole axis where the margin (or a coordinate) is not finite.
        first = torch.nan_to_num(torch.ceil(lo - margin - 0.5), nan=0.0)
        last = torch.nan_to_num(torch.floor(hi + margin - 0.5), nan=float(n))
        first = torch.where(degenerate, 0.0, torch.clamp(first, 0, n))
        last = torch.where(degenerate, -1.0, torch.clamp(last, -1, n - 1))
        return first, last

    rmin, rmax = axis_box(y, H)
    cmin, cmax = axis_box(x, W)
    return torch.stack([rmin, rmax, cmin, cmax], dim=-1).to(torch.int32)


def build_rasterizer():
    """Compile csrc/rasterize.cu into build/hp3d_torch_kernels/librasterize.so
    (skipped while the library is newer than the source), with nvcc's
    register and shared-memory report in librasterize.log beside it.

    :return: the library path
    """
    return build_library(SRC_PATH, LIB_PATH, LOG_PATH)


@lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_rasterizer())
    lib.hp3d_rasterize.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                   + [ctypes.c_float, ctypes.c_void_p])
    lib.hp3d_rasterize.restype = ctypes.c_int
    lib.hp3d_pack_faces.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                    + [ctypes.c_void_p])
    lib.hp3d_pack_faces.restype = ctypes.c_int
    return lib


def _check_znear(znear):
    """The z-key orders depths by their bit patterns, which holds for
    positive floats only; z > znear > 0 keeps all others out."""
    if not znear > 0:
        raise ValueError(f"znear must be > 0, got {znear}")


def _check(t, name, dtype, shape, align=16):
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor, got "
                         f"{t.dtype} on {t.device} (contiguous="
                         f"{t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def pack_face_tables_cuda(verts_screen, faces, vert_attrs, image_hw):
    """Launch the `pack_faces` kernel: the four tables of
    pack_face_tables_plain (see its docstring) in one launch on the current
    stream, bit for bit as its torch ops give them on the card. It has no
    backward: an input that requires grad under grad mode raises.

    :param verts_screen: (B, V, 3) float32 on the card
    :param faces: (F, 3) int64 on the card, indices in [0, V)
    :param vert_attrs: (B, V, A) float32 on the card
    :return: FaceTables
    """
    if torch.is_grad_enabled() and (verts_screen.requires_grad
                                    or vert_attrs.requires_grad):
        raise RuntimeError("pack_face_tables_cuda has no backward: call it "
                           "under torch.no_grad()")
    B, V = verts_screen.shape[:2]
    F, A = faces.shape[0], vert_attrs.shape[-1]
    _check(verts_screen, "verts_screen", torch.float32, (B, V, 3), align=4)
    _check(faces, "faces", torch.int64, (F, 3), align=8)
    _check(vert_attrs, "vert_attrs", torch.float32, (B, V, A), align=4)
    device = verts_screen.device
    if faces.device != device or vert_attrs.device != device:
        raise ValueError(f"pack_face_tables_cuda: inputs on {device}, "
                         f"{faces.device} and {vert_attrs.device}")
    H, W = image_hw
    Fp = F + (-F) % FACE_CHUNK
    geom_t = torch.empty((B, GEOM_ROWS, Fp), dtype=torch.float32, device=device)
    face_attrs = torch.empty((B, Fp, 3 * A), dtype=torch.float32, device=device)
    chunk_ranges = torch.empty((B, Fp // FACE_CHUNK, 4), dtype=torch.int32,
                               device=device)
    face_boxes = torch.empty((B, Fp, 4), dtype=torch.int32, device=device)
    tables = FaceTables(geom_t, face_attrs, chunk_ranges, face_boxes, (H, W))
    if B * Fp == 0:                      # nothing to pack (a launch of no blocks fails)
        return tables
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().hp3d_pack_faces(
            verts_screen.data_ptr(), faces.data_ptr(), vert_attrs.data_ptr(),
            geom_t.data_ptr(), face_attrs.data_ptr(), chunk_ranges.data_ptr(),
            face_boxes.data_ptr(), B, V, F, Fp, A, H, W, stream)
    if err != 0:
        raise RuntimeError(f"pack_faces kernel launch failed: cudaError {err}")
    pack_face_tables_cuda.launches += 1
    return tables


pack_face_tables_cuda.launches = 0


def pack_face_tables(verts_screen, faces, vert_attrs, image_hw):
    """The four face tables (pack_face_tables_plain's docstring): the
    `pack_faces` kernel for CUDA tensors, the plain torch version for CPU
    tensors.

    :return: FaceTables
    """
    device = verts_screen.device
    if device.type == "cuda":
        return pack_face_tables_cuda(verts_screen, faces, vert_attrs, image_hw)
    if device.type != "cpu":
        raise ValueError(f"no pack_face_tables for device {device}")
    return pack_face_tables_plain(verts_screen, faces, vert_attrs, image_hw)


def rasterize_packed_cuda(tables, znear=1e-3):
    """Launch the CUDA rasterizer on packed tables (a FaceTables; the image
    is the one they were packed for). One call is three launches on the
    current stream: the z-key buffer's memset, the per-face scatter and the
    resolve pass. The chunk boxes are not read.

    :return: attrs (B, H, W, A), depth (B, H, W) (+inf where empty),
             mask (B, H, W) bool
    """
    _check_znear(znear)
    geom_t, face_attrs, _, face_boxes, (H, W) = tables
    B, _, Fp = geom_t.shape
    A = face_attrs.shape[-1] // 3
    _check(geom_t, "geom_t", torch.float32, (B, GEOM_ROWS, Fp))
    _check(face_attrs, "face_attrs", torch.float32, (B, Fp, 3 * A))
    _check(face_boxes, "face_boxes", torch.int32, (B, Fp, 4))
    device = geom_t.device
    attrs = torch.empty((B, H, W, A), dtype=torch.float32, device=device)
    depth = torch.empty((B, H, W), dtype=torch.float32, device=device)
    mask = torch.empty((B, H, W), dtype=torch.bool, device=device)
    zkey = torch.empty((B, H, W), dtype=torch.int64, device=device)
    fn = _library().hp3d_rasterize
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(geom_t.data_ptr(), face_attrs.data_ptr(),
                 face_boxes.data_ptr(), zkey.data_ptr(), attrs.data_ptr(),
                 depth.data_ptr(), mask.data_ptr(), B, H, W, Fp, A,
                 float(znear), stream)
    if err != 0:
        raise RuntimeError(f"rasterize kernel launch failed: cudaError {err}")
    rasterize_packed_cuda.launches += 1
    return attrs, depth, mask


rasterize_packed_cuda.launches = 0


def rasterize_packed_plain(tables, znear=1e-3):
    """The kernel's plain torch version, one mesh at a time (the boxes only
    speed the kernel up and are not read)."""
    outs = [rasterize_packed_one(g, fa, tables.image_hw, znear=znear)
            for g, fa in zip(tables.geom_t, tables.face_attrs)]
    return tuple(torch.stack(o) for o in zip(*outs))


def rasterize_packed(tables, znear=1e-3):
    """Rasterize packed tables: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors.

    :return: attrs (B, H, W, A), depth (B, H, W), mask (B, H, W)
    """
    _check_znear(znear)
    device = tables.geom_t.device
    if device.type == "cuda":
        return rasterize_packed_cuda(tables, znear)
    if device.type != "cpu":
        raise ValueError(f"no rasterizer for device {device}")
    return rasterize_packed_plain(tables, znear)


def rasterize(verts_screen, faces, vert_attrs, image_hw, znear=1e-3):
    """Batched rasterization from screen-space meshes.

    :param verts_screen: (B, V, 3) screen coords [x_pix, y_pix, z]
    :param faces: (F, 3) int64, shared across the batch
    :param vert_attrs: (B, V, A)
    :return: dict attrs (B, H, W, A), depth (B, H, W), mask (B, H, W)
    """
    attrs, depth, mask = rasterize_packed(
        pack_face_tables(verts_screen, faces, vert_attrs, image_hw), znear)
    return {"attrs": attrs, "depth": depth, "mask": mask}
