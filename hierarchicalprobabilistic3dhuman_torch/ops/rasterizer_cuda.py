"""Packed face tables and the hand-written CUDA rasterizer's wrapper.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer_pallas.py:
`pack_face_tables` (:97) as torch ops, and `rasterize_packed`, which takes
the place of `rasterize_batched_pallas` (:428). The kernel itself is
csrc/rasterize.cu (it replaces `_raster_kernel`, :240-345); it is compiled
with nvcc at first use into build/hp3d_torch_kernels/ and loaded with ctypes.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors go to the plain torch version in ops/rasterizer.py.
There is no fall-back from one to the other.
"""

import ctypes
import os
import shutil
import subprocess
from functools import lru_cache

import torch

from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer import (
    rasterize_packed_one)

FACE_CHUNK = 128     # faces per chunk: one bounding box, one shared-memory stage
GEOM_ROWS = 16       # packed geometry rows per face (9 used)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PATH = os.path.join(_PKG_DIR, "csrc", "rasterize.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hp3d_torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "librasterize.so")
LOG_PATH = os.path.join(BUILD_DIR, "librasterize.log")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def pack_face_tables(verts_screen, faces, vert_attrs):
    """Per-face geometry + attribute tables and per-chunk screen boxes.

    Faces keep their natural (part-contiguous) order, padded with [0, 0, 0]
    faces to a FACE_CHUNK multiple; each chunk gets a screen bounding box.

    :param verts_screen: (B, V, 3) [x_pix, y_pix, z]
    :param faces: (F, 3) int64
    :param vert_attrs: (B, V, A)
    :return: geom_t (B, 16, Fp) rows [wa0, wb0, wc0, wa1, wb1, wc1, za, zb,
             zc, 0 x 7] with w_k(x, y) = wa_k x + wb_k y + wc_k the k-th
             barycentric weight and z(x, y) = za x + zb y + zc the depth
             plane; face_attrs (B, Fp, 3A) [attr_v0 | attr_v1 | attr_v2];
             chunk_ranges (B, NC, 4) int32 [row_min, row_max, col_min,
             col_max], inclusive
    """
    pad = (-faces.shape[0]) % FACE_CHUNK
    if pad:
        faces = torch.cat([faces, faces.new_zeros((pad, 3))], dim=0)
    fv = verts_screen[:, faces]          # (B, Fp, 3, 3)
    fa = vert_attrs[:, faces]            # (B, Fp, 3, A)
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
    return geom_t, face_attrs, chunk_ranges


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    nvcc = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from csrc/ at first use")
    return nvcc


def build_rasterizer():
    """Compile csrc/rasterize.cu into build/hp3d_torch_kernels/librasterize.so
    (skipped while the library is newer than the source), with nvcc's
    register and shared-memory report in librasterize.log beside it.

    :return: the library path
    """
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC_PATH)):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc()] + NVCC_FLAGS + ["-Xptxas", "-v", "-o", tmp, SRC_PATH],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/rasterize.cu:\n{proc.stdout}")
    with open(LOG_PATH, "w") as f:
        f.write(proc.stdout)
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


@lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_rasterizer())
    fn = lib.hp3d_rasterize
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(t, name, dtype, shape):
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor, got "
                         f"{t.dtype} on {t.device} (contiguous="
                         f"{t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def rasterize_packed_cuda(geom_t, face_attrs, chunk_ranges, image_hw,
                          znear=1e-3):
    """Launch the CUDA rasterizer on packed tables (see pack_face_tables).

    :return: attrs (B, H, W, A), depth (B, H, W) (+inf where empty),
             mask (B, H, W) bool
    """
    B, _, Fp = geom_t.shape
    H, W = image_hw
    A = face_attrs.shape[-1] // 3
    NC = Fp // FACE_CHUNK
    if Fp % FACE_CHUNK:
        raise ValueError(f"face count {Fp} is not a multiple of {FACE_CHUNK}")
    _check(geom_t, "geom_t", torch.float32, (B, GEOM_ROWS, Fp))
    _check(face_attrs, "face_attrs", torch.float32, (B, Fp, 3 * A))
    _check(chunk_ranges, "chunk_ranges", torch.int32, (B, NC, 4))
    if chunk_ranges.data_ptr() % 16:
        raise ValueError("chunk_ranges must be 16-byte aligned (read as int4)")
    device = geom_t.device
    attrs = torch.empty((B, H, W, A), dtype=torch.float32, device=device)
    depth = torch.empty((B, H, W), dtype=torch.float32, device=device)
    mask = torch.empty((B, H, W), dtype=torch.bool, device=device)
    fn = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(geom_t.data_ptr(), face_attrs.data_ptr(),
                 chunk_ranges.data_ptr(), attrs.data_ptr(), depth.data_ptr(),
                 mask.data_ptr(), B, H, W, Fp, A, float(znear), stream)
    if err != 0:
        raise RuntimeError(f"rasterize kernel launch failed: cudaError {err}")
    rasterize_packed_cuda.launches += 1
    return attrs, depth, mask


rasterize_packed_cuda.launches = 0


def rasterize_packed_plain(geom_t, face_attrs, chunk_ranges, image_hw,
                           znear=1e-3):
    """The kernel's plain torch version, one mesh at a time (the chunk boxes
    only speed the kernel up and are not read)."""
    outs = [rasterize_packed_one(g, fa, image_hw, znear=znear)
            for g, fa in zip(geom_t, face_attrs)]
    return tuple(torch.stack(o) for o in zip(*outs))


def rasterize_packed(geom_t, face_attrs, chunk_ranges, image_hw, znear=1e-3):
    """Rasterize packed tables: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors.

    :return: attrs (B, H, W, A), depth (B, H, W), mask (B, H, W)
    """
    if geom_t.is_cuda:
        return rasterize_packed_cuda(geom_t, face_attrs, chunk_ranges,
                                     image_hw, znear)
    if geom_t.device.type != "cpu":
        raise ValueError(f"no rasterizer for device {geom_t.device}")
    return rasterize_packed_plain(geom_t, face_attrs, chunk_ranges, image_hw,
                                  znear)


def rasterize(verts_screen, faces, vert_attrs, image_hw, znear=1e-3):
    """Batched rasterization from screen-space meshes.

    :param verts_screen: (B, V, 3) screen coords [x_pix, y_pix, z]
    :param faces: (F, 3) int64, shared across the batch
    :param vert_attrs: (B, V, A)
    :return: dict attrs (B, H, W, A), depth (B, H, W), mask (B, H, W)
    """
    attrs, depth, mask = rasterize_packed(
        *pack_face_tables(verts_screen, faces, vert_attrs), image_hw, znear)
    return {"attrs": attrs, "depth": depth, "mask": mask}

