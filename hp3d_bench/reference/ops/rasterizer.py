"""Plain torch z-buffered barycentric rasterizer: the kernel's plain version.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer.py
::rasterize_packed_one :49. Rasterizes one mesh from the packed face tables
of ops/rasterizer_cuda.pack_face_tables, scanning faces in fixed-size chunks
to bound memory (as the JAX package's lax.scan does):

  for each chunk of faces:
      barycentric weights for (pixels x chunk) -> coverage
      z plane evaluated per pixel             -> chunk depth
      winner-take-all vs running z-buffer     -> update depth + attributes

Each arithmetic step is a separate eager op, so nothing contracts into an
FMA: the CUDA kernel evaluates the same expressions with explicitly rounded
multiplies and adds in the same order, and the two agree bit for bit on
mask and depth. The CPU tests use this function; on the card it serves only
as the kernel's yardstick.

Conventions: x = column pixels (right), y = row pixels (down), z = depth
(smaller = closer, z <= znear culled). Pixel (r, c) is sampled at
(x, y) = (c + 0.5, r + 0.5). No backface culling.
"""

import torch

_INF = 1e30


def _snap_chunk(Fp, chunk):
    """Largest divisor of Fp <= chunk."""
    return max(d for d in range(1, min(chunk, Fp) + 1) if Fp % d == 0)


def rasterize_packed_one(geom_t, face_attrs, image_hw, znear=1e-3, chunk=256):
    """Rasterize one mesh from packed face tables.

    :param geom_t: (16, Fp) barycentric-ratio + depth-plane rows
    :param face_attrs: (Fp, 3A) per-face corner attributes
        [attr_v0 | attr_v1 | attr_v2]
    :param image_hw: (H, W)
    :param znear: faces with interpolated depth <= znear are culled
    :param chunk: faces processed per step (rounded down to a divisor of Fp)
    :return: attrs (H, W, A), depth (H, W) (+inf where empty), mask (H, W)
    """
    H, W = image_hw
    A = face_attrs.shape[-1] // 3
    P = H * W
    dtype, device = geom_t.dtype, geom_t.device
    Fp = geom_t.shape[1]
    chunk = _snap_chunk(Fp, chunk)

    px = (torch.arange(W, dtype=dtype, device=device) + 0.5).repeat(H)[:, None]
    py = (torch.arange(H, dtype=dtype, device=device) + 0.5
          ).repeat_interleave(W)[:, None]

    zbuf = torch.full((P,), _INF, dtype=dtype, device=device)
    attr_buf = torch.zeros((P, A), dtype=dtype, device=device)
    for start in range(0, Fp, chunk):
        gc = geom_t[:, start:start + chunk]                # (16, C)
        ca = face_attrs[start:start + chunk]                # (C, 3A)
        w0 = px * gc[0:1] + py * gc[1:2] + gc[2:3]          # (P, C)
        w1 = px * gc[3:4] + py * gc[4:5] + gc[5:6]
        w2 = 1.0 - w0 - w1
        zpix = px * gc[6:7] + py * gc[7:8] + gc[8:9]
        covered = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (zpix > znear)
        zmasked = torch.where(covered, zpix, _INF)

        chunk_zmin = torch.amin(zmasked, dim=1)             # (P,)
        better = chunk_zmin < zbuf
        winner = (zmasked <= chunk_zmin[:, None]) & covered & better[:, None]
        # Ties go to the lowest face index.
        winner &= torch.cumsum(winner, dim=1) == 1
        winner = winner.to(dtype)
        new_attr = ((winner * w0) @ ca[:, :A]
                    + (winner * w1) @ ca[:, A:2 * A]
                    + (winner * w2) @ ca[:, 2 * A:])        # (P, A)
        attr_buf = torch.where(better[:, None], new_attr, attr_buf)
        zbuf = torch.minimum(zbuf, chunk_zmin)

    mask = zbuf < _INF
    depth = torch.where(mask, zbuf, torch.inf)
    return (attr_buf.reshape(H, W, A), depth.reshape(H, W), mask.reshape(H, W))
