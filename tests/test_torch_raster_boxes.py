"""The per-face screen boxes and the z-key minimum of the CUDA rasterizer.

The kernel (csrc/rasterize.cu) tests a face only at the pixels of its
`face_boxes` entry and keeps, per pixel, the minimum of a 64-bit key
(depth bits, face index). Both ideas are held here on the CPU against the
plain rasterizer, which decides coverage from rounded float32 planes:

  * every (pixel, face) pair the plain expressions mark covered lies inside
    that face's box (exact: no pair may fall outside);
  * a torch emulation of the key minimum over shuffled face orders equals
    the plain version: mask and depth bit for bit, attrs to 1e-5 (the same
    bar the kernel is held to on the card; 0 is expected, since the winner's
    attributes are interpolated by the same rounded expressions).

This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke
from hierarchicalprobabilistic3dhuman_torch.ops import rasterizer_cuda as trc

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

ZNEAR = 1e-3


def _coverage(geom, hw, znear=ZNEAR):
    """Coverage and depth of every face of one mesh at every pixel centre,
    by the plain rasterizer's expressions: covered (H, W, Fp), z (H, W, Fp)."""
    H, W = hw
    px = (torch.arange(W, dtype=torch.float32) + 0.5)[None, :, None]
    py = (torch.arange(H, dtype=torch.float32) + 0.5)[:, None, None]
    w0 = px * geom[0] + py * geom[1] + geom[2]
    w1 = px * geom[3] + py * geom[4] + geom[5]
    w2 = 1.0 - w0 - w1
    z = px * geom[6] + py * geom[7] + geom[8]
    return (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z > znear), z


def _outside_box(tables, face_block=512):
    """Covered (pixel, face) pairs outside the face's box, and all covered
    pairs, over a batch of packed tables."""
    geom_t, _, _, boxes, hw = tables
    H, W = hw
    rows = torch.arange(H)[:, None, None]
    cols = torch.arange(W)[None, :, None]
    outside = covered_pairs = 0
    for g, bx in zip(geom_t, boxes):
        for f0 in range(0, g.shape[1], face_block):
            covered, _ = _coverage(g[:, f0:f0 + face_block], hw)
            b = bx[f0:f0 + face_block]
            inside = ((rows >= b[:, 0]) & (rows <= b[:, 1])
                      & (cols >= b[:, 2]) & (cols <= b[:, 3]))
            outside += int((covered & ~inside).sum())
            covered_pairs += int(covered.sum())
    return outside, covered_pairs


def _check_boxes_clipped(boxes, hw):
    H, W = hw
    assert boxes.dtype == torch.int32
    assert int(boxes[..., 0].min()) >= 0 and int(boxes[..., 1].max()) <= H - 1
    assert int(boxes[..., 2].min()) >= 0 and int(boxes[..., 3].max()) <= W - 1


@pytest.mark.parametrize("img_wh", [64, 128])
def test_box_invariant_smpl_views(img_wh):
    """The predict path's 6 SMPL views: no covered pair outside its box, and
    the boxes stay tight (the tests they ask for are within 1.3x of the
    pixel centres inside the vertices' own boxes)."""
    screen, faces, _, tables = chip_smoke.predict_scene("cpu", img_wh=img_wh)
    hw = (img_wh, img_wh)
    assert tables.image_hw == hw
    _check_boxes_clipped(tables[3], hw)
    outside, covered = _outside_box(tables)
    print(f"smpl {img_wh}^2: {covered} covered pairs, {outside} outside")
    assert covered > 10000 and outside == 0
    made = chip_smoke.box_tests(tables[3])
    needed = chip_smoke.pixel_face_tests(screen, faces, hw)
    print(f"smpl {img_wh}^2: box tests {made}, needed {needed}")
    assert needed <= made <= 1.3 * needed
    # Padding faces are degenerate: empty boxes.
    pad = tables[3][:, faces.shape[0]:]
    assert torch.equal(pad, torch.tensor([0, -1, 0, -1], dtype=torch.int32
                                         ).expand_as(pad))


def test_box_invariant_sliver_scene():
    """Slivers down to |denom| 1e-8, off-screen faces and a face larger than
    the image; some slivers do cover pixels outside their vertices' box
    (which is why the boxes carry a margin), none outside its face box."""
    screen, faces, _, tables = chip_smoke.sliver_scene("cpu")
    hw = chip_smoke.SLIVER_HW
    _check_boxes_clipped(tables[3], hw)
    outside, covered = _outside_box(tables)
    no_margin = list(tables)
    fv = screen[:, faces]
    lo, hi = fv.amin(2), fv.amax(2)                       # (B, F, 3)
    tight = torch.stack([torch.floor(lo[..., 1]), torch.ceil(hi[..., 1]),
                         torch.floor(lo[..., 0]), torch.ceil(hi[..., 0])], -1)
    no_margin[3] = tables[3].clone()
    no_margin[3][:, :faces.shape[0]] = tight.clamp(-1e6, 1e6).to(torch.int32)
    outside_tight, _ = _outside_box(no_margin)
    print(f"sliver scene: {covered} covered pairs, {outside} outside the face "
          f"boxes, {outside_tight} outside the vertices' floor/ceil boxes")
    assert covered > 10000 and outside == 0
    assert outside_tight > 0


coord = st.floats(min_value=-40.0, max_value=100.0, width=32)


@st.composite
def triangles(draw):
    """A triangle in or around a 48 x 56 image: three free vertices; a
    near-degenerate one (the third vertex a hair off the first edge); or an
    all but collinear one along a line of pixel centres, the third vertex a
    few float32 steps off it (denom is rounding noise there)."""
    kind = draw(st.integers(min_value=0, max_value=2))
    if kind == 2:
        x0 = draw(st.integers(min_value=0, max_value=55)) + 0.5
        y0 = draw(st.integers(min_value=0, max_value=47)) + 0.5
        sx, sy = draw(st.sampled_from([(1, 1), (1, -1), (2, 1), (1, 2),
                                       (3, -1), (1, 0), (0, 1), (-2, 3)]))
        n = draw(st.integers(min_value=1, max_value=20))
        m = draw(st.integers(min_value=0, max_value=20))
        p2 = np.array([x0 + m * sx, y0 + m * sy], np.float32)
        axis = draw(st.integers(min_value=0, max_value=1))
        steps = draw(st.integers(min_value=-8, max_value=8))
        for _ in range(abs(steps)):
            p2[axis] = np.nextafter(p2[axis], np.float32(np.sign(steps) * np.inf))
        return [[x0, y0], [x0 + n * sx, y0 + n * sy], [float(p2[0]), float(p2[1])]]
    x0, y0, x1, y1 = (draw(coord) for _ in range(4))
    if kind == 0:
        return [[x0, y0], [x1, y1], [draw(coord), draw(coord)]]
    t = draw(st.floats(min_value=-0.5, max_value=1.5, width=32))
    off = draw(st.floats(min_value=-2.0 ** -7, max_value=2.0 ** -7, width=32))
    scale = 10.0 ** draw(st.integers(min_value=-5, max_value=0))
    return [[x0, y0], [x1, y1], [x0 + t * (x1 - x0) - off * scale * (y1 - y0),
                                 y0 + t * (y1 - y0) + off * scale * (x1 - x0)]]


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.lists(triangles(), min_size=1, max_size=8))
def test_box_invariant_drawn_triangles(tris):
    hw = (48, 56)
    xy = torch.tensor(tris, dtype=torch.float32).reshape(1, -1, 2)
    verts = torch.cat([xy, torch.full_like(xy[..., :1], 2.0)], dim=-1)
    faces = torch.arange(verts.shape[1]).reshape(-1, 3)
    tables = trc.pack_face_tables(verts, faces, verts, hw)
    _check_boxes_clipped(tables[3], hw)
    outside, _ = _outside_box(tables)
    assert outside == 0


def _rasterize_by_key_minimum(geom, fattr, boxes, hw, order, znear=ZNEAR):
    """The kernel's algorithm in torch, one mesh: faces arrive in `order`,
    each scatters key = depth bits << 32 | face index at the covered pixels
    of its box with a minimum; the resolve pass decodes the winner and
    interpolates its attributes by the plain version's expressions."""
    H, W = hw
    A = fattr.shape[-1] // 3
    covered, z = _coverage(geom, hw, znear)
    rows = torch.arange(H)[:, None, None]
    cols = torch.arange(W)[None, :, None]
    in_box = ((rows >= boxes[:, 0]) & (rows <= boxes[:, 1])
              & (cols >= boxes[:, 2]) & (cols <= boxes[:, 3]))
    hit = covered & in_box & (z < 1e30)
    pix, face = hit.reshape(H * W, -1)[:, order].nonzero(as_tuple=True)
    face = order[face]
    zbits = z.reshape(H * W, -1)[pix, face].view(torch.int32).to(torch.int64)
    assert int(zbits.min()) > 0                  # positive floats order as ints
    empty = torch.iinfo(torch.int64).max
    keys = torch.full((H * W,), empty).scatter_reduce(
        0, pix, (zbits << 32) | face, reduce="amin")
    mask = keys != empty
    win = torch.where(mask, keys & 0xFFFFFFFF, 0)
    depth = torch.where(mask, (keys >> 32).to(torch.int32).view(torch.float32),
                        torch.inf)
    g = geom[:, win]                                        # (16, P)
    px = (torch.arange(W, dtype=torch.float32) + 0.5).repeat(H)
    py = (torch.arange(H, dtype=torch.float32) + 0.5).repeat_interleave(W)
    w0 = px * g[0] + py * g[1] + g[2]
    w1 = px * g[3] + py * g[4] + g[5]
    w2 = 1.0 - w0 - w1
    fa = fattr[win]                                         # (P, 3A)
    attrs = (w0[:, None] * fa[:, :A] + w1[:, None] * fa[:, A:2 * A]
             + w2[:, None] * fa[:, 2 * A:])
    attrs = torch.where(mask[:, None], attrs, 0.0)
    return attrs.reshape(H, W, A), depth.reshape(H, W), mask.reshape(H, W)


@pytest.mark.parametrize("scene", ["sliver", "triangles", "smpl"])
def test_key_minimum_equals_plain_for_any_face_order(scene):
    if scene == "sliver":
        tables = chip_smoke.sliver_scene("cpu").tables
    elif scene == "triangles":
        tables = chip_smoke.triangle_scene("cpu").tables
    else:
        tables = chip_smoke.predict_scene("cpu", img_wh=48).tables
        tables = trc.FaceTables(*[t[4:5] for t in tables[:4]], tables.image_hw)
    hw = tables.image_hw
    pa, pd, pm = trc.rasterize_packed_plain(tables)
    assert pm.sum() > 100
    for b in range(tables.geom_t.shape[0]):
        one = (tables.geom_t[b], tables.face_attrs[b], tables.face_boxes[b])
        for seed in (0, 1):
            order = torch.randperm(one[0].shape[1],
                                   generator=torch.Generator().manual_seed(seed))
            ka, kd, km = _rasterize_by_key_minimum(*one, hw, order)
            assert torch.equal(km, pm[b]) and torch.equal(kd, pd[b])
            err = float((ka - pa[b]).abs().max())
            print(f"{scene} mesh {b} shuffle {seed}: attrs max abs diff {err:.2e}")
            assert err <= 1e-5


def test_nonpositive_znear_is_refused():
    """The key orders depths by their bits, which needs z > znear > 0."""
    tables = chip_smoke.triangle_scene("cpu").tables
    for znear in (0.0, -1.0):
        with pytest.raises(ValueError, match="znear"):
            trc.rasterize_packed(tables, znear=znear)
        with pytest.raises(ValueError, match="znear"):
            trc.rasterize_packed_cuda(tables, znear=znear)
