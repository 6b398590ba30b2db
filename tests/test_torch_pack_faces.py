"""The face tables on the CPU against the JAX package, and the two A-pose
helpers of utils/eval_utils.py against JAX's.

On the CPU, ops/rasterizer_cuda.py::pack_face_tables takes its plain
version, pack_face_tables_plain, which the pack_faces kernel equals bit for
bit on the card (tests/test_torch_kernels.py). Here that plain path is held
to JAX's hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer_pallas.py::
pack_face_tables on six synthetic-SMPL views as the predict path poses
them, with three faces added: a repeated vertex and three collinear
vertices (both exactly degenerate) and a sliver 50 px long and 0.02 px
wide across the pixel centres of row 40. The scene has 13,777 faces, not a
multiple of 128, so the last chunk holds padding faces.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_tpu.models.smpl import SMPL as JSMPL
from hierarchicalprobabilistic3dhuman_tpu.ops import rasterizer_pallas as jrp
from hierarchicalprobabilistic3dhuman_tpu.utils.eval_utils import (
    make_xz_ground_plane as j_ground_plane,
    shape_parameters_to_a_pose as j_a_pose)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL as TSMPL
from hierarchicalprobabilistic3dhuman_torch.ops import rasterizer_cuda as trc
from hierarchicalprobabilistic3dhuman_torch.utils.eval_utils import (
    make_xz_ground_plane as t_ground_plane,
    shape_parameters_to_a_pose as t_a_pose)

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)

HW = (64, 64)


@pytest.fixture(scope="module")
def scene():
    """screen (6, V + 6, 3), faces (13777, 3) int64, attrs (6, V + 6, 12),
    and the indices of the added faces: repeated, collinear, sliver."""
    base = chip_smoke.predict_scene("cpu", img_wh=HW[0])
    B, V = base.screen.shape[:2]
    added = torch.tensor([[10.0, 10.0, 2.0], [20.0, 20.0, 2.5], [30.0, 30.0, 3.0],
                          [5.0, 40.49, 2.0], [55.0, 40.5, 2.2], [5.5, 40.51, 2.4]])
    screen = torch.cat([base.screen, added.expand(B, 6, 3)], dim=1)
    rng = np.random.RandomState(7)
    attrs = torch.cat([base.vert_attrs,
                       torch.as_tensor(rng.rand(B, 6, base.vert_attrs.shape[-1]),
                                       dtype=torch.float32)], dim=1)
    F = base.faces.shape[0]
    faces = torch.cat([base.faces, torch.tensor([[3, 3, 7], [V, V + 1, V + 2],
                                                 [V + 3, V + 4, V + 5]])])
    return screen, faces, attrs, (F, F + 1, F + 2)


def test_pack_face_tables_matches_jax_on_smpl_views(scene):
    """face_attrs and chunk_ranges equal to JAX's; geom_t within 1e-5
    relative to max(|x|, 1) (XLA may contract a product and a sum into one
    rounding, eager torch rounds each op; as in
    tests/test_torch_rasterizer.py); the boxes equal to face_boxes_plain on
    the padded faces' vertices; no launch of the kernel."""
    screen, faces, attrs, (repeated, collinear, sliver) = scene
    assert faces.shape[0] % trc.FACE_CHUNK != 0
    before = trc.pack_face_tables_cuda.launches
    port = trc.pack_face_tables(screen, faces, attrs, HW)
    assert trc.pack_face_tables_cuda.launches == before
    ref = jrp.pack_face_tables(jnp.asarray(screen.numpy()),
                               jnp.asarray(faces.numpy().astype(np.int32)),
                               jnp.asarray(attrs.numpy()))
    assert [tuple(t.shape) for t in port[:3]] == [r.shape for r in ref]
    np.testing.assert_array_equal(port.face_attrs.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(port.chunk_ranges.numpy(), np.asarray(ref[2]))
    g_p, g_r = port.geom_t.numpy(), np.asarray(ref[0])
    rel = np.abs(g_p - g_r) / np.maximum(np.abs(g_r), 1.0)
    print(f"geometry rows: max diff relative to max(|x|, 1) {rel.max():.2e}")
    assert rel.max() <= 1e-5
    fv, _ = trc.face_vertices(screen, faces)
    assert torch.equal(port.face_boxes, trc.face_boxes_plain(fv, HW))
    # The degenerate faces (and the padding) pack as never covered, with
    # empty boxes; the sliver does not.
    for f in (repeated, collinear, faces.shape[0]):
        assert port.geom_t[:, 2, f].eq(-1.0).all()
        assert port.geom_t[:, 8, f].eq(0.0).all()
        assert port.face_boxes[:, f].eq(torch.tensor([0, -1, 0, -1],
                                                     dtype=torch.int32)).all()
    assert port.geom_t[:, 2, sliver].ne(-1.0).all()
    assert (port.face_boxes[:, sliver, 1] >= port.face_boxes[:, sliver, 0]).all()


@pytest.fixture(scope="module")
def a_pose_verts():
    """JAX's and the port's A-pose vertices of two random shapes, B = 2."""
    betas = np.random.RandomState(11).randn(2, 10).astype(np.float32)
    ref = np.asarray(j_a_pose(jnp.asarray(betas), JSMPL.synthetic()))
    port = t_a_pose(torch.as_tensor(betas), TSMPL.synthetic(device="cpu"))
    return ref, port


def test_shape_parameters_to_a_pose_matches_jax(a_pose_verts):
    """Vertices within 1e-5 of JAX's."""
    ref, port = a_pose_verts
    assert port.shape == (2, 6890, 3)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_make_xz_ground_plane_matches_jax(a_pose_verts, kind):
    """Equal to JAX's for a numpy array (both copy it) and for a tensor
    (both return a new one); the input is left as it was."""
    ref_verts = a_pose_verts[0].copy()
    if kind == "numpy":
        given = ref_verts.copy()
        port = t_ground_plane(given)
        ref = j_ground_plane(ref_verts.copy())
        np.testing.assert_array_equal(given, ref_verts)
    else:
        given = torch.as_tensor(ref_verts.copy())
        port = t_ground_plane(given).numpy()
        ref = np.asarray(j_ground_plane(jnp.asarray(ref_verts)))
        assert torch.equal(given, torch.as_tensor(ref_verts))
    assert type(port) is np.ndarray
    np.testing.assert_array_equal(port, ref)
    assert np.all(port[:, :, 1].min(axis=-1) == 0.0)
