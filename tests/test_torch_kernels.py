"""The rasterizer kernel's wrapper, and the kernel against its plain version.

This file imports nothing of JAX, so the card's machine can run it without
the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The `cuda` tests skip where torch finds no CUDA device: a CUDA kernel has
no CPU mode. On the card the kernel must match the plain version bit for
bit on mask and depth, and to 1e-5 on attrs; the face_boxes kernel's boxes
must equal its plain version's.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
from hierarchicalprobabilistic3dhuman_torch.ops import rasterizer_cuda as trc
from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
    X_AXIS, ZERO_T, jet_colormap, six_views)
from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
    TexturedIUVRenderer)
from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import (
    aa_rotate_translate_points)

# Several test files run at once, one per worker: keep torch to 2 threads
# each rather than one per core.
torch.set_num_threads(2)


def _triangle_tables(device="cpu", hw=(64, 64)):
    """Nested faces at two depths, a square split on its diagonal through
    pixel centres (a shared edge), and the same square again at the same
    depth (ties go to the lower face index)."""
    verts = torch.tensor([[
        [4.0, 4.0, 2.0], [28.0, 4.0, 2.0], [4.0, 28.0, 2.0],
        [0.0, 0.0, 5.0], [60.0, 0.0, 5.0], [0.0, 60.0, 5.0],
        [30.5, 30.5, 1.0], [50.5, 30.5, 1.0], [30.5, 50.5, 1.0],
        [50.5, 50.5, 1.0],
    ]], device=device)
    faces = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, 8], [7, 9, 8],
                          [6, 9, 8]], device=device)
    attrs = torch.arange(30, dtype=torch.float32, device=device).reshape(1, 10, 3)
    return trc.pack_face_tables(verts, faces, attrs, hw)


def test_wrapper_dispatch_on_cpu():
    """CPU tensors take the plain version and launch nothing; the kernel
    entry refuses CPU tensors instead of falling back."""
    tables = _triangle_tables(hw=(32, 32))
    before = trc.rasterize_packed_cuda.launches
    out = trc.rasterize_packed(tables)
    plain = trc.rasterize_packed_plain(tables)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert out[2].sum() > 100
    assert trc.rasterize_packed_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        trc.rasterize_packed_cuda(tables)


def test_face_boxes_dispatch_on_cpu():
    """The same for the fourth table's kernel."""
    scene = chip_smoke.triangle_scene("cpu")
    fv, faces = trc.face_vertices(scene.screen, scene.faces)
    assert fv.shape == (1, 128, 3, 3) and faces.shape == (128, 3)
    before = trc.face_boxes_cuda.launches
    boxes = trc.face_boxes(fv, (64, 64))
    assert torch.equal(boxes, trc.face_boxes_plain(fv, (64, 64)))
    assert torch.equal(boxes, scene.tables.face_boxes)
    assert trc.face_boxes_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        trc.face_boxes_cuda(fv, (64, 64))


def test_kernel_source_names_what_it_replaces():
    src = open(trc.SRC_PATH).read()
    assert "rasterizer_pallas.py::" in src and "_raster_kernel" in src
    assert "__fmul_rn" in src and "__fadd_rn" in src
    assert "compute_90a,code=sm_90a" in " ".join(trc.NVCC_FLAGS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _smpl_tables(device, hw):
    rng = np.random.RandomState(3)
    smpl = SMPL.synthetic(device=device)

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    posed = smpl(body_pose=tensor(rng.randn(1, 69) * 0.2))["vertices"]
    rest = smpl(betas=tensor(rng.randn(1, 10)))["vertices"]
    views = six_views(aa_rotate_translate_points(posed, X_AXIS, np.pi, ZERO_T),
                      aa_rotate_translate_points(rest, X_AXIS, np.pi, ZERO_T),
                      jet_colormap(tensor(rng.rand(1, 6890) * 0.2)),
                      tensor([[0.0, -0.2, 2.5]]), tensor([[0.95, 0.95]]))
    renderer = TexturedIUVRenderer(img_wh=hw[0], device=device)
    screen, vert_attrs = renderer.raster_inputs(
        views["vertices"], views["cam_t"], views["orthographic_scale"],
        views["verts_features"])
    return trc.pack_face_tables(screen, renderer.faces, vert_attrs, hw)


def _scene_tables(scene, device, hw):
    """Packed tables of a named scene:
      triangles  shared edges and equal-depth ties
      smpl       the predict path's 6 views, A = 12; at 100 x 90 the meshes
                 are projected for 100 columns, so faces hang off the image
      sliver     chip_smoke.sliver_scene: near-degenerate, off-screen and
                 larger-than-image faces
      eval       1 mesh, A = 3 (256^2)
      batch8     8 perspective meshes, A = 12 (256^2)
      batched4   the batched figure's render of 4 images: 24 meshes, A = 12
      samples    the samples figure's 18 meshes, A = 12
      sil8       the evaluation's mode silhouettes: 8 meshes, A = 3 (256^2)
      sil80      its sample silhouettes: 80 meshes, A = 3 (256^2)
    """
    if scene == "triangles":
        return _triangle_tables(device, hw)
    if scene == "smpl":
        return _smpl_tables(device, hw)
    if scene == "sliver":
        return chip_smoke.sliver_scene(device).tables
    if scene == "eval":
        return chip_smoke.eval_scene(device).tables
    if scene == "batched4":
        return chip_smoke.predict_scene(device, img_wh=hw[0], batch=4).tables
    if scene == "samples":
        return chip_smoke.samples_scene(device, img_wh=hw[0]).tables
    if scene.startswith("sil"):
        return chip_smoke.silhouette_scene(device, batch=int(scene[3:]),
                                           img_wh=hw[0]).tables
    return chip_smoke.train_scene(device, batch=8).tables


@pytest.mark.cuda
@pytest.mark.parametrize("scene,hw", [("triangles", (64, 64)),
                                      ("smpl", (128, 128)),
                                      ("smpl", (100, 90)),
                                      ("sliver", chip_smoke.SLIVER_HW),
                                      ("eval", (256, 256)),
                                      ("batch8", (256, 256)),
                                      ("batched4", (512, 512)),
                                      ("samples", (512, 512)),
                                      ("sil8", (256, 256)),
                                      ("sil80", (256, 256))])
def test_kernel_matches_plain_on_card(cuda_device, scene, hw):
    tables = _scene_tables(scene, cuda_device, hw)
    before = trc.rasterize_packed_cuda.launches
    ka, kd, km = trc.rasterize_packed_cuda(tables)
    pa, pd, pm = trc.rasterize_packed_plain(tables)
    torch.cuda.synchronize()
    assert trc.rasterize_packed_cuda.launches == before + 1
    assert km.sum() > 100
    assert torch.equal(km, pm) and torch.equal(kd, pd)
    assert (ka - pa).abs().max() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("scene,hw", [("smpl", (128, 128)),
                                      ("sliver", chip_smoke.SLIVER_HW)])
def test_kernel_is_deterministic_on_card(cuda_device, scene, hw):
    """The key minimum is commutative: the order in which faces reach a
    pixel cannot show, so two runs on the same tables are bit-identical."""
    tables = _scene_tables(scene, cuda_device, hw)
    first = [t.clone() for t in trc.rasterize_packed_cuda(tables)]
    second = trc.rasterize_packed_cuda(tables)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("scene,hw", [("triangles", (64, 64)),
                                      ("smpl", (100, 90)),
                                      ("sliver", chip_smoke.SLIVER_HW),
                                      ("batch8", (256, 256)),
                                      ("batched4", (512, 512)),
                                      ("samples", (512, 512)),
                                      ("sil8", (256, 256)),
                                      ("sil80", (256, 256))])
def test_face_boxes_kernel_equals_plain_on_card(cuda_device, scene, hw):
    """Tolerance 0: the kernel rounds as the torch ops do. The scenes'
    tables were packed on the card, so their boxes are the kernel's."""
    if scene == "sliver":
        built = chip_smoke.sliver_scene(cuda_device)
    elif scene == "batch8":
        built = chip_smoke.train_scene(cuda_device, batch=8)
    elif scene == "batched4":
        built = chip_smoke.predict_scene(cuda_device, img_wh=hw[0], batch=4)
    elif scene == "samples":
        built = chip_smoke.samples_scene(cuda_device, img_wh=hw[0])
    elif scene == "triangles":
        built = chip_smoke.triangle_scene(cuda_device)
    elif scene.startswith("sil"):
        built = chip_smoke.silhouette_scene(cuda_device, batch=int(scene[3:]))
    else:
        built = chip_smoke.predict_scene(cuda_device, img_wh=hw[1])
    fv, _ = trc.face_vertices(built.screen, built.faces)
    before = trc.face_boxes_cuda.launches
    boxes = trc.face_boxes(fv, hw)
    assert trc.face_boxes_cuda.launches == before + 1
    assert torch.equal(boxes, trc.face_boxes_plain(fv, hw))
    if hw == built.tables.image_hw:
        assert torch.equal(boxes, built.tables.face_boxes)
    assert (boxes[..., 1] >= boxes[..., 0]).sum() > 4


@pytest.mark.cuda
def test_face_boxes_kernel_equals_plain_on_odd_vertices(cuda_device):
    """NaN, infinite, huge and denormal coordinates, and exactly degenerate
    faces, take the same branches in the kernel as in the torch ops."""
    rng = np.random.RandomState(5)
    fv = (rng.rand(2, 256, 3, 3) * 80 - 10).astype(np.float32)
    odd = [np.nan, np.inf, -np.inf, 3e38, -3e38, 1e-40, 0.0, 1e19, -1e19]
    for k in range(2 * 200):
        fv[k % 2, k // 2, rng.randint(3), rng.randint(2)] = odd[k % len(odd)]
    fv[:, 200:230, 2] = fv[:, 200:230, 1]            # two vertices coincide
    fv = torch.as_tensor(fv, device=cuda_device)
    for hw in ((64, 64), (48, 100)):
        assert torch.equal(trc.face_boxes_cuda(fv, hw),
                           trc.face_boxes_plain(fv, hw))


def test_silhouette_tables_carry_the_iuv_alone():
    """The renderer's silhouette mode packs A = 3 (the evaluation's shape),
    and its render on the CPU is IUV, depth and silhouettes, no colour."""
    scene = chip_smoke.silhouette_scene("cpu", batch=2, img_wh=32)
    assert scene.vert_attrs.shape == (2, 7829, 3)
    assert scene.tables.face_attrs.shape[-1] == 9
    renderer = TexturedIUVRenderer("cpu", img_wh=32, render_rgb=False)
    out = renderer(torch.zeros(1, 6890, 3), cam_t=torch.tensor([[0.0, 0.0, 2.5]]),
                   orthographic_scale=torch.ones(1, 2))
    assert sorted(out) == ["depth_images", "iuv_images", "silhouettes"]


@pytest.mark.cuda
def test_gesdd_svd_on_card_equals_cpu(cuda_device):
    """The LAPACK-sign SVD is elementwise ops in a fixed order with its
    square roots in float64: the card gives the CPU's numbers bit for bit
    on 2,000 F + I matrices (tol 0)."""
    from hierarchicalprobabilistic3dhuman_torch.ops.lapack_svd3 import svd3x3_gesdd
    F = torch.as_tensor(np.random.RandomState(5).randn(2000, 3, 3) * 0.5
                        + np.eye(3), dtype=torch.float32)
    card = [a.cpu() for a in svd3x3_gesdd(F.to(cuda_device))]
    cpu = svd3x3_gesdd(F)
    for a, b in zip(card, cpu):
        assert torch.equal(a, b)
