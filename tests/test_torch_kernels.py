"""The CUDA kernels' wrappers, and the kernels against their plain versions.

This file imports nothing of JAX, so the card's machine can run it without
the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The `cuda` tests skip where torch finds no CUDA device: a CUDA kernel has
no CPU mode. On the card the kernel must match the plain version bit for
bit on mask and depth, and to 1e-5 on attrs; the pack_faces kernel's four
tables must equal its plain version's (the torch ops on the card) bit for
bit; the svd3_gesdd kernel's U, S and V must equal svd3x3_gesdd_plain's on
the card bit for bit (a NaN equal to any NaN), with the same count of QR
loop iterations, and with no host sync.
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
    PoseMFShapeGaussianNet)
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights
from hierarchicalprobabilistic3dhuman_torch.ops import lapack_svd3
from hierarchicalprobabilistic3dhuman_torch.ops import rasterizer_cuda as trc
from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import (
    span, spans_between)
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
    """The same for the face tables, whose fourth is the boxes: CPU tensors
    take pack_face_tables_plain and launch nothing; the pack_faces kernel's
    entry refuses CPU tensors instead of falling back, and refuses inputs
    that require grad under grad mode (it has no backward)."""
    scene = chip_smoke.triangle_scene("cpu")
    hw = scene.tables.image_hw
    inputs = (scene.screen, scene.faces, scene.vert_attrs, hw)
    before = trc.pack_face_tables_cuda.launches
    tables = trc.pack_face_tables(*inputs)
    plain = trc.pack_face_tables_plain(*inputs)
    assert tables.geom_t.shape == (1, 16, 128) and tables.image_hw == hw
    for a, b in zip(tables[:4], plain[:4]):
        assert torch.equal(a, b)
    fv, faces = trc.face_vertices(scene.screen, scene.faces)
    assert fv.shape == (1, 128, 3, 3) and faces.shape == (128, 3)
    assert torch.equal(tables.face_boxes, trc.face_boxes_plain(fv, hw))
    assert trc.pack_face_tables_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        trc.pack_face_tables_cuda(*inputs)
    with pytest.raises(RuntimeError, match="no backward"):
        trc.pack_face_tables_cuda(scene.screen.clone().requires_grad_(),
                                  *inputs[1:])
    assert trc.pack_face_tables_cuda.launches == before


def test_kernel_source_names_what_it_replaces():
    src = open(trc.SRC_PATH).read()
    assert "rasterizer_pallas.py::" in src and "_raster_kernel" in src
    assert "__fmul_rn" in src and "__fadd_rn" in src and "__frcp_rn" in src
    assert "pack_faces" in src and "face_boxes(" not in src
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
    renderer = TexturedIUVRenderer(device, img_wh=hw[0], projection_type="orthographic",
                                   render_rgb=True)
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


def _assert_tables_equal_plain(inputs):
    """One call of pack_face_tables on CUDA inputs is one launch of the
    pack_faces kernel, and its four tables hold the bits of the plain
    version's, the torch ops on the card (a NaN equal to any NaN).

    :return: the kernel's tables
    """
    before = trc.pack_face_tables_cuda.launches
    tables = trc.pack_face_tables(*inputs)
    assert trc.pack_face_tables_cuda.launches == before + 1
    plain = trc.pack_face_tables_plain(*inputs)
    torch.cuda.synchronize()
    for name, k, p in zip(trc.FaceTables._fields, tables[:4], plain[:4]):
        assert k.shape == p.shape and k.dtype == p.dtype, name
        assert bool(chip_smoke.same_bits(k, p).all()), name
    return tables


@pytest.mark.cuda
@pytest.mark.parametrize("scene,hw", [("triangles", (64, 64)),
                                      ("smpl", (100, 90)),
                                      ("sliver", chip_smoke.SLIVER_HW),
                                      ("batch8", (256, 256)),
                                      ("batched4", (512, 512)),
                                      ("samples", (512, 512)),
                                      ("sil8", (256, 256)),
                                      ("sil80", (256, 256)),
                                      ("nan_inf", (100, 90))])
def test_face_boxes_kernel_equals_plain_on_card(cuda_device, scene, hw):
    """All four tables of the pack_faces kernel, boxes among them, against
    its plain version on the card: tolerance 0, bit for bit, one launch a
    call. The scenes' tables were packed on the card, so they are the
    kernel's. nan_inf is the smpl scene with a NaN at vertex 0 of the first
    mesh (which the padding faces read too) and infinities in two others:
    NaN and inf reach every table as the torch ops hand them on."""
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
    screen = built.screen
    if scene == "nan_inf":
        screen = screen.clone()
        screen[0, 0, 0] = float("nan")
        screen[1, 500, 1] = float("inf")
        screen[2, 900, 2] = -float("inf")
    tables = _assert_tables_equal_plain((screen, built.faces, built.vert_attrs, hw))
    if hw == built.tables.image_hw and scene != "nan_inf":
        for k, own in zip(tables[:4], built.tables[:4]):
            assert bool(chip_smoke.same_bits(k, own).all())
    boxes = tables.face_boxes
    assert (boxes[..., 1] >= boxes[..., 0]).sum() > 4


@pytest.mark.cuda
@pytest.mark.parametrize("A", [5, 8])
def test_face_boxes_kernel_equals_plain_on_odd_vertices(cuda_device, A):
    """NaN, infinite, huge and denormal coordinates, and exactly degenerate
    faces, take the same branches in the pack_faces kernel as in the torch
    ops: all four tables bit for bit, with scalar (A = 5) and 4-vector
    (A = 8) attribute stores."""
    rng = np.random.RandomState(5)
    fv = (rng.rand(2, 256, 3, 3) * 80 - 10).astype(np.float32)
    odd = [np.nan, np.inf, -np.inf, 3e38, -3e38, 1e-40, 0.0, 1e19, -1e19]
    for k in range(2 * 200):
        fv[k % 2, k // 2, rng.randint(3), rng.randint(2)] = odd[k % len(odd)]
    fv[:, 200:230, 2] = fv[:, 200:230, 1]            # two vertices coincide
    verts = torch.as_tensor(fv.reshape(2, 768, 3), device=cuda_device)
    faces = torch.arange(768, device=cuda_device).reshape(256, 3)[:250]
    attrs = torch.as_tensor(rng.randn(2, 768, A).astype(np.float32),
                            device=cuda_device)
    for hw in ((64, 64), (48, 100)):
        _assert_tables_equal_plain((verts, faces, attrs, hw))


def test_silhouette_tables_carry_the_iuv_alone():
    """The renderer's silhouette mode packs A = 3 (the evaluation's shape),
    and its render on the CPU is IUV, depth and silhouettes, no colour."""
    scene = chip_smoke.silhouette_scene("cpu", batch=2, img_wh=32)
    assert scene.vert_attrs.shape == (2, 7829, 3)
    assert scene.tables.face_attrs.shape[-1] == 9
    renderer = TexturedIUVRenderer("cpu", img_wh=32, projection_type="orthographic",
                                   render_rgb=False)
    out = renderer(torch.zeros(1, 6890, 3), cam_t=torch.tensor([[0.0, 0.0, 2.5]]),
                   orthographic_scale=torch.ones(1, 2))
    assert sorted(out) == ["depth_images", "iuv_images", "silhouettes"]


def test_gesdd_dispatch_on_cpu():
    """CPU tensors take svd3x3_gesdd_plain and launch nothing; its loop
    counts a host sync an iteration and one closing test, and adds its
    iterations to svd3x3_gesdd.iterations, which `= 0` resets. The kernel
    entry refuses CPU tensors instead of falling back."""
    F = torch.from_numpy(chip_smoke.gesdd_f_plus_i(n=40)).reshape(8, 5, 3, 3)
    before = lapack_svd3.svd3x3_gesdd_cuda.launches
    lapack_svd3.svd3x3_gesdd.iterations = 0
    t0 = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("gesdd"):
            out = lapack_svd3.svd3x3_gesdd(F)
    (rec,) = [r for r in spans_between(t0, time.time_ns()) if r.name == "gesdd"]
    iterations = lapack_svd3.svd3x3_gesdd.iterations
    assert iterations > 1 and rec.counters == {"host_syncs": iterations + 1}
    plain = lapack_svd3.svd3x3_gesdd_plain(F)
    assert lapack_svd3.svd3x3_gesdd.iterations == 2 * iterations
    assert [tuple(o.shape) for o in out] == [(8, 5, 3, 3), (8, 5, 3), (8, 5, 3, 3)]
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    lapack_svd3.svd3x3_gesdd.iterations = 0
    assert lapack_svd3.svd3x3_gesdd.iterations == 0
    assert lapack_svd3.svd3x3_gesdd_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        lapack_svd3.svd3x3_gesdd_cuda(F)
    assert lapack_svd3.svd3x3_gesdd_cuda.launches == before


def _gesdd_kernel_vs_plain(F):
    """svd3x3_gesdd on card tensors (one kernel launch) against
    svd3x3_gesdd_plain's torch ops on the card: U, S, V bit for bit, and
    the same count of loop iterations.

    :return: the kernel's U, S, V and its iterations
    """
    before = lapack_svd3.svd3x3_gesdd_cuda.launches
    lapack_svd3.svd3x3_gesdd.iterations = 0
    kernel = lapack_svd3.svd3x3_gesdd(F)
    torch.cuda.synchronize()
    assert lapack_svd3.svd3x3_gesdd_cuda.launches == before + 1
    iterations = lapack_svd3.svd3x3_gesdd.iterations
    lapack_svd3.svd3x3_gesdd.iterations = 0
    plain = lapack_svd3.svd3x3_gesdd_plain(F)
    assert lapack_svd3.svd3x3_gesdd.iterations == iterations
    for name, k, p in zip("USV", kernel, plain):
        assert k.shape == p.shape and k.dtype == p.dtype, name
        same = chip_smoke.same_bits(k, p)
        assert bool(same.all()), (name, int((~same).sum()))
    return kernel, iterations


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_gesdd_kernel_equals_plain_on_card(cuda_device, scale):
    """2,000 F + I matrices (the head's regime) at three scales, and at the
    head's shapes (8 x 2, 8 x 3, 8 x 5 lanes)."""
    F = torch.from_numpy(chip_smoke.gesdd_f_plus_i(scale)).to(cuda_device)
    _gesdd_kernel_vs_plain(F)
    for group in (2, 3, 5):
        _gesdd_kernel_vs_plain(F[:8 * group].reshape(8, group, 3, 3))


@pytest.mark.cuda
def test_gesdd_kernel_on_hand_made_lanes(cuda_device):
    """chip_smoke.GESDD_LANES at once and each alone (its own count):
    split_top takes the (1, 2) dlasv2 block in one iteration and two_by_two
    the m == 2 block (0, 1) in two, each with a rotation that is no signed
    permutation."""
    names, F = chip_smoke.gesdd_lanes()
    F = torch.from_numpy(F).to(cuda_device)
    _gesdd_kernel_vs_plain(F)
    for i, name in enumerate(names):
        (_, _, V), iterations = _gesdd_kernel_vs_plain(F[i:i + 1])
        if name in ("split_top", "two_by_two"):
            assert iterations == {"split_top": 1, "two_by_two": 2}[name]
            assert bool(((V.abs() > 0) & (V.abs() < 1)).any()), name


@pytest.mark.cuda
def test_gesdd_kernel_makes_no_host_sync(cuda_device):
    """A call at the head's largest shape is one launch and no sync: torch's
    sync debug mode raises on any. The count reads right after a sync."""
    F = torch.from_numpy(chip_smoke.gesdd_f_plus_i(n=40)).to(cuda_device)
    F = F.reshape(8, 5, 3, 3)
    lapack_svd3.svd3x3_gesdd(F)            # builds and loads the library
    torch.cuda.synchronize()
    lapack_svd3.svd3x3_gesdd.iterations = 0
    before = lapack_svd3.svd3x3_gesdd_cuda.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        lapack_svd3.svd3x3_gesdd(F)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert lapack_svd3.svd3x3_gesdd_cuda.launches == before + 1
    torch.cuda.synchronize()
    iterations = lapack_svd3.svd3x3_gesdd.iterations
    lapack_svd3.svd3x3_gesdd.iterations = 0
    lapack_svd3.svd3x3_gesdd_plain(F)
    assert iterations == lapack_svd3.svd3x3_gesdd.iterations > 0


@pytest.mark.cuda
def test_gesdd_count_resets_after_a_first_call_in_inference_mode(
        cuda_device, monkeypatch):
    """The pinned counter made by a first call under inference mode (as the
    evaluation makes it) can be read and set to 0 outside it, and counts
    the next call's loop as the plain version does."""
    monkeypatch.setattr(lapack_svd3.svd3x3_gesdd, "_counter", None)
    F = torch.from_numpy(chip_smoke.gesdd_f_plus_i(n=40)).to(cuda_device)
    with torch.inference_mode():
        lapack_svd3.svd3x3_gesdd(F)
    torch.cuda.synchronize()
    assert lapack_svd3.svd3x3_gesdd.iterations > 0
    lapack_svd3.svd3x3_gesdd.iterations = 0
    assert lapack_svd3.svd3x3_gesdd.iterations == 0
    _gesdd_kernel_vs_plain(F)


@pytest.mark.cuda
def test_gesdd_head_kernel_equals_plain_on_card(cuda_device, monkeypatch):
    """PoseMFShapeGaussianNet(svd_impl="lapack") at B = 8: the head on the
    same features through the kernel (8 launches, one a depth group) and
    through the plain torch ops gives the same bits on every output."""
    model = init_weights(PoseMFShapeGaussianNet(svd_impl="lapack"),
                         torch.Generator().manual_seed(0)).to(cuda_device).eval()
    proxy = torch.rand((8, 18, 64, 64), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        feats = model.image_encoder(proxy.to(cuda_device))
        before = lapack_svd3.svd3x3_gesdd_cuda.launches
        kernel = model._head(feats)
        assert lapack_svd3.svd3x3_gesdd_cuda.launches == before + len(
            model.depth_groups) == before + 8
        monkeypatch.setattr(lapack_svd3, "svd3x3_gesdd_cuda",
                            lapack_svd3.svd3x3_gesdd_plain)
        plain = model._head(feats)
    torch.cuda.synchronize()
    for key in kernel:
        assert bool(chip_smoke.same_bits(kernel[key], plain[key]).all()), key


@pytest.mark.cuda
def test_gesdd_svd_on_card_equals_cpu(cuda_device):
    """The LAPACK-sign SVD on the card (the kernel) gives the CPU's numbers
    bit for bit on 2,000 F + I matrices (tol 0)."""
    F = torch.from_numpy(chip_smoke.gesdd_f_plus_i())
    before = lapack_svd3.svd3x3_gesdd_cuda.launches
    card = [a.cpu() for a in lapack_svd3.svd3x3_gesdd(F.to(cuda_device))]
    assert lapack_svd3.svd3x3_gesdd_cuda.launches == before + 1
    cpu = lapack_svd3.svd3x3_gesdd(F)
    for a, b in zip(card, cpu):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gesdd_plain_on_card_equals_cpu(cuda_device):
    """The kernel's plain version is elementwise ops in a fixed order with
    its square roots in float64: its torch ops on the card give the CPU's
    numbers bit for bit on 2,000 F + I matrices (tol 0)."""
    F = torch.from_numpy(chip_smoke.gesdd_f_plus_i())
    card = [a.cpu() for a in lapack_svd3.svd3x3_gesdd_plain(F.to(cuda_device))]
    cpu = lapack_svd3.svd3x3_gesdd_plain(F)
    for a, b in zip(card, cpu):
        assert torch.equal(a, b)


def test_train_tables_come_from_the_training_render():
    """The training shape's tables are the synthetic stage's own render:
    perspective, A = 12 (IUV, normal, camera position, texel colour), on
    the CPU at a small size."""
    scene = chip_smoke.train_scene("cpu", batch=2, img_wh=32)
    assert scene.vert_attrs.shape == (2, 7829, 12)
    assert scene.tables.image_hw == (32, 32)
    # z is the camera-frame depth, not shifted (perspective)
    assert 1.5 < float(scene.screen[..., 2].min()) < 3.5


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda_device):
    """One stage-2 train step at B=4, 64^2 on the card against the CPU, as
    chip_smoke.py phase 7c holds it: loss and terms within 1e-4 relative,
    BatchNorm buffers within 1e-5 of each tensor's largest, every gradient
    finite and within max(1e-3, 10 x its float32 noise floor) of the
    tensor's largest, the synthetic proxy equal on >= 0.99 of its values."""
    from hierarchicalprobabilistic3dhuman_torch.utils.device import set_full_f32
    set_full_f32(cuda_device)
    chip_smoke.check_card_vs_cpu_step(
        "cuda test", chip_smoke.train_card_vs_cpu(cuda_device,
                                                  **chip_smoke.TRAIN_CHECK))
