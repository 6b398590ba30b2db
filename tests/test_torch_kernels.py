"""The rasterizer kernel's wrapper, and the kernel against its plain version.

This file imports nothing of JAX, so the card's machine can run it without
the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The `cuda` tests skip where torch finds no CUDA device: a CUDA kernel has
no CPU mode. On the card the kernel must match the plain version bit for
bit on mask and depth, and to 1e-5 on attrs.
"""

import numpy as np
import pytest
import torch

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


def _triangle_tables(device="cpu"):
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
    return trc.pack_face_tables(verts, faces, attrs)


def test_wrapper_dispatch_on_cpu():
    """CPU tensors take the plain version and launch nothing; the kernel
    entry refuses CPU tensors instead of falling back."""
    tables = _triangle_tables()
    before = trc.rasterize_packed_cuda.launches
    out = trc.rasterize_packed(*tables, (32, 32))
    plain = trc.rasterize_packed_plain(*tables, (32, 32))
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert out[2].sum() > 100
    assert trc.rasterize_packed_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        trc.rasterize_packed_cuda(*tables, (32, 32))


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


def _smpl_tables(device, img_wh):
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
    renderer = TexturedIUVRenderer(img_wh=img_wh, device=device)
    screen, vert_attrs = renderer.raster_inputs(
        views["vertices"], views["cam_t"], views["orthographic_scale"],
        views["verts_features"])
    return trc.pack_face_tables(screen, renderer.faces, vert_attrs)


@pytest.mark.cuda
@pytest.mark.parametrize("scene,hw", [("triangles", (64, 64)),
                                      ("smpl", (128, 128)),
                                      ("smpl", (100, 90))])
def test_kernel_matches_plain_on_card(cuda_device, scene, hw):
    tables = (_triangle_tables(cuda_device) if scene == "triangles"
              else _smpl_tables(cuda_device, hw[0]))
    before = trc.rasterize_packed_cuda.launches
    ka, kd, km = trc.rasterize_packed_cuda(*tables, hw)
    pa, pd, pm = trc.rasterize_packed_plain(*tables, hw)
    torch.cuda.synchronize()
    assert trc.rasterize_packed_cuda.launches == before + 1
    assert km.sum() > 100
    assert torch.equal(km, pm) and torch.equal(kd, pd)
    assert (ka - pa).abs().max() <= 1e-5
