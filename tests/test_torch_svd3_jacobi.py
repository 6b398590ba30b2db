"""The Jacobi 3x3 SVD's kernels (csrc/svd3_jacobi.cu) and their dispatch.

On the CPU: CPU tensors take the torch ops (svd3x3_plain) and launch
nothing; the kernel entry's argument checks, which raise before any launch,
for CUDA dtypes other than float32 / float64 among others. The kernels'
per-matrix math (everything in the .cu's anonymous namespace) compiled with
g++ over a header that maps each CUDA rounding intrinsic to the IEEE
operation it names (-ffp-contract=off): the forward against svd3x3_plain in
float64 and float32, the backward against float64 autograd through
svd3x3_plain (the unrolled derivative), with gradients on U, S and V alone
and together.

On the card (`cuda`, skipped elsewhere), run there with

    python -m pytest --noconftest -m cuda tests/test_torch_svd3_jacobi.py

the kernels against the torch ops on the card: the forward bit for bit on
>= 100,000 random matrices, on diagonal (degenerate), rank 2, rank 1, zero,
repeated-value and negative-determinant matrices, at the head's shapes and
in float64; the backward against float64 autograd through svd3x3_plain, its
error at most twice the float32 torch ops' own plus 1e-6 of the gradient's
largest entry; deterministic; Procrustes alignment through one launch.
This file imports nothing of JAX.
"""

import ctypes
import re
import subprocess

import numpy as np
import pytest
import torch

from hierarchicalprobabilistic3dhuman_torch.ops import svd3
from hierarchicalprobabilistic3dhuman_torch.utils import eval_utils

torch.set_num_threads(2)

# The head's depth groups: matrices a (batch, group) call.
GROUPS = (2, 3, 5)
# Largest difference of the kernel's forward from the torch ops on the card,
# in ulps (the forward gives their bits).
FORWARD_ULPS = 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def f_plus_i(n, seed, scale=0.5):
    """n matrices of the pose head's regime, randn * scale + I."""
    rng = np.random.RandomState(seed)
    return rng.randn(n, 3, 3) * scale + np.eye(3)


def rotations(n, rng):
    """n random proper rotations (QR of Gaussian matrices)."""
    q, r = np.linalg.qr(rng.randn(n, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    det = np.linalg.det(q)
    q[:, :, 2] *= det[:, None]
    return q


def special_matrices(n=64, seed=3):
    """Named batches of hand-made inputs (float64), n or fewer each."""
    rng = np.random.RandomState(seed)
    R1, R2 = rotations(n, rng), rotations(n, rng)

    def usv(s):
        return R1 @ (s[:, :, None] * np.eye(3)) @ np.swapaxes(R2, 1, 2)

    ones = np.ones(n)
    return {
        "diagonal": np.stack([np.diag(d) for d in rng.randn(n, 3)]),
        "diagonal_ties": np.stack([np.diag([2.0, 2.0, -2.0]), np.diag([1.0, 3.0, 3.0]),
                                   np.eye(3), -np.eye(3), np.diag([0.0, -0.0, 1.0])]),
        "permutation": np.array([[[0.0, 1, 0], [0, 0, 1], [1, 0, 0]]]),
        "zero": np.zeros((2, 3, 3)),
        "rank2": usv(np.stack([rng.rand(n) + 1, rng.rand(n) + 0.5, 0 * ones], 1)),
        "rank1": usv(np.stack([rng.rand(n) + 1, 0 * ones, 0 * ones], 1)),
        "repeated": usv(np.stack([2 * ones, 2 * ones, ones], 1)),
        "repeated_all": usv(np.stack([1.5 * ones] * 3, 1)),
        "negative_det": usv(np.stack([rng.rand(n) + 2, rng.rand(n) + 1,
                                      -(rng.rand(n) + 0.1)], 1)),
        "near_equal": usv(np.stack([ones + 1e-4 * rng.rand(n), ones,
                                    0.5 * ones], 1)),
        "near_rank2": usv(np.stack([ones, 0.7 * ones, 1e-4 * rng.rand(n)], 1)),
        "near_diagonal": (np.stack([np.diag(d) for d in rng.randn(n, 3)])
                          + 1e-7 * rng.randn(n, 3, 3)),
    }


# Inputs whose derivative is finite: the exactly degenerate ones divide by
# a zero singular value or a zero angle denominator, in autograd too.
SMOOTH = ("diagonal", "negative_det", "near_equal", "near_rank2", "near_diagonal")


def loss_grads(n, seed, dtype=np.float64):
    """Upstream gradients of U, S and V for n matrices."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, 3).astype(dtype), rng.randn(n, 3).astype(dtype),
            rng.randn(n, 3, 3).astype(dtype))


def autograd_grad(fn, F, grads, which):
    """d(sum of <output, grad> over the outputs in `which`)/dF by autograd
    through fn."""
    F = F.detach().clone().requires_grad_()
    outs = fn(F)
    loss = sum((outs[k] * grads[k]).sum() for k in which)
    (g,) = torch.autograd.grad(loss, F)
    return g


# ---------------------------------------------------------------- the CPU

def test_cpu_tensors_take_the_torch_ops():
    """svd3x3 on CPU tensors is svd3x3_plain, outputs and gradients bit for
    bit, in both dtypes, and launches nothing."""
    before = (svd3.svd3x3_jacobi_cuda.launches,
              svd3.svd3x3_jacobi_cuda.backward_launches)
    for dtype in (torch.float32, torch.float64):
        F = torch.from_numpy(f_plus_i(40, seed=1)).to(dtype).reshape(8, 5, 3, 3)
        for a, b in zip(svd3.svd3x3(F, n_sweeps=6), svd3.svd3x3_plain(F, n_sweeps=6)):
            assert torch.equal(a, b)
        grads = [torch.from_numpy(g).to(dtype).reshape(F.shape[:-2] + g.shape[1:])
                 for g in loss_grads(40, seed=2)]
        assert torch.equal(autograd_grad(svd3.svd3x3, F, grads, (0, 1, 2)),
                           autograd_grad(svd3.svd3x3_plain, F, grads, (0, 1, 2)))
    assert (svd3.svd3x3_jacobi_cuda.launches,
            svd3.svd3x3_jacobi_cuda.backward_launches) == before


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.int32,
                                   torch.complex64])
def test_kernel_entry_refuses_other_dtypes(dtype):
    """The kernels take float32 and float64 alone: any other dtype raises
    before the device is looked at, so a CUDA tensor of it raises too."""
    before = svd3.svd3x3_jacobi_cuda.launches
    with pytest.raises(ValueError, match="float32 or float64"):
        svd3.svd3x3_jacobi_cuda(torch.zeros(4, 3, 3, dtype=dtype))
    assert svd3.svd3x3_jacobi_cuda.launches == before


@pytest.mark.parametrize("shape,n_sweeps,match", [
    ((4, 3, 4), 8, "shape"),
    ((3,), 8, "shape"),
    ((4, 3, 3), svd3.MAX_SWEEPS + 1, "n_sweeps"),
    ((4, 3, 3), -1, "n_sweeps"),
    ((4, 3, 3), 8.0, "n_sweeps"),
    ((4, 3, 3), 8, "CUDA"),
])
def test_kernel_entry_argument_errors(shape, n_sweeps, match):
    """A wrong shape, a sweep count outside [0, MAX_SWEEPS] and a CPU tensor
    raise; nothing falls back to the torch ops."""
    before = svd3.svd3x3_jacobi_cuda.launches
    with pytest.raises(ValueError, match=match):
        svd3.svd3x3_jacobi_cuda(torch.zeros(shape), n_sweeps)
    assert svd3.svd3x3_jacobi_cuda.launches == before


def test_dispatch_refuses_other_devices():
    with pytest.raises(ValueError, match="device"):
        svd3.svd3x3(torch.zeros(2, 3, 3, device="meta"))


def test_max_sweeps_is_the_kernels():
    """MAX_SWEEPS, which the wrapper checks, is the .cu's kMaxSweeps."""
    src = open(svd3.SRC_PATH).read()
    assert int(re.search(r"constexpr int kMaxSweeps = (\d+);", src).group(1)) \
        == svd3.MAX_SWEEPS == 8


SHIM = r"""
#include <math.h>
#define __device__
#define __forceinline__ inline
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
static inline float __fsqrt_rn(float x) { return sqrtf(x); }
static inline double __dmul_rn(double a, double b) { return a * b; }
static inline double __dadd_rn(double a, double b) { return a + b; }
static inline double __dsub_rn(double a, double b) { return a - b; }
static inline double __ddiv_rn(double a, double b) { return a / b; }
static inline double __fma_rn(double a, double b, double c) { return fma(a, b, c); }
static inline double __dsqrt_rn(double x) { return sqrt(x); }
"""

ENTRY = r"""
template <typename T>
static void fwd(const T* f, T* u, T* s, T* v, int n, int k) {
  for (int i = 0; i < n; ++i)
    jacobi_lane<T>(f + 9 * i, u + 9 * i, s + 3 * i, v + 9 * i, k);
}
template <typename T>
static void bwd(const T* f, const T* gu, const T* gs, const T* gv, T* gf, int n,
                int k) {
  for (int i = 0; i < n; ++i)
    jacobi_lane_bwd<T>(f + 9 * i, gu ? gu + 9 * i : nullptr,
                       gs ? gs + 3 * i : nullptr, gv ? gv + 9 * i : nullptr,
                       gf + 9 * i, k);
}
extern "C" void fwd32(const float* f, float* u, float* s, float* v, int n, int k) {
  fwd(f, u, s, v, n, k);
}
extern "C" void fwd64(const double* f, double* u, double* s, double* v, int n,
                      int k) {
  fwd(f, u, s, v, n, k);
}
extern "C" void bwd32(const float* f, const float* gu, const float* gs,
                      const float* gv, float* gf, int n, int k) {
  bwd(f, gu, gs, gv, gf, n, k);
}
extern "C" void bwd64(const double* f, const double* gu, const double* gs,
                      const double* gv, double* gf, int n, int k) {
  bwd(f, gu, gs, gv, gf, n, k);
}
"""


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    src = open(svd3.SRC_PATH).read()
    start = src.index("namespace {")
    end = src.index("}  // namespace") + len("}  // namespace")
    root = tmp_path_factory.mktemp("svd3_jacobi_lane")
    cpp = root / "lane.cpp"
    cpp.write_text(SHIM + src[start:end] + ENTRY)
    lib = root / "liblane.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return None if a is None else ctypes.c_void_p(a.ctypes.data)


def lane_forward(lib, F, n_sweeps=8):
    F = np.ascontiguousarray(F)
    n = len(F)
    u, v, s = np.empty_like(F), np.empty_like(F), np.empty((n, 3), F.dtype)
    fn = lib.fwd64 if F.dtype == np.float64 else lib.fwd32
    fn(*map(_ptr, (F, u, s, v)), ctypes.c_int(n), ctypes.c_int(n_sweeps))
    return u, s, v


def lane_backward(lib, F, gu, gs, gv, n_sweeps=8):
    F = np.ascontiguousarray(F)
    gf = np.empty_like(F)
    fn = lib.bwd64 if F.dtype == np.float64 else lib.bwd32
    fn(*map(_ptr, (F, gu, gs, gv, gf)), ctypes.c_int(len(F)), ctypes.c_int(n_sweeps))
    return gf


@pytest.mark.parametrize("n_sweeps", [0, 1, 8])
def test_lane_forward_matches_plain(lane_lib, n_sweeps):
    """The kernel's per-matrix forward equals svd3x3_plain on the CPU to
    rounding: 1e-12 in float64, 1e-5 in float32 (the CPU's torch.sum and
    libm round differently from the card's; the card's bits are the `cuda`
    tests'), and on the special matrices its S within 1e-12."""
    rng = np.random.RandomState(n_sweeps)
    F = np.concatenate([f_plus_i(500, seed=4), rng.randn(500, 3, 3)])
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 2e-5)):
        Fd = F.astype(dtype)
        lane = lane_forward(lane_lib, Fd, n_sweeps)
        plain = [t.numpy() for t in svd3.svd3x3_plain(torch.from_numpy(Fd), n_sweeps)]
        for a, b in zip(lane, plain):
            assert np.abs(a - b).max() <= tol
    for name, M in special_matrices().items():
        s = lane_forward(lane_lib, M)[1]
        S = svd3.svd3x3_plain(torch.from_numpy(M))[1].numpy()
        assert np.abs(s - S).max() <= 1e-12, name


@pytest.mark.parametrize("which", [(0,), (1,), (2,), (0, 1, 2)])
def test_lane_backward_is_the_unrolled_derivative(lane_lib, which):
    """The kernel's per-matrix backward in float64 equals float64 autograd
    through svd3x3_plain to 1e-8 of the gradient's largest entry, on random
    and near-degenerate matrices, with gradients on U, S, V alone and all
    three; unselected outputs are passed as no gradient (null). (The
    near-diagonal matrices' gradients reach ~1e6: they amplify the float64
    forward's last-bit differences between the CPU's torch.sum and this
    build's sums to ~1e-10 of the largest entry.)"""
    mats = [f_plus_i(300, seed=5), np.random.RandomState(6).randn(300, 3, 3)]
    mats += [special_matrices()[k] for k in SMOOTH]
    F = np.concatenate(mats)
    grads = loss_grads(len(F), seed=7)
    ref = autograd_grad(svd3.svd3x3_plain, torch.from_numpy(F),
                        [torch.from_numpy(g) for g in grads], which).numpy()
    given = [g if k in which else None for k, g in enumerate(grads)]
    lane = lane_backward(lane_lib, F, *given)
    assert np.isfinite(ref).all()
    assert np.abs(lane - ref).max() <= 1e-8 * np.abs(ref).max()


def fallback_matrices(n=60, seed=8):
    """Matrices whose U takes the cross-product fallback for its second
    column: one nonzero column and two exact zeros (a third of them near
    e2, so the second fallback; the column first, the rotations then leave
    the zeros exactly zero, and positive, so that no product with a zero is
    -0, whose sign would pick the rotation: the CPU's torch.sum can keep a
    -0 that the card's turns into +0); and columns (x, 2x, y) with |y| <
    |x|, whose two largest are parallel before any rotation."""
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(n, 3))
    x[: n // 3] = [0.01, 0.02, 1.0] + 0.01 * np.abs(rng.randn(n // 3, 3))
    one_column = np.zeros((n, 3, 3))
    one_column[:, :, 0] = x
    y = 0.1 * rng.randn(n, 3)
    parallel = np.stack([x, 2 * x, y], axis=-1)
    return one_column, parallel


def test_lane_backward_at_zero_sweeps_and_through_the_fallbacks(lane_lib):
    """n_sweeps = 0 (U's rebuild alone) and 2, on random matrices and on
    those whose second U column is the cross-product fallback (gradients
    on U and V; S's has 1 / (2 S) at their zero values, in autograd too):
    the derivative autograd takes, to 1e-10 of its largest entry."""
    rng = np.random.RandomState(8)
    one_column, parallel = fallback_matrices()
    for n_sweeps, fallbacks in ((0, [one_column, parallel]), (2, [one_column])):
        F = np.concatenate([rng.randn(200, 3, 3)] + fallbacks)
        grads = loss_grads(len(F), seed=9)
        ref = autograd_grad(lambda x: svd3.svd3x3_plain(x, n_sweeps),
                            torch.from_numpy(F),
                            [torch.from_numpy(g) for g in grads], (0, 2)).numpy()
        lane = lane_backward(lane_lib, F, grads[0], None, grads[2], n_sweeps)
        assert np.isfinite(ref).all()
        assert np.abs(lane - ref).max() <= 1e-10 * np.abs(ref).max()


# ---------------------------------------------------------------- the card

def ulps(a, b):
    """Elementwise distance of two float tensors in units in the last place
    (NaN to NaN: 0)."""
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64

    def ordered(x):
        i = x.view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & ((1 << (8 * x.element_size() - 1)) - 1)), i)

    d = (ordered(a) - ordered(b)).abs()
    return torch.where(a.isnan() & b.isnan(), 0, d)


def kernel_vs_plain(F, n_sweeps=8):
    """svd3x3 on card tensors (one launch) against svd3x3_plain's torch ops
    on the card: the largest difference over U, S, V in ulps."""
    before = svd3.svd3x3_jacobi_cuda.launches
    kernel = svd3.svd3x3(F, n_sweeps)
    plain = svd3.svd3x3_plain(F, n_sweeps)
    torch.cuda.synchronize()
    assert svd3.svd3x3_jacobi_cuda.launches == before + 1
    for k, p in zip(kernel, plain):
        assert k.shape == p.shape and k.dtype == p.dtype
    return max(int(ulps(k, p).max()) for k, p in zip(kernel, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forward_bits_on_random_matrices(cuda_device, dtype):
    """>= 100,000 matrices: the head's regime at three scales and Gaussian
    matrices from 1e-3 to 1e3."""
    rng = np.random.RandomState(10)
    parts = [f_plus_i(20000, seed=11, scale=s) for s in (0.1, 0.5, 2.0)]
    parts += [rng.randn(20000, 3, 3) * 10.0 ** e for e in (-3, 0, 3)]
    F = torch.as_tensor(np.concatenate(parts), dtype=dtype, device=cuda_device)
    assert F.shape[0] >= 100000
    assert kernel_vs_plain(F) <= FORWARD_ULPS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(special_matrices()))
def test_forward_bits_on_special_matrices(cuda_device, dtype, name):
    F = torch.as_tensor(special_matrices()[name], dtype=dtype, device=cuda_device)
    assert kernel_vs_plain(F) <= FORWARD_ULPS


@pytest.mark.cuda
@pytest.mark.parametrize("B", [72, 8])
@pytest.mark.parametrize("G", GROUPS)
def test_forward_bits_at_the_head_shapes(cuda_device, B, G):
    """(B, G, 3, 3) for each depth group's G, every sweep count up to the
    configs' 8."""
    F = torch.as_tensor(f_plus_i(B * G, seed=B + G), dtype=torch.float32,
                        device=cuda_device).reshape(B, G, 3, 3)
    for n_sweeps in (0, 1, 3, 8):
        assert kernel_vs_plain(F, n_sweeps) <= FORWARD_ULPS


def _grad_errors(F64, which, seed):
    """Largest error of the kernel's gradient and of the float32 torch ops'
    autograd against float64 autograd through svd3x3_plain, and that
    gradient's largest entry."""
    grads64 = [torch.from_numpy(g).to(F64.device) for g in loss_grads(len(F64), seed)]
    ref = autograd_grad(svd3.svd3x3_plain, F64, grads64, which)
    F32 = F64.float()
    grads32 = [g.float() for g in grads64]
    before = svd3.svd3x3_jacobi_cuda.backward_launches
    kernel = autograd_grad(svd3.svd3x3, F32, grads32, which)
    assert svd3.svd3x3_jacobi_cuda.backward_launches == before + 1
    plain = autograd_grad(svd3.svd3x3_plain, F32, grads32, which)
    torch.cuda.synchronize()
    err = [float((g.double() - ref).abs().max()) for g in (kernel, plain)]
    return err[0], err[1], float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("which", [(0,), (1,), (2,), (0, 1, 2)])
@pytest.mark.parametrize("inputs", ["random", "near_degenerate"])
def test_gradient_contract(cuda_device, which, inputs):
    """grad F of the float32 kernel against float64 autograd through
    svd3x3_plain: at most twice the float32 torch ops' own error, plus
    1e-6 of the gradient's largest entry."""
    if inputs == "random":
        rng = np.random.RandomState(12)
        F = np.concatenate([f_plus_i(5000, seed=13), rng.randn(5000, 3, 3)])
    else:
        F = np.concatenate([special_matrices(n=500, seed=14)[k] for k in SMOOTH])
    F64 = torch.as_tensor(F, device=cuda_device)
    kernel_err, plain_err, scale = _grad_errors(F64, which, seed=15)
    assert kernel_err <= 2 * plain_err + 1e-6 * scale, (kernel_err, plain_err, scale)


@pytest.mark.cuda
def test_float64_gradient_is_autograds(cuda_device):
    """In float64 the kernel's gradient equals autograd's through the torch
    ops on the card to 1e-9 of its largest entry."""
    F = torch.as_tensor(np.concatenate([f_plus_i(2000, seed=16)]
                                       + [special_matrices()[k] for k in SMOOTH]),
                        device=cuda_device)
    grads = [torch.from_numpy(g).to(cuda_device) for g in loss_grads(len(F), 17)]
    kernel = autograd_grad(svd3.svd3x3, F, grads, (0, 1, 2))
    plain = autograd_grad(svd3.svd3x3_plain, F, grads, (0, 1, 2))
    assert float((kernel - plain).abs().max()) <= 1e-9 * float(plain.abs().max())


@pytest.mark.cuda
def test_backward_deterministic_and_graph_capturable(cuda_device):
    """Two backward passes give the same bits under deterministic algorithms,
    and a CUDA graph of forward and backward replays them bit for bit."""
    F = torch.as_tensor(f_plus_i(72 * 5, seed=18), dtype=torch.float32,
                        device=cuda_device).reshape(72, 5, 3, 3)
    grads = [torch.from_numpy(g).float().to(cuda_device).reshape(F.shape[:2] + g.shape[1:])
             for g in loss_grads(72 * 5, 19)]
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        first = autograd_grad(svd3.svd3x3, F, grads, (0, 1, 2))
        second = autograd_grad(svd3.svd3x3, F, grads, (0, 1, 2))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    assert torch.equal(first, second)

    static = F.clone().requires_grad_()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        U, S, V = svd3.svd3x3(static)
        loss = (U * grads[0]).sum() + (S * grads[1]).sum() + (V * grads[2]).sum()
        (captured,) = torch.autograd.grad(loss, static)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
def test_procrustes_takes_one_launch(cuda_device):
    """Eval's Procrustes alignment on the card: one launch of the kernel,
    the same bits as with the torch ops' SVD."""
    rng = np.random.RandomState(20)
    S1 = torch.as_tensor(rng.randn(8, 431, 3), dtype=torch.float32, device=cuda_device)
    S2 = S1 @ torch.as_tensor(rotations(1, rng)[0], dtype=torch.float32,
                              device=cuda_device) + 0.01 * torch.randn_like(S1)
    before = svd3.svd3x3_jacobi_cuda.launches
    aligned = eval_utils.procrustes_analysis_batch(S1, S2)
    assert svd3.svd3x3_jacobi_cuda.launches == before + 1
    kernel = eval_utils.svd3x3
    try:
        eval_utils.svd3x3 = svd3.svd3x3_plain
        plain = eval_utils.procrustes_analysis_batch(S1, S2)
    finally:
        eval_utils.svd3x3 = kernel
    assert torch.equal(aligned, plain)
