"""The svd3_gesdd kernel's arithmetic, per matrix, on the CPU.

csrc/svd3_gesdd.cu keeps all of one matrix's arithmetic (`gesdd_lane` and
its helpers) in its anonymous namespace, written in CUDA's rounding
intrinsics. Here that namespace is compiled with g++ over a header that maps
each intrinsic to the IEEE operation it names (__fmul_rn to a * b, __dsqrt_rn
to the float64 sqrt, ...; -ffp-contract=off, so no FMA), and held to
ops/lapack_svd3.py::svd3x3_gesdd_plain on the CPU: U, S and V bit for bit (a
NaN equal to any NaN), and the most iterations of any matrix equal to the
plain loop's count. The plain version gives the card's bits on the CPU
(tests/test_torch_kernels.py), where the `cuda` tests hold the kernel itself.
This file imports nothing of JAX.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalprobabilistic3dhuman_torch.ops import lapack_svd3

torch.set_num_threads(2)

SHIM = r"""
#include <math.h>
#define __device__
#define __forceinline__ inline
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline double __dsqrt_rn(double x) { return sqrt(x); }
static inline float __double2float_rn(double x) { return (float)x; }
"""

ENTRY = r"""
extern "C" void lanes(const float* a, float* u, float* s, float* v, int* its,
                      int n) {
  for (int i = 0; i < n; ++i)
    its[i] = gesdd_lane(a + 9 * i, u + 9 * i, s + 3 * i, v + 9 * i);
}
"""


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    src = open(lapack_svd3.SRC_PATH).read()
    start = src.index("namespace {")
    end = src.index("}  // namespace") + len("}  // namespace")
    root = tmp_path_factory.mktemp("svd3_lane")
    cpp = root / "lane.cpp"
    cpp.write_text(SHIM + src[start:end] + ENTRY)
    lib = root / "liblane.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib))


def run_lanes(lib, F):
    """gesdd_lane on each matrix: U, S, V and each matrix's iterations."""
    F = np.ascontiguousarray(F, np.float32)
    n = len(F)
    u, v = np.empty((n, 3, 3), np.float32), np.empty((n, 3, 3), np.float32)
    s, its = np.empty((n, 3), np.float32), np.empty(n, np.int32)
    ptr = ctypes.c_void_p
    lib.lanes(*(ptr(x.ctypes.data) for x in (F, u, s, v, its)), ctypes.c_int(n))
    return u, s, v, its


def hold_to_plain(lib, F):
    """The lane math against svd3x3_gesdd_plain: the same bits, the same
    count of loop iterations.

    :return: the plain U, S, V and the per-matrix iterations
    """
    before = lapack_svd3.svd3x3_gesdd.iterations
    plain = lapack_svd3.svd3x3_gesdd_plain(torch.from_numpy(F))
    count = lapack_svd3.svd3x3_gesdd.iterations - before
    u, s, v, its = run_lanes(lib, F)
    for name, p, k in zip("USV", plain, (u, s, v)):
        same = chip_smoke.same_bits(p, torch.from_numpy(k))
        assert bool(same.all()), (name, int((~same).sum()))
    assert int(its.max()) == count
    return plain, its


def _randn(scale):
    return (np.random.RandomState(7).randn(4000, 3, 3) * scale).astype(np.float32)


def _bidiagonal():
    """Upper bidiagonal matrices whose entries come from a few values with
    ties, signed zeros and a tiny one: every deflation branch of the loop."""
    vals = np.random.RandomState(8).choice(
        np.array([0.0, -0.0, 1.0, -1.0, 2.0, 0.5, 1e-8, -3.0], np.float32),
        size=(3000, 5))
    B = np.zeros((3000, 3, 3), np.float32)
    B[:, 0, 0], B[:, 1, 1], B[:, 2, 2], B[:, 0, 1], B[:, 1, 2] = vals.T
    return B


def _rank(r):
    rng = np.random.RandomState(9)
    F = sum(rng.randn(2000, 3, 1) * rng.randn(2000, 1, 3) for _ in range(r))
    return F.astype(np.float32)


def _nonfinite():
    rng = np.random.RandomState(10)
    F = rng.randn(2000, 3, 3).astype(np.float32)
    F.reshape(-1)[rng.randint(0, F.size, 1500)] = rng.choice(
        np.array([np.inf, -np.inf, np.nan], np.float32), 1500)
    return F


CASES = {
    "f_plus_i_1e-3": lambda: chip_smoke.gesdd_f_plus_i(1e-3),
    "f_plus_i_1": lambda: chip_smoke.gesdd_f_plus_i(1.0),
    "f_plus_i_1e3": lambda: chip_smoke.gesdd_f_plus_i(1e3),
    "randn_1e-30": lambda: _randn(1e-30),
    "randn_1": lambda: _randn(1.0),
    "randn_1e30": lambda: _randn(1e30),
    "bidiagonal": _bidiagonal,
    "integers": lambda: np.random.RandomState(11).randint(
        -2, 3, size=(5000, 3, 3)).astype(np.float32),
    "rank1": lambda: _rank(1),
    "rank2": lambda: _rank(2),
    "nonfinite": _nonfinite,
}


@pytest.mark.parametrize("case", list(CASES))
def test_lane_math_equals_plain(lane_lib, case):
    hold_to_plain(lane_lib, CASES[case]())


def test_lane_math_on_hand_made_lanes(lane_lib):
    """All the hand-made lanes at once, then each alone (its own count):
    split_top is solved by the (1, 2) dlasv2 block in one iteration and
    two_by_two by the m == 2 block (0, 1) in its second, each with a
    rotation that is no signed permutation."""
    names, F = chip_smoke.gesdd_lanes()
    hold_to_plain(lane_lib, F)
    its = {n: int(hold_to_plain(lane_lib, F[i:i + 1])[1][0])
           for i, n in enumerate(names)}
    assert its["split_top"] == 1 and its["two_by_two"] == 2
    for name in ("split_top", "two_by_two"):
        (_, _, V), _ = hold_to_plain(lane_lib, F[names.index(name)][None])
        assert bool(((V.abs() > 0) & (V.abs() < 1)).any()), name
