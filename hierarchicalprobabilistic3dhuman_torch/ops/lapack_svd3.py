"""LAPACK-sign 3x3 SVD in torch: sgesdd's 3x3 path, op for op.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/ops/lapack_svd3.py
(_sign1 :53, _fsign :58, _lartg :63, _las2 :86, _lasv2 :128, _larfg :214,
_gebd2 :231, the rotations :280-317, _bdsqr3 :319, svd3x3_gesdd :619):

    sgebd2 (Householder bidiagonalisation, dlarfg sign convention)
      -> sbdsqr (implicit-shift bidiagonal QR: dlartg 3.11+ convention,
                 dlas2 shifts, dlasv2 2x2 deflation, netlib deflation order,
                 relative-accuracy thresholds with slamch f32 constants)
      -> U = Q @ U_b, V^T = VT_b @ P^T, netlib's final sign/sort pass.

Reference checkpoints were trained on the U/V column signs of LAPACK's
gesdd (torch.svd on the CPU), and the hierarchical head feeds each joint's
U_proper columns to its children, so a converted checkpoint reproduces the
reference only with those signs. The signs come from floating-point branch
decisions at tolerance boundaries: a small share of matrices flips a column
sign between two implementations that round differently. XLA on the CPU may
contract `a * b + c` into one FMA, eager torch never does.

Two forms, chosen by the tensor's device; neither falls back to the other.
`svd3x3_gesdd_plain` (CPU tensors): float32 torch ops, batched over the
flattened leading dimensions, every per-lane case a masked update of all
lanes, as in the JAX module. Its bidiagonal QR loop ends on the JAX loop's
condition (any lane still active) and costs one host sync per iteration.
Every product is written out as elementwise multiplies and adds in a fixed
order (no matmul, no reduction kernel), and square roots are taken in
float64, so the card and the CPU round alike and TF32 never enters.
`svd3x3_gesdd_cuda` (CUDA tensors): the kernel of csrc/svd3_gesdd.cu, one
thread per matrix and one launch a call, no host sync, the same operations
in the same order, so the same bits as the torch ops on the card.

Not differentiable (inference and evaluation only).
"""

import ctypes
import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from hierarchicalprobabilistic3dhuman_torch.ops.cuda_build import (
    BUILD_DIR, CSRC_DIR, build_library)
from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import count

# slamch constants for f32.
_EPS = np.float32(2.0 ** -24)           # slamch('E')
_UNFL = np.float32(1.1754943508222875e-38)  # slamch('S')
_MAXITR = 6
_N = 3
# tolmul = max(10, min(100, eps**-0.125)) = 10 for f32; tol = tolmul*eps.
_TOL = np.float32(10.0) * _EPS
_MAXIT = _MAXITR * _N * _N
# Scalars of the shift rule, rounded to float32 as the JAX module's are.
_N_TOL = float(np.float32(_N) * _TOL)
_ZERO_SHIFT_TOL = float(np.maximum(_EPS, np.float32(0.01) * _TOL))
_THRESH_FLOOR = float(np.float32(_MAXITR * _N * _N) * _UNFL)
_SQRT3 = float(np.float32(np.sqrt(3.0)))


def _sqrt(x):
    """The correctly rounded float32 square root on every device, as XLA's:
    torch's float32 sqrt is not always (on an H100 about 0.7% of inputs
    came out an ulp off the CPU's), and the signs hang on branch decisions.
    A float64 root rounded to float32 is the correctly rounded root."""
    return torch.sqrt(x.double()).to(x.dtype)


def _sign1(x):
    """Fortran SIGN(1, x): +-1 by the SIGN BIT (so sign(1, -0.0) = -1)."""
    one = torch.ones_like(x)
    return torch.where(torch.signbit(x), -one, one)


def _fsign(a, b):
    """Fortran SIGN(a, b) = |a| * sign-bit(b)."""
    return torch.abs(a) * _sign1(b)


def _nonzero(x, ok):
    """x where ok, else 1 (a safe divisor)."""
    return torch.where(ok, x, 1.0)


def _lartg(f, g):
    """LAPACK 3.11+ s/dlartg: c = |f|/d, r = sign(f)*d, s = g/r.

    Returns (c, s, r), elementwise over same-shape f, g."""
    d = _sqrt(f * f + g * g)
    c = torch.abs(f) / _nonzero(d, d > 0)
    r = _fsign(d, f)
    s = g / _nonzero(r, r != 0)
    # f == 0 branch: c = 0, s = sign(1, g), r = |g|
    f0 = f == 0
    c = torch.where(f0, 0.0, c)
    s = torch.where(f0, _sign1(g), s)
    r = torch.where(f0, torch.abs(g), r)
    # g == 0 branch (takes precedence): c = 1, s = 0, r = f
    g0 = g == 0
    c = torch.where(g0, 1.0, c)
    s = torch.where(g0, 0.0, s)
    r = torch.where(g0, f, r)
    return c, s, r


def _las2(f, g, h):
    """slas2: singular values of [[f, g], [0, h]] -> (ssmin, ssmax)."""
    fa, ga, ha = torch.abs(f), torch.abs(g), torch.abs(h)
    fhmn = torch.minimum(fa, ha)
    fhmx = torch.maximum(fa, ha)
    fhmx_safe = _nonzero(fhmx, fhmx > 0)
    ga_safe = _nonzero(ga, ga > 0)

    # Branch A: fhmn == 0
    mn = torch.minimum(fhmx, ga)
    mx = torch.maximum(fhmx, ga)
    ssmax_a = torch.where(fhmx == 0, ga,
                          mx * _sqrt(1.0 + (mn / _nonzero(mx, mx > 0)) ** 2))
    # Branch B: ga < fhmx
    as_ = 1.0 + fhmn / fhmx_safe
    at = (fhmx - fhmn) / fhmx_safe
    au_b = (ga / fhmx_safe) ** 2
    c_b = 2.0 / (_sqrt(as_ * as_ + au_b) + _sqrt(at * at + au_b))
    ssmin_b = fhmn * c_b
    ssmax_b = fhmx / _nonzero(c_b, c_b > 0)
    # Branch C: ga >= fhmx
    au_c = fhmx / ga_safe
    # C1: au == 0
    ssmin_c1 = fhmn * fhmx / ga_safe
    ssmax_c1 = ga
    # C2
    c_c = 1.0 / (_sqrt(1.0 + (as_ * au_c) ** 2)
                 + _sqrt(1.0 + (at * au_c) ** 2))
    ssmin_c2 = fhmn * c_c * au_c
    ssmin_c2 = ssmin_c2 + ssmin_c2
    ssmax_c2 = ga / (c_c + c_c)
    ssmin_c = torch.where(au_c == 0, ssmin_c1, ssmin_c2)
    ssmax_c = torch.where(au_c == 0, ssmax_c1, ssmax_c2)

    ssmin = torch.where(fhmn == 0, 0.0,
                        torch.where(ga < fhmx, ssmin_b, ssmin_c))
    ssmax = torch.where(fhmn == 0, ssmax_a,
                        torch.where(ga < fhmx, ssmax_b, ssmax_c))
    return ssmin, ssmax


def _lasv2(f, g, h):
    """slasv2: SVD of [[f, g], [0, h]] with LAPACK sign conventions.

    Returns (ssmin, ssmax, snr, csr, snl, csl), elementwise."""
    ft, fa = f, torch.abs(f)
    ht, ha = h, torch.abs(h)
    swap = ha > fa
    ft, ht = torch.where(swap, ht, ft), torch.where(swap, ft, ht)
    fa, ha = torch.where(swap, ha, fa), torch.where(swap, fa, ha)
    gt, ga = g, torch.abs(g)
    # pmax: 1 = F, 2 = G, 3 = H
    pmax = torch.where(swap, 3, 1)
    pmax = torch.where((ga != 0) & (ga > fa), 2, pmax)

    fa_safe = _nonzero(fa, fa > 0)
    ga_safe = _nonzero(ga, ga > 0)
    ft_safe = _nonzero(ft, ft != 0)
    gt_safe = _nonzero(gt, gt != 0)

    gasmal = ~((ga > fa) & ((fa / ga_safe) < float(_EPS)))

    # --- gasmal = False path (ga overwhelmingly large) ---
    ssmax_big = ga
    ssmin_big = torch.where(ha > 1.0, fa / (ga_safe / _nonzero(ha, ha > 0)),
                            (fa / ga_safe) * ha)
    clt_big = torch.ones_like(f)
    slt_big = ht / gt_safe
    srt_big = torch.ones_like(f)
    crt_big = ft / gt_safe

    # --- gasmal = True path ---
    d_ = fa - ha
    l = torch.where(d_ == fa, 1.0, d_ / fa_safe)
    m_ = gt / ft_safe
    t = 2.0 - l
    mm = m_ * m_
    tt = t * t
    s_ = _sqrt(tt + mm)
    r_ = torch.where(l == 0, torch.abs(m_), _sqrt(l * l + mm))
    a = 0.5 * (s_ + r_)
    a_safe = _nonzero(a, a > 0)
    ssmin_sm = ha / a_safe
    ssmax_sm = fa * a
    # t update
    fsign_d = _fsign(d_, ft)
    t_mm0 = torch.where(l == 0,
                        _fsign(torch.full_like(f, 2.0), ft) * _sign1(gt),
                        gt / _nonzero(fsign_d, fsign_d != 0)
                        + m_ / _nonzero(t, t != 0))
    t_mm1 = (m_ / (s_ + t) + m_ / (r_ + l)) * (1.0 + a)
    t2 = torch.where(mm == 0, t_mm0, t_mm1)
    l2 = _sqrt(t2 * t2 + 4.0)
    crt_sm = 2.0 / l2
    srt_sm = t2 / l2
    clt_sm = (crt_sm + srt_sm * m_) / a_safe
    slt_sm = (ht / ft_safe) * srt_sm / a_safe

    crt = torch.where(gasmal, crt_sm, crt_big)
    srt = torch.where(gasmal, srt_sm, srt_big)
    clt = torch.where(gasmal, clt_sm, clt_big)
    slt = torch.where(gasmal, slt_sm, slt_big)
    ssmin = torch.where(gasmal, ssmin_sm, ssmin_big)
    ssmax = torch.where(gasmal, ssmax_sm, ssmax_big)

    # --- ga == 0 path: diagonal matrix ---
    ga0 = ga == 0
    ssmin = torch.where(ga0, ha, ssmin)
    ssmax = torch.where(ga0, fa, ssmax)
    clt = torch.where(ga0, 1.0, clt)
    crt = torch.where(ga0, 1.0, crt)
    slt = torch.where(ga0, 0.0, slt)
    srt = torch.where(ga0, 0.0, srt)

    csl = torch.where(swap, srt, clt)
    snl = torch.where(swap, crt, slt)
    csr = torch.where(swap, slt, crt)
    snr = torch.where(swap, clt, srt)

    tsign = torch.where(pmax == 1, _sign1(csr) * _sign1(csl) * _sign1(f),
                        torch.where(pmax == 2,
                                    _sign1(snr) * _sign1(csl) * _sign1(g),
                                    _sign1(snr) * _sign1(snl) * _sign1(h)))
    ssmax = _fsign(ssmax, tsign)
    ssmin = _fsign(ssmin, tsign * _sign1(f) * _sign1(h))
    return ssmin, ssmax, snr, csr, snl, csl


def _sum_of_products(terms):
    """a0 b0 + a1 b1 + ..., left to right, as separate multiplies and adds."""
    out = terms[0][0] * terms[0][1]
    for a, b in terms[1:]:
        out = out + a * b
    return out


def _matmul3(A, B):
    """(N, 3, 3) @ (N, 3, 3), each entry a left-to-right sum of products."""
    return _sum_of_products([(A[:, :, k, None], B[:, None, k, :])
                             for k in range(3)])


def _larfg(alpha, x):
    """sdlarfg over the trailing axis: returns (beta, v_tail, tau)."""
    xnorm = _sqrt(_sum_of_products([(x[:, j], x[:, j])
                                         for j in range(x.shape[1])]))
    norm = _sqrt(alpha * alpha + xnorm * xnorm)
    beta = -_fsign(norm, alpha)
    denom = alpha - beta
    v = x / _nonzero(denom, denom != 0)[..., None]
    tau = (beta - alpha) / _nonzero(beta, beta != 0)
    trivial = xnorm == 0
    beta = torch.where(trivial, alpha, beta)
    tau = torch.where(trivial, 0.0, tau)
    v = torch.where(trivial[..., None], x, v)
    return beta, v, tau


def _apply_left(A, v, tau):
    """A := (I - tau v v^T) A."""
    w = tau[:, None] * _sum_of_products([(v[:, i, None], A[:, i, :])
                                         for i in range(3)])
    return A - v[..., None] * w[:, None, :]


def _apply_right(A, u, tau):
    """A := A (I - tau u u^T)."""
    w = tau[:, None] * _sum_of_products([(A[:, :, j], u[:, j, None])
                                         for j in range(3)])
    return A - w[..., None] * u[:, None, :]


def _gebd2(A):
    """Batched 3x3 upper bidiagonalisation (sgebd2 order of operations).

    :param A: (N, 3, 3)
    :return: d (N, 3), e (N, 2), Q (N, 3, 3), P (N, 3, 3) with Q^T A P = B.
    """
    N = A.shape[0]
    ones = A.new_ones((N, 1))
    zeros = A.new_zeros((N, 1))

    # i = 0: left reflector on A[:, 0:3, 0]
    d0, vt0, tq0 = _larfg(A[:, 0, 0], A[:, 1:, 0])
    v0 = torch.cat([ones, vt0], dim=-1)
    A = _apply_left(A, v0, tq0)
    # right reflector on A[:, 0, 1:3]
    e0, ut0, tp0 = _larfg(A[:, 0, 1], A[:, 0, 2:])
    u0 = torch.cat([zeros, ones, ut0], dim=-1)
    A = _apply_right(A, u0, tp0)
    # i = 1: left reflector on A[:, 1:3, 1]
    d1, vt1, tq1 = _larfg(A[:, 1, 1], A[:, 2:, 1])
    v1 = torch.cat([zeros, ones, vt1], dim=-1)
    A = _apply_left(A, v1, tq1)
    # right reflector on A[:, 1, 2:3] is 1-long -> tau = 0, e1 = A[1, 2]
    e1 = A[:, 1, 2]
    # i = 2: left reflector on A[:, 2:3, 2] is 1-long -> tau = 0
    d2 = A[:, 2, 2]

    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(N, 3, 3)
    Q = _apply_right(_apply_right(eye, v0, tq0), v1, tq1)   # Q = H1 H2
    P = _apply_right(eye, u0, tp0)                          # P = G1
    return torch.stack([d0, d1, d2], dim=-1), torch.stack([e0, e1], dim=-1), Q, P


def _rotate_pair(M, j, c, s, mask, axis, order):
    """Rotate rows (axis=1) or columns (axis=2) j, j+1 of M where mask.
    order "dlasr": x' = s y + c x; order "drot": x' = c x + s y; both
    y' = c y - s x."""
    x, y = M.select(axis, j), M.select(axis, j + 1)
    c, s, mask = c[:, None], s[:, None], mask[:, None]
    nx = s * y + c * x if order == "dlasr" else c * x + s * y
    ny = c * y - s * x
    nx, ny = torch.where(mask, nx, x), torch.where(mask, ny, y)
    parts = [M.select(axis, k) for k in range(3)]
    parts[j], parts[j + 1] = nx, ny
    return torch.stack(parts, dim=axis)


def _bdsqr3(d, e, VT, U, thresh):
    """Batched sbdsqr('U', n=3) on (N,) lanes, netlib deflation order.

    :param d: (N, 3) diagonal, e: (N, 2) superdiagonal
    :param VT, U: (N, 3, 3) accumulators (start at identity)
    :param thresh: (N,) absolute negligibility threshold (from caller)
    :return: (d, VT, U) with d >= 0 descending, vectors rotated/sorted, and
        the number of loop iterations
    """
    N = d.shape[0]
    dev = d.device
    m = torch.full((N,), 3, dtype=torch.int32, device=dev)
    oldll = torch.full((N,), -1, dtype=torch.int32, device=dev)
    oldm = torch.full((N,), -1, dtype=torch.int32, device=dev)
    idir = torch.zeros((N,), dtype=torch.int32, device=dev)
    it = torch.zeros((N,), dtype=torch.int32, device=dev)
    ones = torch.ones_like(d[:, 0])
    zeros = torch.zeros_like(d[:, 0])

    iterations = 0
    while bool(torch.any((m > 1) & (it <= _MAXIT))):
        iterations += 1
        d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
        e0, e1 = e[:, 0], e[:, 1]
        active = (m > 1) & (it <= _MAXIT)

        # ---------- case m == 2 ----------
        m2 = active & (m == 2)
        m2_deflate = m2 & (torch.abs(e0) <= thresh)
        m2_2x2 = m2 & ~m2_deflate

        # ---------- case m == 3 ----------
        m3 = active & (m == 3)
        m3_deflate_bot = m3 & (torch.abs(e1) <= thresh)      # e1 -> 0, m = 2
        m3_split_top = m3 & ~m3_deflate_bot & (torch.abs(e0) <= thresh)
        m3_full = m3 & ~m3_deflate_bot & ~m3_split_top

        # --- 2x2 dlasv2 blocks: (k, k+1) = (0, 1) for m2_2x2, (1, 2) for
        # m3_split_top. Compute both lanes' rotations, apply masked.
        sigmn_a, sigmx_a, snr_a, csr_a, snl_a, csl_a = _lasv2(d0, e0, d1)
        sigmn_b, sigmx_b, snr_b, csr_b, snl_b, csl_b = _lasv2(d1, e1, d2)

        # --- full 3x3 block (ll = 1, m = 3, 1-indexed) ---
        smax = torch.maximum(
            torch.maximum(torch.abs(d0), torch.abs(d1)),
            torch.maximum(torch.abs(d2),
                          torch.maximum(torch.abs(e0), torch.abs(e1))))
        new_block = (1 > oldm) | (3 < oldll)
        idir_full = torch.where(
            new_block,
            torch.where(torch.abs(d0) >= torch.abs(d2), 1, 2).to(torch.int32),
            idir)
        # convergence tests (may zero an e and skip the sweep)
        i1 = idir_full == 1
        # idir=1: bottom test then forward recurrence
        conv1_bot = torch.abs(e1) <= float(_TOL) * torch.abs(d2)
        mu0 = torch.abs(d0)
        conv1_f0 = torch.abs(e0) <= float(_TOL) * mu0
        mu1 = torch.abs(d1) * (mu0 / (mu0 + torch.abs(e0)))
        conv1_f1 = torch.abs(e1) <= float(_TOL) * mu1
        sminl_1 = torch.minimum(mu0, torch.minimum(
            mu1, torch.abs(d2) * (mu1 / (mu1 + torch.abs(e1)))))
        # idir=2: top test then backward recurrence
        conv2_top = torch.abs(e0) <= float(_TOL) * torch.abs(d0)
        nu0 = torch.abs(d2)
        conv2_b1 = torch.abs(e1) <= float(_TOL) * nu0
        nu1 = torch.abs(d1) * (nu0 / (nu0 + torch.abs(e1)))
        conv2_b0 = torch.abs(e0) <= float(_TOL) * nu1
        sminl_2 = torch.minimum(nu0, torch.minimum(
            nu1, torch.abs(d0) * (nu1 / (nu1 + torch.abs(e0)))))

        zero_e1_conv = m3_full & (i1 & (conv1_bot | (~conv1_f0 & conv1_f1)))
        zero_e0_conv = m3_full & ((i1 & ~conv1_bot & conv1_f0)
                                  | (~i1 & (conv2_top
                                            | (~conv2_b1 & conv2_b0))))
        zero_e1_conv = zero_e1_conv | (m3_full & ~i1 & ~conv2_top & conv2_b1)
        sweep = m3_full & ~zero_e1_conv & ~zero_e0_conv
        sminl = torch.where(i1, sminl_1, sminl_2)

        # --- shift (only meaningful under `sweep`) ---
        shift1, _ = _las2(d1, e1, d2)   # idir = 1
        shift2, _ = _las2(d0, e0, d1)   # idir = 2
        sll = torch.where(i1, torch.abs(d0), torch.abs(d2))
        shift = torch.where(i1, shift1, shift2)
        use_zero = (_N_TOL * (sminl / _nonzero(smax, smax > 0))
                    <= _ZERO_SHIFT_TOL)
        shift = torch.where(
            use_zero, 0.0,
            torch.where((sll > 0)
                        & ((shift / _nonzero(sll, sll > 0)) ** 2 < float(_EPS)),
                        0.0, shift))
        zshift = shift == 0

        # ---- the four sweep variants (each = 2 Givens pairs), computed on
        # every lane and selected with where.
        d0s = _nonzero(d0, d0 != 0)
        d2s = _nonzero(d2, d2 != 0)

        # (a) zero shift, idir = 1
        cs_a1, sn_a1, r_a = _lartg(d0, e0)
        ocs_a1, osn_a1, nd0_a = _lartg(r_a, d1 * sn_a1)
        cs_a2, sn_a2, r_a2 = _lartg(d1 * cs_a1, e1)
        ne0_a = osn_a1 * r_a2
        ocs_a2, osn_a2, nd1_a = _lartg(ocs_a1 * r_a2, d2 * sn_a2)
        h_a = d2 * cs_a2
        nd2_a = h_a * ocs_a2
        ne1_a = h_a * osn_a2

        # (b) nonzero shift, idir = 1
        f_b = (torch.abs(d0) - shift) * (_sign1(d0) + shift / d0s)
        cr_b1, sr_b1, _r = _lartg(f_b, e0)
        f_b = cr_b1 * d0 + sr_b1 * e0
        te0_b = cr_b1 * e0 - sr_b1 * d0
        g_b = sr_b1 * d1
        td1_b = cr_b1 * d1
        cl_b1, sl_b1, nd0_b = _lartg(f_b, g_b)
        f_b = cl_b1 * te0_b + sl_b1 * td1_b
        td1_b = cl_b1 * td1_b - sl_b1 * te0_b
        g_b = sl_b1 * e1
        te1_b = cl_b1 * e1
        cr_b2, sr_b2, ne0_b = _lartg(f_b, g_b)
        f_b = cr_b2 * td1_b + sr_b2 * te1_b
        te1_b = cr_b2 * te1_b - sr_b2 * td1_b
        g_b = sr_b2 * d2
        td2_b = cr_b2 * d2
        cl_b2, sl_b2, nd1_b = _lartg(f_b, g_b)
        ne1_b = cl_b2 * te1_b + sl_b2 * td2_b
        nd2_b = cl_b2 * td2_b - sl_b2 * te1_b

        # (c) zero shift, idir = 2 (i runs 3 then 2)
        cs_c1, sn_c1, r_c = _lartg(d2, e1)
        ocs_c1, osn_c1, nd2_c = _lartg(r_c, d1 * sn_c1)
        cs_c2, sn_c2, r_c2 = _lartg(d1 * cs_c1, e0)
        ne1_c = osn_c1 * r_c2
        ocs_c2, osn_c2, nd1_c = _lartg(ocs_c1 * r_c2, d0 * sn_c2)
        h_c = d0 * cs_c2
        nd0_c = h_c * ocs_c2
        ne0_c = h_c * osn_c2

        # (d) nonzero shift, idir = 2
        f_d = (torch.abs(d2) - shift) * (_sign1(d2) + shift / d2s)
        cr_d2, sr_d2, _r = _lartg(f_d, e1)           # i = 3 pair
        f_d = cr_d2 * d2 + sr_d2 * e1
        te1_d = cr_d2 * e1 - sr_d2 * d2
        g_d = sr_d2 * d1
        td1_d = cr_d2 * d1
        cl_d2, sl_d2, nd2_d = _lartg(f_d, g_d)
        f_d = cl_d2 * te1_d + sl_d2 * td1_d
        td1_d = cl_d2 * td1_d - sl_d2 * te1_d
        g_d = sl_d2 * e0
        te0_d = cl_d2 * e0
        cr_d1, sr_d1, ne1_d = _lartg(f_d, g_d)       # i = 2 pair
        f_d = cr_d1 * td1_d + sr_d1 * te0_d
        te0_d = cr_d1 * te0_d - sr_d1 * td1_d
        g_d = sr_d1 * d0
        td0_d = cr_d1 * d0
        cl_d1, sl_d1, nd1_d = _lartg(f_d, g_d)
        ne0_d = cl_d1 * te0_d + sl_d1 * td0_d
        nd0_d = cl_d1 * td0_d - sl_d1 * te0_d

        # --- select sweep results ---
        sw_z = sweep & zshift
        sw_s = sweep & ~zshift
        a_m = sw_z & i1
        b_m = sw_s & i1
        c_m = sw_z & ~i1
        dm_ = sw_s & ~i1

        def sel4(va, vb, vc, vd, old):
            out = torch.where(a_m, va, old)
            out = torch.where(b_m, vb, out)
            out = torch.where(c_m, vc, out)
            return torch.where(dm_, vd, out)

        nd0 = sel4(nd0_a, nd0_b, nd0_c, nd0_d, d0)
        nd1 = sel4(nd1_a, nd1_b, nd1_c, nd1_d, d1)
        nd2 = sel4(nd2_a, nd2_b, nd2_c, nd2_d, d2)
        ne0 = sel4(ne0_a, ne0_b, ne0_c, ne0_d, e0)
        ne1 = sel4(ne1_a, ne1_b, ne1_c, ne1_d, e1)
        # end-of-sweep negligibility: idir=1 zeroes e1, idir=2 zeroes e0
        ne1 = torch.where((a_m | b_m) & (torch.abs(ne1) <= thresh), 0.0, ne1)
        ne0 = torch.where((c_m | dm_) & (torch.abs(ne0) <= thresh), 0.0, ne0)

        # --- vector rotations for the sweep ---
        # VT row pairs: idir=1 -> 'F' order (rows01 then rows12) with
        # (cs/sn | cosr/sinr); idir=2 -> 'B' order (rows12 then rows01) with
        # (oldcs/-oldsn | cosl/-sinl).
        vt_c01 = sel4(cs_a1, cr_b1, ocs_c2, cl_d1, ones)
        vt_s01 = sel4(sn_a1, sr_b1, -osn_c2, -sl_d1, zeros)
        vt_c12 = sel4(cs_a2, cr_b2, ocs_c1, cl_d2, ones)
        vt_s12 = sel4(sn_a2, sr_b2, -osn_c1, -sl_d2, zeros)
        u_c01 = sel4(ocs_a1, cl_b1, cs_c2, cr_d1, ones)
        u_s01 = sel4(osn_a1, sl_b1, -sn_c2, -sr_d1, zeros)
        u_c12 = sel4(ocs_a2, cl_b2, cs_c1, cr_d2, ones)
        u_s12 = sel4(osn_a2, sl_b2, -sn_c1, -sr_d2, zeros)

        fwd = sweep & i1
        bwd = sweep & ~i1
        # forward order: (0,1) then (1,2); backward order: (1,2) then (0,1)
        VT = _rotate_pair(VT, 0, vt_c01, vt_s01, fwd, 1, "dlasr")
        VT = _rotate_pair(VT, 1, vt_c12, vt_s12, fwd, 1, "dlasr")
        VT = _rotate_pair(VT, 1, vt_c12, vt_s12, bwd, 1, "dlasr")
        VT = _rotate_pair(VT, 0, vt_c01, vt_s01, bwd, 1, "dlasr")
        U = _rotate_pair(U, 0, u_c01, u_s01, fwd, 2, "dlasr")
        U = _rotate_pair(U, 1, u_c12, u_s12, fwd, 2, "dlasr")
        U = _rotate_pair(U, 1, u_c12, u_s12, bwd, 2, "dlasr")
        U = _rotate_pair(U, 0, u_c01, u_s01, bwd, 2, "dlasr")

        # --- 2x2 dlasv2 applications ---
        VT = _rotate_pair(VT, 0, csr_a, snr_a, m2_2x2, 1, "drot")
        U = _rotate_pair(U, 0, csl_a, snl_a, m2_2x2, 2, "drot")
        VT = _rotate_pair(VT, 1, csr_b, snr_b, m3_split_top, 1, "drot")
        U = _rotate_pair(U, 1, csl_b, snl_b, m3_split_top, 2, "drot")

        # --- d/e updates for deflation cases ---
        nd0 = torch.where(m2_2x2, sigmx_a, nd0)
        nd1 = torch.where(m2_2x2, sigmn_a, nd1)
        nd1 = torch.where(m3_split_top, sigmx_b, nd1)
        nd2 = torch.where(m3_split_top, sigmn_b, nd2)
        ne0 = torch.where(m2_deflate | m2_2x2 | m3_split_top | zero_e0_conv,
                          0.0, ne0)
        ne1 = torch.where(m3_deflate_bot | m3_split_top | zero_e1_conv,
                          0.0, ne1)

        # --- m updates ---
        nm = torch.where(m2_deflate, 1, m)
        nm = torch.where(m2_2x2, 0, nm)
        nm = torch.where(m3_deflate_bot, 2, nm)
        m = torch.where(m3_split_top, 1, nm).to(torch.int32)

        oldll = torch.where(sweep, 1, oldll).to(torch.int32)
        oldm = torch.where(sweep, 3, oldm).to(torch.int32)
        idir = torch.where(m3_full, idir_full, idir)
        nit = torch.where(sweep, it + 2, it)
        # Inert lanes must not spin forever: bump `it` on non-sweep
        # iterations too, so the loop provably ends.
        it = torch.where(active & ~sweep, nit + 1, nit)

        d = torch.stack([nd0, nd1, nd2], dim=-1)
        e = torch.stack([ne0, ne1], dim=-1)

    # --- make singular values positive (flip VT rows only; netlib 160) ---
    VT = torch.where((d < 0)[:, :, None], -VT, VT)
    d = torch.abs(d)

    # --- netlib's sort: selection of the SMALLEST among d(1..n+1-i), one
    # transposition per pass, `<=` scan order ---
    def pass_swap(d, VT, U, upto, tgt):
        isub = torch.zeros((N,), dtype=torch.int64, device=dev)
        smin = d[:, 0]
        for j in range(1, upto):
            take = d[:, j] <= smin
            isub = torch.where(take, j, isub)
            smin = torch.where(take, d[:, j], smin)
        do = isub != tgt
        lanes = torch.arange(N, device=dev)
        onehot = F.one_hot(isub, 3).bool()                     # (N, 3)
        d_new = torch.where(onehot, d[:, tgt, None], d)
        d_new[:, tgt] = smin
        d = torch.where(do[:, None], d_new, d)
        vt_isub = VT[lanes, isub]                              # (N, 3)
        VT_new = torch.where(onehot[:, :, None], VT[:, tgt, None, :], VT)
        VT_new[:, tgt, :] = vt_isub
        VT = torch.where(do[:, None, None], VT_new, VT)
        u_isub = U[lanes, :, isub]                             # (N, 3)
        U_new = torch.where(onehot[:, None, :], U[:, :, tgt, None], U)
        U_new[:, :, tgt] = u_isub
        U = torch.where(do[:, None, None], U_new, U)
        return d, VT, U

    d, VT, U = pass_swap(d, VT, U, upto=3, tgt=2)
    d, VT, U = pass_swap(d, VT, U, upto=2, tgt=1)
    # One blocking read a test of the loop's condition.
    count("host_syncs", iterations + 1)
    return d, VT, U, iterations


def svd3x3_gesdd_plain(F):
    """svd3x3_gesdd as torch ops (the module docstring): what CPU tensors
    take, and the kernel's plain version on the card. Adds its bidiagonal
    QR loop's iterations, one host sync each, to `svd3x3_gesdd.iterations`.

    :param F: (..., 3, 3)
    :return: U (..., 3, 3), S (..., 3), V (..., 3, 3), float32
    """
    batch = F.shape[:-2]
    A = F.reshape(-1, 3, 3).to(torch.float32)
    N = A.shape[0]
    d, e, Q, P = _gebd2(A)

    # thresh = max(tol * sminoa, maxitr*n*n*unfl), sminoa from the forward
    # recurrence over the bidiagonal (netlib dbdsqr prologue).
    mu0 = torch.abs(d[:, 0])
    mu1 = torch.abs(d[:, 1]) * (mu0 / (mu0 + torch.abs(e[:, 0])))
    mu2 = torch.abs(d[:, 2]) * (mu1 / (mu1 + torch.abs(e[:, 1])))
    # A tensor divisor: a Python one is turned into a multiply by its
    # reciprocal on the card, which rounds differently from the CPU.
    sminoa = (torch.minimum(mu0, torch.minimum(mu1, mu2))
              / torch.full_like(mu0, _SQRT3))
    thresh = torch.clamp(float(_TOL) * sminoa, min=_THRESH_FLOOR)

    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(N, 3, 3)
    s, VT_b, U_b, iterations = _bdsqr3(d, e, eye, eye, thresh)
    svd3x3_gesdd.plain_iterations += iterations

    U = _matmul3(Q, U_b)
    V = _matmul3(VT_b, P.transpose(-1, -2)).transpose(-1, -2)
    return (U.reshape(batch + (3, 3)), s.reshape(batch + (3,)),
            V.reshape(batch + (3, 3)))


SRC_PATH = os.path.join(CSRC_DIR, "svd3_gesdd.cu")
LIB_PATH = os.path.join(BUILD_DIR, "libsvd3_gesdd.so")
LOG_PATH = os.path.join(BUILD_DIR, "libsvd3_gesdd.log")


def build_svd3_gesdd():
    """Compile csrc/svd3_gesdd.cu into build/hp3d_torch_kernels/
    libsvd3_gesdd.so (skipped while the library is newer than the source),
    with nvcc's register report in libsvd3_gesdd.log beside it.

    :return: the library path
    """
    return build_library(SRC_PATH, LIB_PATH, LOG_PATH)


@lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_svd3_gesdd())
    lib.hp3d_svd3_gesdd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int,
                                                             ctypes.c_void_p]
    lib.hp3d_svd3_gesdd.restype = ctypes.c_int
    lib.hp3d_mapped_pointer.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_void_p)]
    lib.hp3d_mapped_pointer.restype = ctypes.c_int
    return lib


def svd3x3_gesdd_cuda(F):
    """Launch the svd3_gesdd kernel: svd3x3_gesdd_plain's U, S, V, bit for
    bit as its torch ops give them on the card, in one launch on the current
    stream and with no host sync. The kernel adds the loop's iterations (the
    most any matrix took) to `svd3x3_gesdd.iterations` in pinned host
    memory: the count is exact once the stream has been synchronised. It has
    no backward: an input that requires grad under grad mode raises.

    :param F: (..., 3, 3) float32 on the card
    :return: U (..., 3, 3), S (..., 3), V (..., 3, 3), float32
    """
    if not F.is_cuda or F.dtype != torch.float32:
        raise ValueError(f"svd3x3_gesdd_cuda: need a CUDA float32 tensor, got "
                         f"{F.dtype} on {F.device}")
    if F.dim() < 2 or tuple(F.shape[-2:]) != (3, 3):
        raise ValueError(f"svd3x3_gesdd_cuda: need shape (..., 3, 3), got "
                         f"{tuple(F.shape)}")
    if torch.is_grad_enabled() and F.requires_grad:
        raise RuntimeError("svd3x3_gesdd_cuda has no backward: call it under "
                           "torch.no_grad()")
    batch = F.shape[:-2]
    A = F.reshape(-1, 3, 3).contiguous()
    N = A.shape[0]
    if N >= 2 ** 31:
        raise ValueError(f"svd3x3_gesdd_cuda: {N} matrices, at most 2**31 - 1")
    U = torch.empty_like(A)
    S = torch.empty((N, 3), dtype=torch.float32, device=A.device)
    V = torch.empty_like(A)
    if N:                      # a launch of no threads fails
        with torch.cuda.device(A.device):
            counter = svd3x3_gesdd.device_counter()
            stream = torch.cuda.current_stream(A.device).cuda_stream
            err = _library().hp3d_svd3_gesdd(
                A.data_ptr(), U.data_ptr(), S.data_ptr(), V.data_ptr(),
                counter, N, stream)
        if err != 0:
            raise RuntimeError(f"svd3_gesdd kernel launch failed: cudaError {err}")
        svd3x3_gesdd_cuda.launches += 1
    return (U.reshape(batch + (3, 3)), S.reshape(batch + (3,)),
            V.reshape(batch + (3, 3)))


svd3x3_gesdd_cuda.launches = 0


class _Gesdd:
    """svd3x3_gesdd(F): batched 3x3 SVD with LAPACK sgesdd sign conventions,
    with the running count of its bidiagonal QR loop's iterations.

    F = U @ diag(S) @ V^T with S >= 0 descending and U/V column signs as
    np.linalg.svd gives them on ~98% of generic inputs (the rest are column
    sign flips at floating-point branch boundaries; see the module
    docstring). CUDA tensors take the kernel (svd3x3_gesdd_cuda), CPU
    tensors the torch ops (svd3x3_gesdd_plain); both give the same bits.

    `iterations` adds up, over the calls, the loop's trip count (the most
    iterations any matrix took): on the CPU one host sync each; on the card
    one pinned host counter that the kernel adds to in stream order, so read
    it (or set it, e.g. to 0) once the stream is idle.
    """

    def __init__(self):
        self.plain_iterations = 0
        self._counter = None  # pinned int64 (1,), its device address

    def __call__(self, F):
        """:param F: (..., 3, 3)
        :return: U (..., 3, 3), S (..., 3), V (..., 3, 3), float32
        """
        device = F.device
        if device.type == "cuda":
            return svd3x3_gesdd_cuda(F.to(torch.float32))
        if device.type != "cpu":
            raise ValueError(f"no svd3x3_gesdd for device {device}")
        return svd3x3_gesdd_plain(F)

    def device_counter(self):
        """The device address of the pinned int64 the kernel adds its loop
        counts to, made on the first call's card (a process of the port
        drives one card). Made outside inference mode, so that `= 0` may
        reset it in either mode."""
        if self._counter is None:
            with torch.inference_mode(False):
                host = torch.zeros(1, dtype=torch.int64, pin_memory=True)
            address = ctypes.c_void_p()
            err = _library().hp3d_mapped_pointer(host.data_ptr(),
                                                 ctypes.byref(address))
            if err != 0:
                raise RuntimeError(f"no device address for the pinned "
                                   f"iteration counter: cudaError {err}")
            self._counter = (host, address.value)
        return self._counter[1]

    @property
    def iterations(self):
        card = 0 if self._counter is None else int(self._counter[0][0])
        return self.plain_iterations + card

    @iterations.setter
    def iterations(self, value):
        if self._counter is not None:
            self._counter[0].zero_()
        self.plain_iterations = value


svd3x3_gesdd = _Gesdd()
