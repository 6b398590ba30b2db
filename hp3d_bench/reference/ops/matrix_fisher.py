"""Matrix-Fisher distribution over SO(3): log normalising constant + NLL.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/ops/matrix_fisher.py
(bessel0_exp_scaled :34, the trapezoid grid :50, _cbar_integrand :57,
_dcbar_integrand :73, _cbar :88, log_mf_norm_constant :93-121,
matrix_fisher_nll :124). log c(S) comes from the proper singular values by a
512-point trapezoid quadrature of products of exponentially scaled Bessel
functions (Eqns 85-90 of arXiv:1710.03746). Its gradient is not the
quadrature's autograd: `LogMFNormConstant` saves S and c_bar and its
backward evaluates the three cyclic-shift derivative integrals, as the JAX
package's custom_vjp does.
"""

import torch

from hp3d_bench.reference.ops.svd3 import det3x3

# Abramowitz & Stegun 9.8.1/9.8.2 coefficients for I_0, highest order first.
_I0_COEFFS_SMALL = (0.45813e-2, 0.360768e-1, 0.2659732, 1.2067492, 3.0899424,
                    3.5156229, 1.0)
_I0_COEFFS_LARGE = (0.392377e-2, -0.1647633e-1, 0.2635537e-1, -0.2057706e-1,
                    0.916281e-2, -0.157565e-2, 0.225319e-2, 0.1328592e-1,
                    0.39894228)

_NUM_TRAPS = 512


def _polyval(coeffs, x):
    """Horner's rule, as jnp.polyval evaluates it."""
    out = torch.zeros_like(x)
    for c in coeffs:
        out = out * x + c
    return out


def bessel0_exp_scaled(x):
    """I_0(x) / exp(|x|), branch at |x| = 3.75 as in A&S; both branches are
    computed and selected with `where`, the untaken one on a safe input."""
    abs_x = torch.abs(x)
    small = abs_x <= 3.75
    val_small = _polyval(_I0_COEFFS_SMALL, (abs_x / 3.75) ** 2) / torch.exp(abs_x)
    abs_x_safe = torch.where(small, torch.full_like(abs_x, 3.75), abs_x)
    val_large = (_polyval(_I0_COEFFS_LARGE, 3.75 / abs_x_safe)
                 / torch.sqrt(abs_x_safe))
    return torch.where(small, val_small, val_large)


def _trapezoid_u_grid(dtype, device):
    """Nodes u (T,) on [-1, 1] and trapezoid weights times the step."""
    u = torch.linspace(-1.0, 1.0, _NUM_TRAPS, dtype=dtype, device=device)
    w = torch.ones(_NUM_TRAPS, dtype=dtype, device=device)
    w[0] = w[-1] = 0.5
    return u, w * (2.0 / (_NUM_TRAPS - 1))


def _cbar_integrand(u, s):
    """Integrand of c_bar(S). u (T,), s (..., 3) -> (..., T)."""
    s0, s1, s2 = s[..., 0:1], s[..., 1:2], s[..., 2:3]
    f1 = bessel0_exp_scaled((s1 - s2) * 0.5 * (1.0 - u))
    f2 = bessel0_exp_scaled((s1 + s2) * 0.5 * (1.0 + u))
    f3 = torch.exp((s2 + s0) * (u - 1.0))
    return f1 * f2 * f3


def _dcbar_integrand(u, s_shifted):
    """Integrand of dc_bar/ds_k + c_bar for cyclically shifted s (s_k
    first)."""
    s_k = s_shifted[..., 0:1]
    s_i = torch.maximum(s_shifted[..., 1:2], s_shifted[..., 2:3])
    s_j = torch.minimum(s_shifted[..., 1:2], s_shifted[..., 2:3])
    f1 = bessel0_exp_scaled((s_i - s_j) * 0.5 * (1.0 - u))
    f2 = bessel0_exp_scaled((s_i + s_j) * 0.5 * (1.0 + u))
    f3 = torch.exp((s_j + s_k) * (u - 1.0))
    return f1 * f2 * f3 * u


def _cbar(S):
    u, w = _trapezoid_u_grid(S.dtype, S.device)
    return 0.5 * torch.sum(_cbar_integrand(u, S) * w, dim=-1)


class LogMFNormConstant(torch.autograd.Function):
    """log c(S) = log c_bar(S) + tr(S) for proper singular values (..., 3),
    ordered s0 >= s1 >= |s2|; backward by the derivative integrals."""

    @staticmethod
    def forward(ctx, S_proper):
        c_bar = _cbar(S_proper)
        ctx.save_for_backward(S_proper, c_bar)
        return torch.log(c_bar) + torch.sum(S_proper, dim=-1)

    @staticmethod
    def backward(ctx, grad_log_c):
        S, c_bar = ctx.saved_tensors
        u, w = _trapezoid_u_grid(S.dtype, S.device)
        grads = []
        for k in range(3):
            S_shifted = torch.cat([S[..., k:], S[..., :k]], dim=-1)
            integral = 0.5 * torch.sum(_dcbar_integrand(u, S_shifted) * w, dim=-1)
            grads.append(integral / c_bar)
        return torch.stack(grads, dim=-1) * grad_log_c[..., None]


def log_mf_norm_constant(S_proper):
    return LogMFNormConstant.apply(S_proper)


def matrix_fisher_nll(pred_F, pred_U, pred_S, pred_V, target_R, overreg=1.025):
    """NLL of target rotations under MF(F): -tr(F^T R) + overreg log c(S_proper).

    The det sign is piecewise constant and carries no gradient.

    :param pred_F: (..., 3, 3); pred_U/S/V: its SVD
    :param target_R: (..., 3, 3)
    :return: (...,) NLL per batch element
    """
    s3sign = det3x3(pred_U @ pred_V.transpose(-1, -2)).detach()
    S_proper = torch.cat([pred_S[..., :2], pred_S[..., 2:] * s3sign[..., None]],
                         dim=-1)
    log_exponent = -torch.sum(pred_F * target_R, dim=(-1, -2))
    return log_exponent + overreg * log_mf_norm_constant(S_proper)
