// LAPACK-sign 3x3 SVD for Hopper (sm_90a): sgesdd's 3x3 path, one thread
// per matrix.
//
// Replaces no Pallas kernel. The JAX package's ops/lapack_svd3.py is jnp ops,
// and so is the port's plain version, ops/lapack_svd3.py::
// svd3x3_gesdd_plain: every per-lane case a masked update of all lanes, and
// the bidiagonal QR loop ends on a host test of "any lane still active". On
// the card that was ~1,500 launches and one host sync a loop iteration,
// ~8,000 launches a call of 16-40 matrices. This kernel computes the whole
// function in one launch and the loop's exit test stays on the device.
//
// The function (ops/lapack_svd3.py, op for op):
//   gebd2     Householder bidiagonalisation, Q^T A P = B (dlarfg's signs);
//   thresh    max(tol * sminoa, maxitr n^2 unfl) from the forward recurrence;
//   bdsqr3    implicit-shift bidiagonal QR on (d, e) with U_b, VT_b from the
//             identity: per lane `while (m > 1 && it <= maxit)`, netlib's
//             deflation order, dlas2 shifts, dlasv2 2x2 blocks, four sweep
//             variants (zero or nonzero shift, idir 1 or 2);
//   signs     VT_b rows of negative d negated, d = |d|;
//   sort      netlib's two selection passes (smallest to the end, `<=`);
//   U = Q U_b, V = (VT_b P^T)^T.
// The plain version computes every branch on every lane and selects with
// masks; a thread here takes the branch its lane selects and computes only
// that one. The selected values are the same bits.
//
// What bounds it: one lane's serial chain. A matrix takes a few hundred
// float operations, ~30 of them divisions and ~12 float64 square roots a
// sweep, over about 6 loop iterations; bytes (80 a matrix) and operations are
// negligible at the head's 16-40 matrices a call. So the design is one thread
// per matrix, its whole state in registers (d, e, Q, P, U_b, VT_b, m, oldll,
// oldm, idir, it), and one block a call: the block's threads stride over the
// matrices, reduce the most iterations any lane took, and thread 0 adds it to
// a pinned host counter (device-visible under UVA; one writer in stream
// order, no atomics, no sync). At 2,000 matrices a thread takes 8.
//
// The rounding rule. The kernel gives the torch ops' bits on the card, which
// are the CPU's. Every product, sum, difference and quotient is __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn in the Python's association order, so
// nvcc cannot contract them; square roots are float64 roots rounded to
// float32 (as _sqrt). What torch evaluates is mirrored: a Python scalar over
// a tensor (`2.0 / l2`) is a reciprocal then a multiply, `x ** 2` is x * x,
// _sign1 reads the sign bit (sign(1, -0.0) = -1), a `== 0` test holds for
// -0.0, and minimum / maximum / clamp return a NaN operand.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 0x1p-24f;                // slamch('E')
constexpr float kTol = 0x1.4p-21f;              // 10 eps
constexpr float kNTol = 0x1.ep-20f;             // n tol, n = 3
constexpr float kZeroShiftTol = 0x1p-24f;       // max(eps, 0.01 tol)
constexpr float kThreshFloor = 0x1.bp-121f;     // maxitr n^2 unfl
constexpr float kSqrt3 = 0x1.bb67aep+0f;        // float32(sqrt(3))
constexpr int kMaxIt = 54;                      // maxitr n^2, maxitr = 6
constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.reciprocal: `c / x` for a Python scalar c is reciprocal(x) * c.
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }
// _sqrt: the float64 root rounded to float32, the correctly rounded root.
__device__ __forceinline__ float root(float x) {
  return __double2float_rn(__dsqrt_rn((double)x));
}
// torch.minimum / torch.maximum / clamp(min=): a NaN operand is returned.
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// _sign1: Fortran SIGN(1, x) by the sign bit; _fsign: |a| * _sign1(b).
__device__ __forceinline__ float sign1(float x) { return signbit(x) ? -1.0f : 1.0f; }
__device__ __forceinline__ float fsign(float a, float b) { return mul(fabsf(a), sign1(b)); }
// _nonzero(x, ok): x where ok, else 1.
__device__ __forceinline__ float nz(float x, bool ok) { return ok ? x : 1.0f; }

struct Rot {
  float c, s, r;
};

// _lartg: LAPACK 3.11+ slartg.
__device__ __forceinline__ Rot lartg(float f, float g) {
  if (g == 0.0f) return {1.0f, 0.0f, f};
  if (f == 0.0f) return {0.0f, sign1(g), fabsf(g)};
  const float d = root(add(mul(f, f), mul(g, g)));
  const float c = dvd(fabsf(f), nz(d, d > 0.0f));
  const float r = fsign(d, f);
  const float s = dvd(g, nz(r, r != 0.0f));
  return {c, s, r};
}

// _las2: the smaller singular value of [[f, g], [0, h]] (the larger is not
// read by the shift).
__device__ __forceinline__ float las2_min(float f, float g, float h) {
  const float fa = fabsf(f), ga = fabsf(g), ha = fabsf(h);
  const float fhmn = tmin(fa, ha), fhmx = tmax(fa, ha);
  if (fhmn == 0.0f) return 0.0f;
  const float fhmx_safe = nz(fhmx, fhmx > 0.0f);
  const float as_ = add(1.0f, dvd(fhmn, fhmx_safe));
  const float at = dvd(sub(fhmx, fhmn), fhmx_safe);
  if (ga < fhmx) {
    const float q = dvd(ga, fhmx_safe);
    const float au = mul(q, q);
    const float c = mul(rcp(add(root(add(mul(as_, as_), au)),
                                root(add(mul(at, at), au)))), 2.0f);
    return mul(fhmn, c);
  }
  const float ga_safe = nz(ga, ga > 0.0f);
  const float au = dvd(fhmx, ga_safe);
  if (au == 0.0f) return dvd(mul(fhmn, fhmx), ga_safe);
  const float p = mul(as_, au), q = mul(at, au);
  const float c = mul(rcp(add(root(add(1.0f, mul(p, p))),
                              root(add(1.0f, mul(q, q))))), 1.0f);
  const float smin = mul(mul(fhmn, c), au);
  return add(smin, smin);
}

struct Sv2 {
  float ssmin, ssmax, snr, csr, snl, csl;
};

// _lasv2: SVD of [[f, g], [0, h]] with LAPACK's sign conventions.
__device__ __forceinline__ Sv2 lasv2(float f, float g, float h) {
  float ft = f, fa = fabsf(f), ht = h, ha = fabsf(h);
  const bool swap = ha > fa;
  if (swap) {
    ft = h; ht = f;
    const float t = fa; fa = ha; ha = t;
  }
  const float gt = g, ga = fabsf(g);
  int pmax = swap ? 3 : 1;
  if ((ga != 0.0f) & (ga > fa)) pmax = 2;
  const float fa_safe = nz(fa, fa > 0.0f), ga_safe = nz(ga, ga > 0.0f);
  const float ft_safe = nz(ft, ft != 0.0f), gt_safe = nz(gt, gt != 0.0f);
  float ssmin, ssmax, clt, crt, slt, srt;
  if (ga == 0.0f) {
    ssmin = ha; ssmax = fa;
    clt = 1.0f; crt = 1.0f; slt = 0.0f; srt = 0.0f;
  } else if ((ga > fa) && (dvd(fa, ga_safe) < kEps)) {
    ssmax = ga;
    ssmin = ha > 1.0f ? dvd(fa, dvd(ga_safe, nz(ha, ha > 0.0f)))
                      : mul(dvd(fa, ga_safe), ha);
    clt = 1.0f;
    slt = dvd(ht, gt_safe);
    srt = 1.0f;
    crt = dvd(ft, gt_safe);
  } else {
    const float d = sub(fa, ha);
    const float l = d == fa ? 1.0f : dvd(d, fa_safe);
    const float m = dvd(gt, ft_safe);
    const float t = sub(2.0f, l);
    const float mm = mul(m, m), tt = mul(t, t);
    const float s = root(add(tt, mm));
    const float r = l == 0.0f ? fabsf(m) : root(add(mul(l, l), mm));
    const float a = mul(0.5f, add(s, r));
    const float a_safe = nz(a, a > 0.0f);
    ssmin = dvd(ha, a_safe);
    ssmax = mul(fa, a);
    float t2;
    if (mm == 0.0f) {
      if (l == 0.0f) {
        t2 = mul(fsign(2.0f, ft), sign1(gt));
      } else {
        const float fd = fsign(d, ft);
        t2 = add(dvd(gt, nz(fd, fd != 0.0f)), dvd(m, nz(t, t != 0.0f)));
      }
    } else {
      t2 = mul(add(dvd(m, add(s, t)), dvd(m, add(r, l))), add(1.0f, a));
    }
    const float l2 = root(add(mul(t2, t2), 4.0f));
    crt = mul(rcp(l2), 2.0f);
    srt = dvd(t2, l2);
    clt = dvd(add(crt, mul(srt, m)), a_safe);
    slt = dvd(mul(dvd(ht, ft_safe), srt), a_safe);
  }
  Sv2 o;
  o.csl = swap ? srt : clt;
  o.snl = swap ? crt : slt;
  o.csr = swap ? slt : crt;
  o.snr = swap ? clt : srt;
  float tsign;
  if (pmax == 1) {
    tsign = mul(mul(sign1(o.csr), sign1(o.csl)), sign1(f));
  } else if (pmax == 2) {
    tsign = mul(mul(sign1(o.snr), sign1(o.csl)), sign1(g));
  } else {
    tsign = mul(mul(sign1(o.snr), sign1(o.snl)), sign1(h));
  }
  o.ssmax = fsign(ssmax, tsign);
  o.ssmin = fsign(ssmin, mul(mul(tsign, sign1(f)), sign1(h)));
  return o;
}

// _larfg on alpha and an n-long tail x (n = 1, 2): beta, tau, x := v tail.
template <int n>
__device__ __forceinline__ void larfg(float alpha, float* x, float& beta,
                                      float& tau) {
  float sq = mul(x[0], x[0]);
  if (n == 2) sq = add(sq, mul(x[1], x[1]));
  const float xnorm = root(sq);
  const float norm = root(add(mul(alpha, alpha), mul(xnorm, xnorm)));
  if (xnorm == 0.0f) {
    beta = alpha;
    tau = 0.0f;
    return;
  }
  beta = -fsign(norm, alpha);
  const float denom = sub(alpha, beta);
  const float dsafe = nz(denom, denom != 0.0f);
  for (int k = 0; k < n; ++k) x[k] = dvd(x[k], dsafe);
  tau = dvd(sub(beta, alpha), nz(beta, beta != 0.0f));
}

// _apply_left: A := (I - tau v v^T) A, A row-major 3x3.
__device__ __forceinline__ void apply_left(float* A, const float* v, float tau) {
  float w[3];
  for (int j = 0; j < 3; ++j) {
    w[j] = mul(tau, add(add(mul(v[0], A[j]), mul(v[1], A[3 + j])),
                        mul(v[2], A[6 + j])));
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) A[3 * i + j] = sub(A[3 * i + j], mul(v[i], w[j]));
}

// _apply_right: A := A (I - tau u u^T).
__device__ __forceinline__ void apply_right(float* A, const float* u, float tau) {
  float w[3];
  for (int i = 0; i < 3; ++i) {
    w[i] = mul(tau, add(add(mul(A[3 * i], u[0]), mul(A[3 * i + 1], u[1])),
                        mul(A[3 * i + 2], u[2])));
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) A[3 * i + j] = sub(A[3 * i + j], mul(w[i], u[j]));
}

// _rotate_pair on rows (stride 1 between a row's entries, 3 between rows)
// or columns of a row-major 3x3: x, y the pair's first entries, step the
// distance to the next entry of the pair. dlasr: x' = s y + c x; drot:
// x' = c x + s y; both y' = c y - s x.
template <bool kDlasr>
__device__ __forceinline__ void rotate(float* x, float* y, int step, float c,
                                       float s) {
  for (int k = 0; k < 3; ++k) {
    const float xv = x[k * step], yv = y[k * step];
    x[k * step] = kDlasr ? add(mul(s, yv), mul(c, xv)) : add(mul(c, xv), mul(s, yv));
    y[k * step] = sub(mul(c, yv), mul(s, xv));
  }
}
// Rows j, j+1 of VT (dlasr order) and columns j, j+1 of U.
__device__ __forceinline__ void rot_vt(float* VT, int j, float c, float s) {
  rotate<true>(VT + 3 * j, VT + 3 * j + 3, 1, c, s);
}
__device__ __forceinline__ void rot_u(float* U, int j, float c, float s) {
  rotate<true>(U + j, U + j + 1, 3, c, s);
}

// Swap entries i and j of d, rows i and j of VT, columns i and j of U.
__device__ __forceinline__ void swap_sv(float* d, float* VT, float* U, int i, int j) {
  float t = d[i]; d[i] = d[j]; d[j] = t;
  for (int k = 0; k < 3; ++k) {
    t = VT[3 * i + k]; VT[3 * i + k] = VT[3 * j + k]; VT[3 * j + k] = t;
    t = U[3 * k + i]; U[3 * k + i] = U[3 * k + j]; U[3 * k + j] = t;
  }
}

// One matrix: a (9, row-major) -> u (9), s (3), v (9). Returns the QR
// loop's iterations.
__device__ int gesdd_lane(const float* a, float* u_out, float* s_out, float* v_out) {
  // ---- gebd2 ----
  float A[9];
  for (int k = 0; k < 9; ++k) A[k] = a[k];
  float x2[2] = {A[3], A[6]};
  float d0, tq0;
  larfg<2>(A[0], x2, d0, tq0);
  const float v0[3] = {1.0f, x2[0], x2[1]};
  apply_left(A, v0, tq0);
  float x1[1] = {A[2]};
  float e0, tp0;
  larfg<1>(A[1], x1, e0, tp0);
  const float u0[3] = {0.0f, 1.0f, x1[0]};
  apply_right(A, u0, tp0);
  float y1[1] = {A[7]};
  float d1, tq1;
  larfg<1>(A[4], y1, d1, tq1);
  const float v1[3] = {0.0f, 1.0f, y1[0]};
  apply_left(A, v1, tq1);
  float d[3] = {d0, d1, A[8]};
  float e[2] = {e0, A[5]};
  float Q[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  apply_right(Q, v0, tq0);
  apply_right(Q, v1, tq1);
  float P[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  apply_right(P, u0, tp0);

  // ---- thresh ----
  const float mu0 = fabsf(d[0]);
  const float mu1 = mul(fabsf(d[1]), dvd(mu0, add(mu0, fabsf(e[0]))));
  const float mu2 = mul(fabsf(d[2]), dvd(mu1, add(mu1, fabsf(e[1]))));
  const float sminoa = dvd(tmin(mu0, tmin(mu1, mu2)), kSqrt3);
  const float tt = mul(kTol, sminoa);
  const float thresh = tt != tt ? tt : fmaxf(tt, kThreshFloor);

  // ---- bdsqr3 ----
  float VT[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float U[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  int m = 3, oldll = -1, oldm = -1, idir = 0, it = 0, iterations = 0;
  while (m > 1 && it <= kMaxIt) {
    ++iterations;
    if (m == 2) {
      if (fabsf(e[0]) <= thresh) {               // deflate: m = 1
        e[0] = 0.0f;
        m = 1;
      } else {                                   // 2x2 block (0, 1)
        const Sv2 b = lasv2(d[0], e[0], d[1]);
        rotate<false>(VT, VT + 3, 1, b.csr, b.snr);
        rotate<false>(U, U + 1, 3, b.csl, b.snl);
        d[0] = b.ssmax;
        d[1] = b.ssmin;
        e[0] = 0.0f;
        m = 0;
      }
      it += 1;
      continue;
    }
    // m == 3
    if (fabsf(e[1]) <= thresh) {                 // deflate the bottom: m = 2
      e[1] = 0.0f;
      m = 2;
      it += 1;
      continue;
    }
    if (fabsf(e[0]) <= thresh) {                 // split the top: 2x2 (1, 2)
      const Sv2 b = lasv2(d[1], e[1], d[2]);
      rotate<false>(VT + 3, VT + 6, 1, b.csr, b.snr);
      rotate<false>(U + 1, U + 2, 3, b.csl, b.snl);
      d[1] = b.ssmax;
      d[2] = b.ssmin;
      e[0] = 0.0f;
      e[1] = 0.0f;
      m = 1;
      it += 1;
      continue;
    }
    // The full 3x3 block.
    const float ad0 = fabsf(d[0]), ad1 = fabsf(d[1]), ad2 = fabsf(d[2]);
    const float ae0 = fabsf(e[0]), ae1 = fabsf(e[1]);
    const float smax = tmax(tmax(ad0, ad1), tmax(ad2, tmax(ae0, ae1)));
    if ((1 > oldm) | (3 < oldll)) idir = ad0 >= ad2 ? 1 : 2;
    const bool i1 = idir == 1;
    // Convergence tests: each may zero an e and skip the sweep.
    float sminl;
    if (i1) {
      if (ae1 <= mul(kTol, ad2)) { e[1] = 0.0f; it += 1; continue; }
      if (ae0 <= mul(kTol, ad0)) { e[0] = 0.0f; it += 1; continue; }
      const float m1 = mul(ad1, dvd(ad0, add(ad0, ae0)));
      if (ae1 <= mul(kTol, m1)) { e[1] = 0.0f; it += 1; continue; }
      sminl = tmin(ad0, tmin(m1, mul(ad2, dvd(m1, add(m1, ae1)))));
    } else {
      if (ae0 <= mul(kTol, ad0)) { e[0] = 0.0f; it += 1; continue; }
      if (ae1 <= mul(kTol, ad2)) { e[1] = 0.0f; it += 1; continue; }
      const float n1 = mul(ad1, dvd(ad2, add(ad2, ae1)));
      if (ae0 <= mul(kTol, n1)) { e[0] = 0.0f; it += 1; continue; }
      sminl = tmin(ad2, tmin(n1, mul(ad0, dvd(n1, add(n1, ae0)))));
    }
    // The shift.
    float shift = i1 ? las2_min(d[1], e[1], d[2]) : las2_min(d[0], e[0], d[1]);
    const float sll = i1 ? ad0 : ad2;
    if (mul(kNTol, dvd(sminl, nz(smax, smax > 0.0f))) <= kZeroShiftTol) {
      shift = 0.0f;
    } else if (sll > 0.0f) {
      const float q = dvd(shift, nz(sll, sll > 0.0f));
      if (mul(q, q) < kEps) shift = 0.0f;
    }
    const float D0 = d[0], D1 = d[1], D2 = d[2], E0 = e[0], E1 = e[1];
    // vt/u rotations: (c01, s01) on the pair (0, 1), (c12, s12) on (1, 2).
    float vc01, vs01, vc12, vs12, uc01, us01, uc12, us12;
    if (shift == 0.0f && i1) {                   // (a) zero shift, idir 1
      const Rot r1 = lartg(D0, E0);
      const Rot o1 = lartg(r1.r, mul(D1, r1.s));
      const Rot r2 = lartg(mul(D1, r1.c), E1);
      e[0] = mul(o1.s, r2.r);
      const Rot o2 = lartg(mul(o1.c, r2.r), mul(D2, r2.s));
      const float hh = mul(D2, r2.c);
      d[0] = o1.r;
      d[1] = o2.r;
      d[2] = mul(hh, o2.c);
      e[1] = mul(hh, o2.s);
      vc01 = r1.c; vs01 = r1.s; vc12 = r2.c; vs12 = r2.s;
      uc01 = o1.c; us01 = o1.s; uc12 = o2.c; us12 = o2.s;
    } else if (i1) {                             // (b) shift, idir 1
      const float D0s = nz(D0, D0 != 0.0f);
      float f = mul(sub(ad0, shift), add(sign1(D0), dvd(shift, D0s)));
      const Rot r1 = lartg(f, E0);
      f = add(mul(r1.c, D0), mul(r1.s, E0));
      const float te0 = sub(mul(r1.c, E0), mul(r1.s, D0));
      float g = mul(r1.s, D1);
      float td1 = mul(r1.c, D1);
      const Rot l1 = lartg(f, g);
      f = add(mul(l1.c, te0), mul(l1.s, td1));
      td1 = sub(mul(l1.c, td1), mul(l1.s, te0));
      g = mul(l1.s, E1);
      float te1 = mul(l1.c, E1);
      const Rot r2 = lartg(f, g);
      f = add(mul(r2.c, td1), mul(r2.s, te1));
      te1 = sub(mul(r2.c, te1), mul(r2.s, td1));
      g = mul(r2.s, D2);
      const float td2 = mul(r2.c, D2);
      const Rot l2 = lartg(f, g);
      d[0] = l1.r;
      e[0] = r2.r;
      d[1] = l2.r;
      e[1] = add(mul(l2.c, te1), mul(l2.s, td2));
      d[2] = sub(mul(l2.c, td2), mul(l2.s, te1));
      vc01 = r1.c; vs01 = r1.s; vc12 = r2.c; vs12 = r2.s;
      uc01 = l1.c; us01 = l1.s; uc12 = l2.c; us12 = l2.s;
    } else if (shift == 0.0f) {                  // (c) zero shift, idir 2
      const Rot r1 = lartg(D2, E1);
      const Rot o1 = lartg(r1.r, mul(D1, r1.s));
      const Rot r2 = lartg(mul(D1, r1.c), E0);
      e[1] = mul(o1.s, r2.r);
      const Rot o2 = lartg(mul(o1.c, r2.r), mul(D0, r2.s));
      const float hh = mul(D0, r2.c);
      d[2] = o1.r;
      d[1] = o2.r;
      d[0] = mul(hh, o2.c);
      e[0] = mul(hh, o2.s);
      vc01 = o2.c; vs01 = -o2.s; vc12 = o1.c; vs12 = -o1.s;
      uc01 = r2.c; us01 = -r2.s; uc12 = r1.c; us12 = -r1.s;
    } else {                                     // (d) shift, idir 2
      const float D2s = nz(D2, D2 != 0.0f);
      float f = mul(sub(ad2, shift), add(sign1(D2), dvd(shift, D2s)));
      const Rot r2 = lartg(f, E1);
      f = add(mul(r2.c, D2), mul(r2.s, E1));
      float te1 = sub(mul(r2.c, E1), mul(r2.s, D2));
      float g = mul(r2.s, D1);
      float td1 = mul(r2.c, D1);
      const Rot l2 = lartg(f, g);
      f = add(mul(l2.c, te1), mul(l2.s, td1));
      td1 = sub(mul(l2.c, td1), mul(l2.s, te1));
      g = mul(l2.s, E0);
      float te0 = mul(l2.c, E0);
      const Rot r1 = lartg(f, g);
      f = add(mul(r1.c, td1), mul(r1.s, te0));
      te0 = sub(mul(r1.c, te0), mul(r1.s, td1));
      g = mul(r1.s, D0);
      const float td0 = mul(r1.c, D0);
      const Rot l1 = lartg(f, g);
      d[2] = l2.r;
      e[1] = r1.r;
      d[1] = l1.r;
      e[0] = add(mul(l1.c, te0), mul(l1.s, td0));
      d[0] = sub(mul(l1.c, td0), mul(l1.s, te0));
      vc01 = l1.c; vs01 = -l1.s; vc12 = l2.c; vs12 = -l2.s;
      uc01 = r1.c; us01 = -r1.s; uc12 = r2.c; us12 = -r2.s;
    }
    // End-of-sweep negligibility: idir 1 zeroes e1, idir 2 zeroes e0.
    if (i1) {
      if (fabsf(e[1]) <= thresh) e[1] = 0.0f;
      rot_vt(VT, 0, vc01, vs01);
      rot_vt(VT, 1, vc12, vs12);
      rot_u(U, 0, uc01, us01);
      rot_u(U, 1, uc12, us12);
    } else {
      if (fabsf(e[0]) <= thresh) e[0] = 0.0f;
      rot_vt(VT, 1, vc12, vs12);
      rot_vt(VT, 0, vc01, vs01);
      rot_u(U, 1, uc12, us12);
      rot_u(U, 0, uc01, us01);
    }
    oldll = 1;
    oldm = 3;
    it += 2;
  }

  // ---- signs: negate VT's rows of negative values (netlib 160) ----
  for (int k = 0; k < 3; ++k) {
    if (d[k] < 0.0f) {
      for (int j = 0; j < 3; ++j) VT[3 * k + j] = -VT[3 * k + j];
    }
    d[k] = fabsf(d[k]);
  }
  // ---- sort: the smallest of d[0..upto) to tgt, `<=` scan order ----
  for (int tgt = 2; tgt >= 1; --tgt) {
    int isub = 0;
    float smin = d[0];
    for (int j = 1; j <= tgt; ++j) {
      if (d[j] <= smin) { isub = j; smin = d[j]; }
    }
    if (isub != tgt) swap_sv(d, VT, U, isub, tgt);
  }

  // ---- U = Q U_b, V = (VT_b P^T)^T ----
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      u_out[3 * i + j] = add(add(mul(Q[3 * i], U[j]), mul(Q[3 * i + 1], U[3 + j])),
                             mul(Q[3 * i + 2], U[6 + j]));
      v_out[3 * i + j] = add(add(mul(VT[3 * j], P[3 * i]), mul(VT[3 * j + 1], P[3 * i + 1])),
                             mul(VT[3 * j + 2], P[3 * i + 2]));
    }
    s_out[i] = d[i];
  }
  return iterations;
}

}  // namespace

// One block: the threads stride over the n matrices; the block's largest
// lane iteration count is added to *iterations (pinned host memory).
__global__ void __launch_bounds__(kThreads)
svd3_gesdd(const float* __restrict__ a, float* __restrict__ u,
           float* __restrict__ s, float* __restrict__ v,
           volatile long long* iterations, int n) {
  __shared__ int warp_max[kThreads / 32];
  int most = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int its = gesdd_lane(a + 9 * (size_t)i, u + 9 * (size_t)i,
                               s + 3 * (size_t)i, v + 9 * (size_t)i);
    most = max(most, its);
  }
  for (int off = 16; off > 0; off >>= 1)
    most = max(most, __shfl_down_sync(0xffffffffu, most, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = most;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) most = max(most, warp_max[w]);
    *iterations = *iterations + most;
  }
}

// The device's address of pinned host memory (cudaHostGetDevicePointer).
// Returns the call's cudaError_t.
extern "C" int hp3d_mapped_pointer(void* host, void** device) {
  return (int)cudaHostGetDevicePointer(device, host, 0);
}

// a, u, v: (n, 3, 3) float32, s: (n, 3), contiguous on the current device;
// iterations: the device's address (hp3d_mapped_pointer) of one int64 of
// pinned host memory. One launch on `stream`; returns cudaGetLastError().
extern "C" int hp3d_svd3_gesdd(const float* a, float* u, float* s, float* v,
                               void* iterations, int n, void* stream) {
  const int threads = n >= kThreads ? kThreads : ((n + 31) / 32) * 32;
  svd3_gesdd<<<1, threads, 0, (cudaStream_t)stream>>>(
      a, u, s, v, (volatile long long*)iterations, n);
  return (int)cudaGetLastError();
}
