// One-sided Jacobi 3x3 SVD and its reverse-mode derivative for Hopper
// (sm_90a): one thread per matrix, one launch a call.
//
// Replaces no Pallas kernel. The JAX package's ops/svd3.py::svd3x3 is jnp
// ops under a fori_loop, and so is the port's plain version,
// ops/svd3.py::svd3x3_plain: each of the 8 sweeps x 3 rotations is some 41
// ATen kernels (three dot products, the angle, the clone-and-scatter column
// updates of A and V), and the sort and U's rebuild some 50 more, ~1,030 a
// call; autograd's mirror of them is about twice that. The pose head calls it
// once a depth group (8 a forward), so its CUDA graphs held ~29,000 such
// nodes a B = 72 train step. These two kernels compute the same function and
// its derivative in one launch each.
//
// The function (ops/svd3.py::svd3x3_plain, op for op):
//   sweeps    n_sweeps x the rotations (0, 1), (0, 2), (1, 2) of A's
//             columns, each angle 0.5 atan2(2 a_pq, a_pp - a_qq), (0, 1) at
//             the exact degenerate point (|num| and |den| below 1e-30), V
//             rotated alike from the identity;
//   S         the column norms of A, sqrt(clamp(., 0));
//   sort      stable, descending S (NaN last), A's and V's columns with it;
//   U         A's first column normalised (e0 below 1e-12), the second
//             orthogonalised and normalised (a cross-product fallback below
//             1e-12), the third u0 x u1 signed like A's third column.
// The derivative (`svd3_jacobi_bwd`) is the exact reverse-mode derivative of
// that unrolled algorithm, what autograd takes through the torch ops and
// JAX through its fori_loop: not the closed-form SVD gradient, from which it
// differs after 8 sweeps and near equal singular values. Branches are
// differentiated as torch.where is (the unselected side gets zero), the
// clamps as torch's clamp (the gradient passes where x >= min), the norms as
// linalg.vector_norm's (zero at a zero norm), sqrt as grad / (2 result) and
// atan2 as grad * (den, -num) / (num^2 + den^2), zero on the degenerate
// branch. A gradient that is not given (None) counts as zero and is never
// read, so S's 1 / (2 S) is taken only where S's gradient exists, as in
// autograd.
//
// What bounds it: one matrix's serial chain of 24 rotations, each an atan2,
// a cos and a sin after three dot products; the bytes are ~100 a matrix
// (F in, U, S, V out; twice that for the backward) and the operations a few
// thousand, so at the head's 72 x 1-5 matrices a call neither bandwidth nor
// arithmetic is near a limit: a call is the chain's latency. So the design
// is one thread per matrix, its whole state in registers, one launch a call
// (a depth group in the head), grid = ceil(n / 128). The backward recomputes
// the forward from F and keeps what each rotation read (the A and V columns,
// num, den, c, s) in local memory, kMaxSweeps x 3 records a thread; it
// writes grad F and uses no atomics, so it is deterministic.
//
// The rounding rule. The forward gives the torch ops' bits on the card. Every
// product, sum, difference and quotient is __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn (their float64 twins) in the Python's order of association, so
// nvcc cannot contract them; atan2, cos, sin and sqrt are the CUDA math
// library's, as ATen's kernels call them. The orders are ATen's: torch.sum
// over a contiguous last axis of 3 runs on two lanes (x0 + x2, then + x1),
// over the second-to-last one lane takes x0, x1, x2; every accumulator starts
// at +0 (so a -0 product sums to +0); linalg.vector_norm is the same
// two-lane sum of squares and a root; linalg.cross's a*b - c*d is compiled
// by nvcc as fma(a, b, -(c*d)). The backward is not held to autograd's bits,
// only to its value.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// The most sweeps the backward's local records hold (the configs use 8).
constexpr int kMaxSweeps = 8;
constexpr int kThreads = 128;
constexpr double kTiny = 1e-30;      // ops/svd3.py::_TINY
constexpr double kEps = 1e-12;       // U's rebuild
constexpr double kFallback = 0.1;    // the first cross-product fallback's norm

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float root(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double root(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float arctan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double arctan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float cosine(float x) { return cosf(x); }
__device__ __forceinline__ double cosine(double x) { return cos(x); }
__device__ __forceinline__ float sine(float x) { return sinf(x); }
__device__ __forceinline__ double sine(double x) { return sin(x); }
__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ double magnitude(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ bool isnan_(T x) { return x != x; }

// torch.sum(x, dim=-1) over 3 contiguous values on the card.
template <typename T>
__device__ __forceinline__ T sum_last(T x0, T x1, T x2) {
  const T z = T(0);
  return add(add(add(z, x0), add(z, x2)), add(z, x1));
}

// torch.sum(x, dim=-2) over 3 values: one lane, in order.
template <typename T>
__device__ __forceinline__ T sum_rows(T x0, T x1, T x2) {
  const T z = T(0);
  return add(add(add(z, x0), add(z, x1)), add(z, x2));
}

template <typename T>
__device__ __forceinline__ T dot(const T* a, const T* b) {
  return sum_last(mul(a[0], b[0]), mul(a[1], b[1]), mul(a[2], b[2]));
}

// linalg.vector_norm(x, dim=-1).
template <typename T>
__device__ __forceinline__ T norm(const T* x) { return root(dot(x, x)); }

// clamp(x, min=lo): a NaN x is returned.
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }

// linalg.cross(a, b) as nvcc compiles ATen's a1 b2 - a2 b1.
template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* out) {
  out[0] = fmadd(a[1], b[2], -mul(a[2], b[1]));
  out[1] = fmadd(a[2], b[0], -mul(a[0], b[2]));
  out[2] = fmadd(a[0], b[1], -mul(a[1], b[0]));
}

// The (p, q) column pair of rotation r of a sweep.
__device__ __forceinline__ int col_p(int r) { return r == 2 ? 1 : 0; }
__device__ __forceinline__ int col_q(int r) { return r == 0 ? 1 : 2; }

// What one rotation read: the backward's record of it.
template <typename T>
struct Rotation {
  T ap[3], aq[3], vp[3], vq[3];  // A's and V's columns p, q before it
  T num, den;                    // atan2's arguments; both 0 if degenerate
  T c, s;
};

// M (3x3, row-major) := M G(p, q): columns p, q rotated by (c, s).
template <typename T>
__device__ __forceinline__ void rotate(T* M, int p, int q, T c, T s) {
  for (int i = 0; i < 3; ++i) {
    const T mp = M[3 * i + p], mq = M[3 * i + q];
    M[3 * i + p] = add(mul(c, mp), mul(s, mq));
    M[3 * i + q] = add(mul(-s, mp), mul(c, mq));
  }
}

// The sweeps on A (from F) and V (from the identity); each rotation's inputs
// recorded in `tape` where it is not null.
template <typename T>
__device__ void sweeps(T* A, T* V, int n_sweeps, Rotation<T>* tape) {
  for (int k = 0; k < n_sweeps; ++k) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = col_p(r), q = col_q(r);
      const T ap[3] = {A[p], A[3 + p], A[6 + p]};
      const T aq[3] = {A[q], A[3 + q], A[6 + q]};
      const T app = dot(ap, ap), aqq = dot(aq, aq), apq = dot(ap, aq);
      T num = mul(T(2), apq);
      T den = sub(app, aqq);
      const bool degenerate = magnitude(num) < T(kTiny) && magnitude(den) < T(kTiny);
      if (degenerate) {
        num = T(0);
        den = T(1);
      }
      const T theta = mul(T(0.5), arctan2(num, den));
      const T c = cosine(theta), s = sine(theta);
      if (tape != nullptr) {
        Rotation<T>& rec = tape[3 * k + r];
        for (int i = 0; i < 3; ++i) {
          rec.ap[i] = ap[i];
          rec.aq[i] = aq[i];
          rec.vp[i] = V[3 * i + p];
          rec.vq[i] = V[3 * i + q];
        }
        rec.num = degenerate ? T(0) : num;
        rec.den = degenerate ? T(0) : den;
        rec.c = c;
        rec.s = s;
      }
      rotate(A, p, q, c, s);
      rotate(V, p, q, c, s);
    }
  }
}

// What the sort and U's rebuild computed: the backward's record of them.
template <typename T>
struct Rebuild {
  int order[3];        // sorted column j is column order[j]
  T S[3];              // the unsorted column norms
  T a[3][3];           // the sorted A's columns
  T u0n, u0[3];
  bool sel0;           // u0 = a0 / max(u0n, eps), else e0
  T proj, u1o[3], u1n; // u1o = a1 - proj u0
  bool sel1;           // u1 = u1o / max(u1n, eps), else the fallback
  bool sel_a;          // the fallback is (-u0_1, u0_0, 0), else (0, -u0_2, u0_1)
  T fb[3], fbn;        // the fallback chosen and its norm
  T u1[3];
  T sign;              // of U's third column
};

// S, the sort and U from the swept A and V; U, S, V written (row-major).
template <typename T>
__device__ void rebuild(const T* A, const T* V, T* u, T* s, T* v, Rebuild<T>& rb) {
  const T eps = T(kEps);
  T key[3];
  for (int j = 0; j < 3; ++j) {
    const T colsq = sum_rows(mul(A[j], A[j]), mul(A[3 + j], A[3 + j]),
                             mul(A[6 + j], A[6 + j]));
    rb.S[j] = root(clamp_min(colsq, T(0)));
    key[j] = -rb.S[j];
  }
  // argsort(-S, stable=True): insertion sort, ties keep their order, NaN last.
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i) {
    const int o = order[i];
    int j = i;
    while (j > 0 && ((key[o] < key[order[j - 1]])
                     || (!isnan_(key[o]) && isnan_(key[order[j - 1]])))) {
      order[j] = order[j - 1];
      --j;
    }
    order[j] = o;
  }
  for (int j = 0; j < 3; ++j) {
    rb.order[j] = order[j];
    s[j] = rb.S[order[j]];
    for (int i = 0; i < 3; ++i) {
      rb.a[j][i] = A[3 * i + order[j]];
      v[3 * i + j] = V[3 * i + order[j]];
    }
  }

  const T* a0 = rb.a[0];
  const T* a1 = rb.a[1];
  rb.u0n = norm(a0);
  rb.sel0 = rb.u0n > eps;
  const T c0 = clamp_min(rb.u0n, eps);
  for (int i = 0; i < 3; ++i)
    rb.u0[i] = rb.sel0 ? dvd(a0[i], c0) : (i == 0 ? T(1) : T(0));
  const T* u0 = rb.u0;

  rb.proj = dot(u0, a1);
  for (int i = 0; i < 3; ++i) rb.u1o[i] = sub(a1[i], mul(rb.proj, u0[i]));
  rb.u1n = norm(rb.u1o);
  const T fa[3] = {-u0[1], u0[0], T(0)};
  const T fb[3] = {T(0), -u0[2], u0[1]};
  rb.sel_a = norm(fa) > T(kFallback);
  for (int i = 0; i < 3; ++i) rb.fb[i] = rb.sel_a ? fa[i] : fb[i];
  rb.fbn = norm(rb.fb);
  rb.sel1 = rb.u1n > eps;
  const T c1 = clamp_min(rb.u1n, eps), cf = clamp_min(rb.fbn, eps);
  for (int i = 0; i < 3; ++i)
    rb.u1[i] = rb.sel1 ? dvd(rb.u1o[i], c1) : dvd(rb.fb[i], cf);

  T u2[3];
  cross(u0, rb.u1, u2);
  rb.sign = dot(u2, rb.a[2]) < T(0) ? T(-1) : T(1);
  for (int i = 0; i < 3; ++i) {
    u[3 * i] = u0[i];
    u[3 * i + 1] = rb.u1[i];
    u[3 * i + 2] = mul(u2[i], rb.sign);
  }
}

template <typename T>
__device__ __forceinline__ void load_identity(T* V) {
  for (int i = 0; i < 9; ++i) V[i] = (i % 4 == 0) ? T(1) : T(0);
}

// svd3x3 of one matrix f: U, S, V.
template <typename T>
__device__ void jacobi_lane(const T* f, T* u, T* s, T* v, int n_sweeps) {
  T A[9], V[9];
  for (int i = 0; i < 9; ++i) A[i] = f[i];
  load_identity(V);
  sweeps<T>(A, V, n_sweeps, nullptr);
  Rebuild<T> rb;
  rebuild(A, V, u, s, v, rb);
}

// grad_x of y = x / max(|x|, eps) where |x| > eps (x's norm n): g / n minus
// x (g . x) / n^3, in the order autograd takes it: the quotient's two
// gradients, the clamp, then vector_norm's x (grad / n).
__device__ __forceinline__ void normalise_bwd(const double* x, double n,
                                              const double* g, double* gx) {
  const double gn = -(g[0] * x[0] + g[1] * x[1] + g[2] * x[2]) / (n * n);
  for (int i = 0; i < 3; ++i) gx[i] = g[i] / n + x[i] * (gn / n);
}

template <typename T>
__device__ __forceinline__ void widen(const T* x, double* w) {
  for (int i = 0; i < 3; ++i) w[i] = (double)x[i];
}

// grad F of one matrix f from the gradients of U, S, V (null: none). The
// forward is recomputed in T, so the derivative is taken at the forward's
// own values; the reverse pass runs in float64 whatever T is.
template <typename T>
__device__ void jacobi_lane_bwd(const T* f, const T* gu, const T* gs, const T* gv,
                                T* gf, int n_sweeps) {
  Rotation<T> tape[3 * kMaxSweeps];
  T A[9], V[9];
  for (int i = 0; i < 9; ++i) A[i] = f[i];
  load_identity(V);
  sweeps<T>(A, V, n_sweeps, tape);
  Rebuild<T> rb;
  T u[9], s[3], v[9];
  rebuild(A, V, u, s, v, rb);
  double u0[3], u1[3], a0[3], a1[3];
  widen(rb.u0, u0);
  widen(rb.u1, u1);
  widen(rb.a[0], a0);
  widen(rb.a[1], a1);

  // U's columns.
  double g0[3] = {0, 0, 0}, g1[3] = {0, 0, 0};
  if (gu != nullptr) {
    double g2[3];
    for (int i = 0; i < 3; ++i) {
      g0[i] = gu[3 * i];
      g1[i] = gu[3 * i + 1];
      g2[i] = (double)gu[3 * i + 2] * rb.sign;   // the sign takes no gradient
    }
    // u2 = u0 x u1: grad u0 = u1 x g2, grad u1 = g2 x u0.
    double t0[3], t1[3];
    cross(u1, g2, t0);
    cross(g2, u0, t1);
    for (int i = 0; i < 3; ++i) {
      g0[i] += t0[i];
      g1[i] += t1[i];
    }
  }
  // u1: the orthogonalised column's or the fallback's normalisation.
  double gu1o[3] = {0, 0, 0};
  if (rb.sel1) {
    double u1o[3];
    widen(rb.u1o, u1o);
    normalise_bwd(u1o, rb.u1n, g1, gu1o);
  } else {
    double fb[3], gfb[3];
    widen(rb.fb, fb);
    normalise_bwd(fb, rb.fbn, g1, gfb);
    if (rb.sel_a) {          // (-u0_1, u0_0, 0)
      g0[1] -= gfb[0];
      g0[0] += gfb[1];
    } else {                 // (0, -u0_2, u0_1)
      g0[2] -= gfb[1];
      g0[1] += gfb[2];
    }
  }
  // u1o = a1 - (u0 . a1) u0.
  double ga[3][3] = {};
  const double gproj = -(gu1o[0] * u0[0] + gu1o[1] * u0[1] + gu1o[2] * u0[2]);
  for (int i = 0; i < 3; ++i) {
    ga[1][i] = gu1o[i] + gproj * u0[i];
    g0[i] += -(double)rb.proj * gu1o[i] + gproj * a1[i];
  }
  // u0: a0's normalisation, or the constant e0.
  if (rb.sel0) normalise_bwd(a0, rb.u0n, g0, ga[0]);

  // Undo the sort: sorted column j was column order[j].
  double gA[9], gV[9];
  for (int j = 0; j < 3; ++j) {
    const int o = rb.order[j];
    for (int i = 0; i < 3; ++i) {
      gA[3 * i + o] = ga[j][i];
      gV[3 * i + o] = gv != nullptr ? (double)gv[3 * i + j] : 0.0;
    }
  }
  // S_j = sqrt(clamp(sum_i A_ij^2, 0)): grad / (2 S) where the sum is >= 0.
  if (gs != nullptr) {
    for (int j = 0; j < 3; ++j) {
      const int o = rb.order[j];
      const double S = rb.S[o];
      if (!isnan_(S)) {
        const double g = gs[j] / (2.0 * S);
        for (int i = 0; i < 3; ++i) gA[3 * i + o] += 2.0 * g * A[3 * i + o];
      }
    }
  }

  // The rotations, last first.
  for (int k = 3 * n_sweeps - 1; k >= 0; --k) {
    const Rotation<T>& rec = tape[k];
    const int p = col_p(k % 3), q = col_q(k % 3);
    const double c = rec.c, sn = rec.s;
    double gc = 0, gsn = 0;
    for (int i = 0; i < 3; ++i) {
      const double gap = gA[3 * i + p], gaq = gA[3 * i + q];
      const double gvp = gV[3 * i + p], gvq = gV[3 * i + q];
      const double ap = rec.ap[i], aq = rec.aq[i], vp = rec.vp[i], vq = rec.vq[i];
      gc += gap * ap + gaq * aq + gvp * vp + gvq * vq;
      gsn += gap * aq - gaq * ap + gvp * vq - gvq * vp;
      gA[3 * i + p] = c * gap - sn * gaq;
      gA[3 * i + q] = sn * gap + c * gaq;
      gV[3 * i + p] = c * gvp - sn * gvq;
      gV[3 * i + q] = sn * gvp + c * gvq;
    }
    if (rec.num == T(0) && rec.den == T(0)) continue;   // the degenerate branch
    // theta = 0.5 atan2(num, den); c = cos theta, s = sin theta.
    const double num = rec.num, den = rec.den;
    const double gatan = 0.5 * (c * gsn - sn * gc);
    const double recip = 1.0 / (num * num + den * den);
    const double gnum = gatan * den * recip;
    const double gden = gatan * -num * recip;
    // num = 2 a_pq, den = a_pp - a_qq, with the columns before the rotation.
    for (int i = 0; i < 3; ++i) {
      const double ap = rec.ap[i], aq = rec.aq[i];
      gA[3 * i + p] += 2.0 * gden * ap + 2.0 * gnum * aq;
      gA[3 * i + q] += -2.0 * gden * aq + 2.0 * gnum * ap;
    }
  }
  for (int i = 0; i < 9; ++i) gf[i] = (T)gA[i];
}

}  // namespace

template <typename T>
__global__ void __launch_bounds__(kThreads)
svd3_jacobi(const T* __restrict__ f, T* __restrict__ u, T* __restrict__ s,
            T* __restrict__ v, int n, int n_sweeps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  jacobi_lane(f + 9 * (size_t)i, u + 9 * (size_t)i, s + 3 * (size_t)i,
              v + 9 * (size_t)i, n_sweeps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
svd3_jacobi_bwd(const T* __restrict__ f, const T* __restrict__ gu,
                const T* __restrict__ gs, const T* __restrict__ gv,
                T* __restrict__ gf, int n, int n_sweeps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t m = 9 * (size_t)i;
  jacobi_lane_bwd(f + m, gu == nullptr ? nullptr : gu + m,
                  gs == nullptr ? nullptr : gs + 3 * (size_t)i,
                  gv == nullptr ? nullptr : gv + m, gf + m, n_sweeps);
}

// f, u, v: (n, 3, 3), s: (n, 3), contiguous, float32 or (is_double) float64
// on the current device, 1 <= n, 0 <= n_sweeps <= kMaxSweeps. One launch on
// `stream`; returns cudaGetLastError().
extern "C" int hp3d_svd3_jacobi(const void* f, void* u, void* s, void* v, int n,
                                int n_sweeps, int is_double, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (is_double) {
    svd3_jacobi<double><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)f, (double*)u, (double*)s, (double*)v, n, n_sweeps);
  } else {
    svd3_jacobi<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)f, (float*)u, (float*)s, (float*)v, n, n_sweeps);
  }
  return (int)cudaGetLastError();
}

// grad f from the gradients of U, S, V (any may be null: none), all of the
// shapes and type above; gf written. One launch on `stream`; returns
// cudaGetLastError().
extern "C" int hp3d_svd3_jacobi_bwd(const void* f, const void* gu, const void* gs,
                                    const void* gv, void* gf, int n, int n_sweeps,
                                    int is_double, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (is_double) {
    svd3_jacobi_bwd<double><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)f, (const double*)gu, (const double*)gs, (const double*)gv,
        (double*)gf, n, n_sweeps);
  } else {
    svd3_jacobi_bwd<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)f, (const float*)gu, (const float*)gs, (const float*)gv,
        (float*)gf, n, n_sweeps);
  }
  return (int)cudaGetLastError();
}
