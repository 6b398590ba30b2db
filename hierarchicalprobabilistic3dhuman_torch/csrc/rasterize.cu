// Z-buffered barycentric attribute rasterizer for Hopper (sm_90a).
//
// Replaces hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer_pallas.py::
// _raster_kernel (:240-345). It computes the same function by another
// algorithm: not the TPU's loop over (pixel tile, face chunk) pairs, but a
// scatter over faces into a 64-bit key buffer and a resolve pass over pixels.
//
// Tables read (pack_faces below, or ops/rasterizer_cuda.py::
// pack_face_tables_plain):
//   geom  (B, 16, Fp) f32  rows [wa0 wb0 wc0 wa1 wb1 wc1 za zb zc 0...]
//   fattr (B, Fp, 3A) f32  [attr_v0 | attr_v1 | attr_v2]
//   boxes (B, Fp, 4) i32   per face [rmin rmax cmin cmax] of pixel indices,
//                          inclusive; every pixel the face can cover
// Written: attrs (B, H, W, A), depth (B, H, W) (+inf where empty), mask
// (B, H, W) (1 byte, torch.bool); zkey (B, H, W) u64 is scratch.
//
// The function. For a pixel centre (c + 0.5, r + 0.5) and a face: w0, w1
// from the barycentric-ratio rows, w2 = 1 - w0 - w1, z from the depth plane.
// The face covers the pixel iff w0, w1, w2 >= 0 and z > znear (and z < 1e30,
// the plain version's "empty" depth); the nearest covering face wins, ties
// to the lowest face index.
//
// The design. One launch of pack_faces (at the end of this file) packs the
// tables, each face's box among them. A rasterizer call is then three
// launches on one stream:
//   1. cudaMemsetAsync sets every key to all ones ("empty").
//   2. raster_faces. A covered (pixel, face) pair makes the key
//      (bits of z) << 32 | face and takes atomicMin on the pixel's key. z is
//      finite and > znear > 0, so its bits order as an unsigned integer, and
//      the unsigned minimum is "nearest z, then lowest face". The minimum is
//      commutative: faces may arrive in any order from any block, and two
//      runs give identical bits. The atomic's result is unused, so it is a
//      fire-and-forget reduction that the L2 resolves. A block takes 32
//      faces. Its first warp classifies them, one lane a face: it clips the
//      box and either lists the face as small (at most kSmallBox pixels) or
//      cuts its box into row strips of about kStripPixels pixels, queued in
//      shared memory. Then 8 lanes take each small face, and the block's 8
//      warps share the strips, 32 lanes a strip, so one large face does not
//      hold a warp while seven idle. The grid's z axis cuts the image into
//      bands of at most 65,536 pixels and a block tests its faces inside
//      its band only, so a face whose box is the whole of a 512^2 image is
//      shared by four blocks. The pixel loop is carried by two floats and
//      one pixel index, with no multiply on the covered branch.
//   3. resolve. One thread per (pixel, 4 attributes) (per attribute when
//      A % 4 != 0) decodes depth and face from the key, evaluates w0, w1, w2
//      again and interpolates. Consecutive threads write consecutive 16 (or
//      4) bytes, with streaming stores: the outputs are not read again here.
//
// What bounds it on an H100: bytes. At the predict shape (6 meshes x 512^2,
// A = 12) the function reads 15 MB of tables and writes 83 MB of outputs,
// 0.029 ms at 3.35 TB/s, against 0.008 ms for the float32 operations of the
// pixel-face tests it needs. The 12.6 MB of keys (37.7 MB at 72 x 256^2)
// stay in the 50 MB L2, so the key traffic adds no HBM bytes. What the
// kernel actually spends its time on is executing the tests (measured with
// the atomics switched off, the scatter pass is about 10% shorter; PERF.md).
//
// Tensor cores are not used. A plane evaluation is a K = 3 product, but the
// contract is float32 with a fixed rounding order; TF32 (10-bit mantissa)
// would move coverage at triangle edges.
//
// The rounding rule. nvcc would contract a*b + c into an FMA and move
// coverage at triangle edges. Every plane evaluation and the interpolation
// use __fmul_rn / __fadd_rn / __fsub_rn in the association order of the
// plain version (ops/rasterizer.py): ((px*wa + py*wb) + wc), (1 - w0) - w1
// and (w0*a0 + w1*a1) + w2*a2, so mask and depth equal the plain version's
// bit for bit; the build keeps nvcc's default --fmad=true.

#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef unsigned long long u64;

constexpr int kGeomRows = 16;
constexpr float kInf = 1e30f;
constexpr u64 kEmpty = ~0ull;
constexpr int kThreads = 256;
constexpr int kBlockFaces = 32;     // faces per block, one lane each to classify
constexpr int kFaceLanes = 8;       // lanes that test one small face
constexpr int kSmallBox = 128;      // pixels of a box that counts as small
constexpr int kStripPixels = 512;   // pixels of a row strip, one warp's item
constexpr int kMaxStrips = 16;      // strips per face and band
constexpr int kBandPixels = 65536;  // pixels of a band of image rows
constexpr int kChunk = 128;         // faces of a chunk (FACE_CHUNK)

struct Planes {
  float a0, b0, c0, a1, b1, c1, za, zb, zc;
};

__device__ __forceinline__ float plane(float px, float py, float a, float b,
                                       float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

__device__ __forceinline__ Planes load_planes(const float* __restrict__ g,
                                              int Fp, int f) {
  Planes p;
  p.a0 = __ldg(g + f);
  p.b0 = __ldg(g + (size_t)Fp + f);
  p.c0 = __ldg(g + (size_t)2 * Fp + f);
  p.a1 = __ldg(g + (size_t)3 * Fp + f);
  p.b1 = __ldg(g + (size_t)4 * Fp + f);
  p.c1 = __ldg(g + (size_t)5 * Fp + f);
  p.za = __ldg(g + (size_t)6 * Fp + f);
  p.zb = __ldg(g + (size_t)7 * Fp + f);
  p.zc = __ldg(g + (size_t)8 * Fp + f);
  return p;
}

// LANES threads (this one is `lane`) test `face` at the pixel centres of
// rows r0..r1, columns c0..c1 of the image whose keys start at zk. The
// lanes walk the box in row-major order, LANES pixels a step.
template <int LANES>
__device__ __forceinline__ void raster_box(const Planes& p, unsigned face,
                                           int r0, int r1, int c0, int c1,
                                           int lane, u64* __restrict__ zk,
                                           int W, float znear) {
  const int bw = c1 - c0 + 1;
  const int dr = LANES / bw, dc = LANES % bw;
  const int lr = lane / bw, lc = lane - lr * bw;
  // Pixel centres are k + 0.5 with small k: these float sums are exact.
  float px = (float)(c0 + lc) + 0.5f, py = (float)(r0 + lr) + 0.5f;
  int idx = (r0 + lr) * W + c0 + lc;
  const float dpx = (float)dc, dpy = (float)dr, fbw = (float)bw;
  const float px_end = (float)c1 + 1.0f, py_end = (float)r1 + 1.0f;
  const int didx = dr * W + dc, wrap = W - bw;
  while (py < py_end) {
    const float w0 = plane(px, py, p.a0, p.b0, p.c0);
    const float w1 = plane(px, py, p.a1, p.b1, p.c1);
    const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
    const float z = plane(px, py, p.za, p.zb, p.zc);
    if ((w0 >= 0.0f) & (w1 >= 0.0f) & (w2 >= 0.0f) & (z > znear) & (z < kInf)) {
      atomicMin(zk + idx, ((u64)__float_as_uint(z) << 32) | face);
    }
    px += dpx; py += dpy; idx += didx;
    if (px > px_end) { px -= fbw; py += 1.0f; idx += wrap; }
  }
}

// The face's box cut to the image and to this block's band of rows.
__device__ __forceinline__ bool clip_box(int4 box, int H, int W, int band_rows,
                                         int& r0, int& r1, int& c0, int& c1) {
  const int lo = blockIdx.z * band_rows;
  r0 = max(box.x, lo); r1 = min(box.y, min(H, lo + band_rows) - 1);
  c0 = max(box.z, 0); c1 = min(box.w, W - 1);
  return r0 <= r1 && c0 <= c1;
}

// Grid (ceil(Fp / 32), B, bands of rows). Held to 40 registers, 6 blocks an
// SM: measured faster than the 46 registers and 5 blocks nvcc takes unasked.
__global__ void __launch_bounds__(kThreads, 6)
raster_faces(const float* __restrict__ geom, const int4* __restrict__ boxes,
             u64* __restrict__ zkey, int H, int W, int Fp, int band_rows,
             float znear) {
  __shared__ int s_small_count, s_strip_count;
  __shared__ int s_small[kBlockFaces];                  // small faces, local ids
  __shared__ int4 s_box[kBlockFaces];                   // clipped r0, r1, c0, c1
  __shared__ int4 s_strips[kBlockFaces * kMaxStrips];   // local face, r0, r1, -
  const int b = blockIdx.y;
  const float* g = geom + (size_t)b * kGeomRows * Fp;
  u64* zk = zkey + (size_t)b * H * W;
  // Opaque to the compiler, which otherwise recomputes this base at every
  // covered pixel.
  asm volatile("" : "+l"(zk));
  const int f0 = blockIdx.x * kBlockFaces;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    int r0 = 0, r1 = -1, c0 = 0, c1 = -1;
    const bool valid = f0 + lane < Fp &&
        clip_box(__ldg(boxes + (size_t)b * Fp + f0 + lane), H, W, band_rows,
                 r0, r1, c0, c1);
    s_box[lane] = make_int4(r0, r1, c0, c1);
    const int bw = c1 - c0 + 1, bh = r1 - r0 + 1;
    const bool small = valid && bw * bh <= kSmallBox;
    const unsigned small_mask = __ballot_sync(0xffffffffu, small);
    if (small) s_small[__popc(small_mask & ((1u << lane) - 1u))] = lane;
    int rows = 1, n = 0;
    if (valid && !small) {
      rows = max(max(1, kStripPixels / bw), (bh + kMaxStrips - 1) / kMaxStrips);
      n = (bh + rows - 1) / rows;
    }
    int end = n;                    // inclusive prefix sum of the strip counts
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, end, d);
      if (lane >= d) end += up;
    }
    for (int i = 0; i < n; ++i) {
      s_strips[end - n + i] = make_int4(lane, r0 + i * rows,
                                        min(r1, r0 + (i + 1) * rows - 1), 0);
    }
    if (lane == 31) { s_strip_count = end; s_small_count = __popc(small_mask); }
  }
  __syncthreads();
  const int group = threadIdx.x / kFaceLanes;           // 32 groups of 8 lanes
  if (group < s_small_count) {
    const int fl = s_small[group];
    const int4 box = s_box[fl];
    raster_box<kFaceLanes>(load_planes(g, Fp, f0 + fl), (unsigned)(f0 + fl),
                           box.x, box.y, box.z, box.w,
                           threadIdx.x % kFaceLanes, zk, W, znear);
  }
  const int count = s_strip_count;
  for (int i = warp; i < count; i += kThreads / 32) {
    const int4 strip = s_strips[i];
    const int4 box = s_box[strip.x];
    raster_box<32>(load_planes(g, Fp, f0 + strip.x), (unsigned)(f0 + strip.x),
                   strip.y, strip.z, box.z, box.w, lane, zk, W, znear);
  }
}

__device__ __forceinline__ float interpolate(float w0, float w1, float w2,
                                             float a0, float a1, float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a0), __fmul_rn(w1, a1)),
                   __fmul_rn(w2, a2));
}

// One thread per (pixel, VEC attributes); grid (ceil(W * A / VEC / 256), H, B).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
resolve(const u64* __restrict__ zkey, const float* __restrict__ geom,
        const float* __restrict__ fattr, float* __restrict__ out_attrs,
        float* __restrict__ out_depth, unsigned char* __restrict__ out_mask,
        int H, int W, int Fp, int A) {
  const int Q = A / VEC;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= W * Q) return;
  const int c = t / Q, q = t - c * Q;
  const int r = blockIdx.y, b = blockIdx.z;
  const size_t pix = ((size_t)b * H + r) * W + c;
  const u64 key = __ldcs(zkey + pix);
  float* out = out_attrs + pix * A + q * VEC;
  if (key == kEmpty) {
    if (VEC == 4) {
      __stcs(reinterpret_cast<float4*>(out), make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    } else {
      __stcs(out, 0.0f);
    }
    if (q == 0) { out_depth[pix] = INFINITY; out_mask[pix] = 0; }
    return;
  }
  const unsigned face = (unsigned)key;
  const Planes p = load_planes(geom + (size_t)b * kGeomRows * Fp, Fp, face);
  const float px = (float)c + 0.5f, py = (float)r + 0.5f;
  const float w0 = plane(px, py, p.a0, p.b0, p.c0);
  const float w1 = plane(px, py, p.a1, p.b1, p.c1);
  const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
  const float* fa = fattr + ((size_t)b * Fp + face) * 3 * A + q * VEC;
  if (VEC == 4) {
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(fa));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(fa + A));
    const float4 a2 = __ldg(reinterpret_cast<const float4*>(fa + 2 * A));
    __stcs(reinterpret_cast<float4*>(out),
           make_float4(interpolate(w0, w1, w2, a0.x, a1.x, a2.x),
                       interpolate(w0, w1, w2, a0.y, a1.y, a2.y),
                       interpolate(w0, w1, w2, a0.z, a1.z, a2.z),
                       interpolate(w0, w1, w2, a0.w, a1.w, a2.w)));
  } else {
    __stcs(out, interpolate(w0, w1, w2, __ldg(fa), __ldg(fa + A),
                            __ldg(fa + 2 * A)));
  }
  if (q == 0) {
    out_depth[pix] = __uint_as_float((unsigned)(key >> 32));
    out_mask[pix] = 1;
  }
}

// ---------------------------------------------------------------------------
// pack_faces: the four face tables of ops/rasterizer_cuda.py::
// pack_face_tables in one launch. It stands for the JAX package's
// hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer_pallas.py::
// pack_face_tables (:97, jnp ops that XLA fuses; the TPU has no Pallas kernel
// for it), and adds the per-face boxes that raster_faces reads.
//
// Read: verts (B, V, 3) f32 [x_pix y_pix z], faces (F, 3) i64 (indices in
// [0, V); the kernel traps on any other, as torch's gather asserts), vattr
// (B, V, A) f32. Written, as pack_face_tables_plain lays them out:
//   geom   (B, 16, Fp) f32  rows [wa0 wb0 wc0 wa1 wb1 wc1 za zb zc 0 x 7]
//   fattr  (B, Fp, 3A) f32  [attr_v0 | attr_v1 | attr_v2]
//   ranges (B, Fp/128, 4) i32  per chunk of 128 faces [rmin rmax cmin cmax]
//   boxes  (B, Fp, 4) i32   per face, as above, of pixel indices
// Faces F..Fp-1 (the padding to a multiple of 128) are read as [0, 0, 0].
//
// The design. Grid (Fp / 128, B); a block of 128 threads is one chunk.
//   1. Geometry: one thread a face gathers its three vertices (they stay in
//      L2: a mesh's 94 KB of vertices is read by its 108 chunks), computes
//      the planes, the depth plane and the box, and writes its 16 geom rows
//      (row r of a warp's 32 faces is one 128 B store) and its box as one
//      int4. Its indices go to shared memory for step 3.
//   2. Chunk ranges: the block's min / max of the faces' extents, by warp
//      shuffles and then the 4 warps' partials through shared memory; one
//      thread rounds, clamps and stores them.
//   3. Attributes: the chunk's 128 x 3A output floats are one contiguous
//      span; consecutive threads write consecutive floats (float4s where A
//      % 4 == 0 and the attributes are 16-byte aligned), each gathering its
//      value from vattr. One thread a face would write at a 12A-byte stride.
//
// What bounds it on an H100: bytes. At the predict shape (6 meshes, Fp =
// 13,824, A = 12) it writes 18.6 MB of tables (64 B of geometry, 144 B of
// attributes and 16 B of box a face) and reads 0.9 MB, 0.006 ms at 3.35 TB/s;
// its ~160 float32 operations a face take 0.0002 ms at 67 TFLOP/s.
//
// The rounding rule. The tables must equal, bit for bit, those of the torch
// ops of pack_face_tables_plain on the card, on which K1's outputs and every
// check of the port were measured. Each torch op rounds on its own: every
// product, sum and difference here is __fmul_rn / __fadd_rn / __fsub_rn in
// the plain version's order, and 1.0 / t (torch: reciprocal(t) * 1.0) is
// __frcp_rn. Degenerate faces are not cut short: torch computes za and zb
// from their zeroed rows too, and 0 * inf there is NaN as it is in torch.
// torch.amin, amax and maximum hand a NaN on; fminf and fmaxf would drop it.

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// The box rule is face_boxes_plain's (its docstring derives it: the vertices'
// bounding box grown by a bound on the rounding error of the face's planes).
// 6 (|a| W + |b| H) + 1.5 (|q| + |r|) + 5 |q - r| for the edge from vertex
// i to vertex j: a = y_i - y_j, b = x_j - x_i, q = x_i y_j, r = y_i x_j.
__device__ __forceinline__ float plane_error(float xi, float yi, float xj,
                                             float yj, float fW, float fH) {
  const float a = __fsub_rn(yi, yj), b = __fsub_rn(xj, xi);
  const float q = __fmul_rn(xi, yj), r = __fmul_rn(yi, xj);
  const float s = __fadd_rn(fabsf(q), fabsf(r));
  const float ab = __fadd_rn(__fmul_rn(fabsf(a), fW), __fmul_rn(fabsf(b), fH));
  return __fadd_rn(__fadd_rn(__fmul_rn(6.0f, ab), __fmul_rn(1.5f, s)),
                   __fmul_rn(5.0f, fabsf(__fsub_rn(q, r))));
}

// First and last pixel index along one axis of n pixels, from the axis's
// lowest and highest vertex coordinate.
__device__ __forceinline__ void axis_box(float lo, float hi, float E,
                                         bool degenerate, int n, int& first,
                                         int& last) {
  const float u8 = 4.76837158203125e-07f;              // 8 x 2^-24
  const float margin = __fadd_rn(
      __fmul_rn(__fmul_rn(2.0f, E), __fsub_rn(hi, lo)),
      __fmul_rn(u8, nan_max(fabsf(lo), fabsf(hi))));
  float f = ceilf(__fsub_rn(__fsub_rn(lo, margin), 0.5f));
  float l = floorf(__fsub_rn(__fadd_rn(hi, margin), 0.5f));
  if (f != f) f = 0.0f;                  // the whole axis where not finite
  if (l != l) l = (float)n;
  first = degenerate ? 0 : (int)fminf(fmaxf(f, 0.0f), (float)n);
  last = degenerate ? -1 : (int)fminf(fmaxf(l, -1.0f), (float)(n - 1));
}

// A chunk range's end: torch.clamp(v, -1e9, 1e9) keeps a NaN, and the cast
// to int32 is cvt.rzi.s32.f32 (a NaN gives 0).
__device__ __forceinline__ int range_end(float v) {
  return __float2int_rz(v != v ? v : fminf(fmaxf(v, -1e9f), 1e9f));
}

__device__ __forceinline__ int vertex_index(const long long* __restrict__ faces,
                                            int f, int k, int F, int V) {
  if (f >= F) return 0;
  const long long i = __ldg(faces + (size_t)f * 3 + k);
  if ((unsigned long long)i >= (unsigned long long)V) __trap();
  return (int)i;
}

// Grid (Fp / kChunk, B), kChunk threads; VEC floats a store in step 3.
template <int VEC>
__global__ void __launch_bounds__(kChunk)
pack_faces(const float* __restrict__ verts, const long long* __restrict__ faces,
           const float* __restrict__ vattr, float* __restrict__ geom,
           float* __restrict__ fattr, int4* __restrict__ ranges,
           int4* __restrict__ boxes, int V, int F, int Fp, int A, int H, int W) {
  __shared__ int s_idx[3 * kChunk];
  __shared__ float s_part[4][kChunk / 32];
  const int t = threadIdx.x, b = blockIdx.y;
  const int f = blockIdx.x * kChunk + t;

  // 1. Geometry, one thread a face.
  const float* vb = verts + (size_t)b * V * 3;
  float x[3], y[3], z[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = vertex_index(faces, f, k, F, V);
    s_idx[3 * t + k] = i;
    x[k] = __ldg(vb + (size_t)i * 3);
    y[k] = __ldg(vb + (size_t)i * 3 + 1);
    z[k] = __ldg(vb + (size_t)i * 3 + 2);
  }
  const float a0 = __fsub_rn(y[1], y[2]), b0 = __fsub_rn(x[2], x[1]);
  const float c0 = __fsub_rn(__fmul_rn(x[1], y[2]), __fmul_rn(y[1], x[2]));
  const float a1 = __fsub_rn(y[2], y[0]), b1 = __fsub_rn(x[0], x[2]);
  const float c1 = __fsub_rn(__fmul_rn(x[2], y[0]), __fmul_rn(y[2], x[0]));
  const float p1 = __fmul_rn(__fsub_rn(x[1], x[0]), __fsub_rn(y[2], y[0]));
  const float p2 = __fmul_rn(__fsub_rn(y[1], y[0]), __fsub_rn(x[2], x[0]));
  const float denom = __fsub_rn(p1, p2);
  const bool degenerate = fabsf(denom) <= 1e-9f;
  const float inv = __frcp_rn(degenerate ? 1.0f : denom);
  const float wa0 = degenerate ? 0.0f : __fmul_rn(a0, inv);
  const float wb0 = degenerate ? 0.0f : __fmul_rn(b0, inv);
  const float wc0 = degenerate ? -1.0f : __fmul_rn(c0, inv);
  const float wa1 = degenerate ? 0.0f : __fmul_rn(a1, inv);
  const float wb1 = degenerate ? 0.0f : __fmul_rn(b1, inv);
  const float wc1 = degenerate ? 0.0f : __fmul_rn(c1, inv);
  const float dz0 = __fsub_rn(z[0], z[2]), dz1 = __fsub_rn(z[1], z[2]);
  const float rows[9] = {
      wa0, wb0, wc0, wa1, wb1, wc1,
      __fadd_rn(__fmul_rn(wa0, dz0), __fmul_rn(wa1, dz1)),
      __fadd_rn(__fmul_rn(wb0, dz0), __fmul_rn(wb1, dz1)),
      degenerate ? 0.0f
                 : __fadd_rn(__fadd_rn(z[2], __fmul_rn(wc0, dz0)),
                             __fmul_rn(wc1, dz1))};
  float* g = geom + (size_t)b * kGeomRows * Fp + f;
#pragma unroll
  for (int r = 0; r < kGeomRows; ++r) g[(size_t)r * Fp] = r < 9 ? rows[r] : 0.0f;

  // The box (face_boxes_plain). torch evaluates u / |denom| as
  // reciprocal(|denom|) * u.
  const float u = 5.9604644775390625e-08f;             // 2^-24
  const float scale = __fmul_rn(__frcp_rn(fabsf(denom)), u);
  const float rho = __fmul_rn(__fmul_rn(8.0f, scale),
                              __fadd_rn(fabsf(p1), fabsf(p2)));
  const float planes = __fadd_rn(
      plane_error(x[1], y[1], x[2], y[2], (float)W, (float)H),
      plane_error(x[2], y[2], x[0], y[0], (float)W, (float)H));
  float E = __fdiv_rn(
      __fmul_rn(2.0f, __fadd_rn(__fadd_rn(rho, __fmul_rn(scale, planes)),
                                __fmul_rn(4.0f, u))),
      __fsub_rn(1.0f, rho));
  if (!(isfinite(E) && rho < 0.5f)) E = INFINITY;
  const float ylo = nan_min(nan_min(y[0], y[1]), y[2]);
  const float yhi = nan_max(nan_max(y[0], y[1]), y[2]);
  const float xlo = nan_min(nan_min(x[0], x[1]), x[2]);
  const float xhi = nan_max(nan_max(x[0], x[1]), x[2]);
  int4 box;
  axis_box(ylo, yhi, E, degenerate, H, box.x, box.y);
  axis_box(xlo, xhi, E, degenerate, W, box.z, box.w);
  boxes[(size_t)b * Fp + f] = box;

  // 2. The chunk's range: degenerate faces (padding among them) take no
  // part, as +1e9 minima and -1e9 maxima.
  float ext[4] = {degenerate ? 1e9f : ylo, degenerate ? -1e9f : yhi,
                  degenerate ? 1e9f : xlo, degenerate ? -1e9f : xhi};
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float o = __shfl_xor_sync(0xffffffffu, ext[e], d);
      ext[e] = (e % 2 == 0) ? nan_min(ext[e], o) : nan_max(ext[e], o);
    }
  }
  if ((t & 31) == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s_part[e][t >> 5] = ext[e];
  }
  __syncthreads();                       // s_part and s_idx are complete
  if (t == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      for (int w = 1; w < kChunk / 32; ++w) {
        ext[e] = (e % 2 == 0) ? nan_min(ext[e], s_part[e][w])
                              : nan_max(ext[e], s_part[e][w]);
      }
    }
    ranges[(size_t)b * gridDim.x + blockIdx.x] = make_int4(
        range_end(floorf(ext[0])), range_end(ceilf(ext[1])),
        range_end(floorf(ext[2])), range_end(ceilf(ext[3])));
  }

  // 3. Attributes: the chunk's span of 128 x 3A floats, VEC at a time.
  const int row = 3 * A;
  const float* ab = vattr + (size_t)b * V * A;
  float* out = fattr + ((size_t)b * Fp + (size_t)blockIdx.x * kChunk) * row;
  for (int q = t; q < kChunk * row / VEC; q += kChunk) {
    const int o = q * VEC;
    const int fl = o / row, k = (o - fl * row) / A;
    const float* src = ab + (size_t)s_idx[3 * fl + k] * A + (o - fl * row - k * A);
    if (VEC == 4) {
      reinterpret_cast<float4*>(out)[q] = __ldg(reinterpret_cast<const float4*>(src));
    } else {
      out[q] = __ldg(src);
    }
  }
}

}  // namespace

// One launch on `stream` (PyTorch's current stream): the four face tables of
// B meshes of V vertices, F faces and A attributes, padded to Fp faces.
// Returns the CUDA error, 0 if none.
extern "C" int hp3d_pack_faces(const void* verts, const void* faces,
                               const void* vattr, void* geom, void* fattr,
                               void* ranges, void* boxes, int B, int V, int F,
                               int Fp, int A, int H, int W, void* stream) {
  const dim3 grid(Fp / kChunk, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (A % 4 == 0 && (size_t)vattr % 16 == 0) {
    pack_faces<4><<<grid, kChunk, 0, st>>>(
        (const float*)verts, (const long long*)faces, (const float*)vattr,
        (float*)geom, (float*)fattr, (int4*)ranges, (int4*)boxes, V, F, Fp, A,
        H, W);
  } else {
    pack_faces<1><<<grid, kChunk, 0, st>>>(
        (const float*)verts, (const long long*)faces, (const float*)vattr,
        (float*)geom, (float*)fattr, (int4*)ranges, (int4*)boxes, V, F, Fp, A,
        H, W);
  }
  return (int)cudaGetLastError();
}

// Three launches on `stream` (PyTorch's current stream): the keys' memset,
// raster_faces, resolve. Returns the first CUDA error, 0 if none.
extern "C" int hp3d_rasterize(const void* geom, const void* fattr,
                              const void* boxes, void* zkey, void* out_attrs,
                              void* out_depth, void* out_mask, int B, int H,
                              int W, int Fp, int A, float znear, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(zkey, 0xFF, (size_t)B * H * W * sizeof(u64), st);
  if (err != cudaSuccess) return (int)err;
  const int band_rows = min(H, max(1, kBandPixels / W));
  const dim3 faces_grid((Fp + kBlockFaces - 1) / kBlockFaces, B,
                        (H + band_rows - 1) / band_rows);
  raster_faces<<<faces_grid, kThreads, 0, st>>>(
      (const float*)geom, (const int4*)boxes, (u64*)zkey, H, W, Fp, band_rows,
      znear);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec = (A % 4 == 0) ? 4 : 1;
  const dim3 pixels_grid((W * (A / vec) + kThreads - 1) / kThreads, H, B);
  if (vec == 4) {
    resolve<4><<<pixels_grid, kThreads, 0, st>>>(
        (const u64*)zkey, (const float*)geom, (const float*)fattr,
        (float*)out_attrs, (float*)out_depth, (unsigned char*)out_mask, H, W,
        Fp, A);
  } else {
    resolve<1><<<pixels_grid, kThreads, 0, st>>>(
        (const u64*)zkey, (const float*)geom, (const float*)fattr,
        (float*)out_attrs, (float*)out_depth, (unsigned char*)out_mask, H, W,
        Fp, A);
  }
  return (int)cudaGetLastError();
}
