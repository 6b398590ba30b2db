// Z-buffered barycentric attribute rasterizer for Hopper (sm_90a).
//
// Replaces hierarchicalprobabilistic3dhuman_tpu/ops/rasterizer_pallas.py::
// _raster_kernel (:240-345). Reads the packed tables of
// ops/rasterizer_cuda.py::pack_face_tables:
//   geom   (B, 16, Fp) f32  rows [wa0 wb0 wc0 wa1 wb1 wc1 za zb zc 0...]
//   fattr  (B, Fp, 3A) f32  [attr_v0 | attr_v1 | attr_v2]
//   ranges (B, NC, 4) i32   per 128-face chunk [rmin rmax cmin cmax], inclusive
// and writes attrs (B, H, W, A), depth (B, H, W) (+inf where empty) and
// mask (B, H, W) (1 byte, torch.bool).
//
// For each pixel centre (c + 0.5, r + 0.5) and face: w0, w1 from the
// barycentric-ratio rows, w2 = 1 - w0 - w1, z from the depth plane. The face
// covers the pixel iff w0, w1, w2 >= 0 and z > znear; the nearest covering
// face wins, ties to the lowest face index.
//
// What bounds it on an H100: at the predict shape (6 meshes x 512^2, A=12)
// it must write 6*512^2*(12*4 + 4 + 1) B ~ 83 MB and read ~17 MB of tables,
// ~30 us at 3.35 TB/s. The pair work is larger: only (16x16 tile, 128-face
// chunk) pairs whose boxes overlap are evaluated, 19 float32 operations per
// (pixel, face) pair; the predict scene of chip_smoke.py has ~20k such pairs,
// 12.6 G operations, ~0.19 ms at the card's 67 TFLOP/s float32 rate. So the
// kernel is bound by its operations, and every culled pair counts.
//
// What the design does about it (simple first; speed comes later):
//   * grid (tiles of 16x16, B), block 256 threads, one pixel per thread;
//   * the block walks the chunks in ascending order and skips every chunk
//     whose box misses the tile (the same inclusive tests as
//     build_tile_chunk_lists :221-224), so the TPU's compacted work lists
//     are not needed;
//   * a surviving chunk's 9 x 128 geometry floats (4.6 KB) are staged in
//     shared memory and read by all 256 threads as broadcasts;
//   * each thread keeps (best z, best face) in registers with a strict
//     z < best test over ascending faces, which reproduces
//     lowest-index-wins; the attributes are interpolated once, for the
//     winner only, so the per-pair loop touches no attribute memory.
//
// Float arithmetic: nvcc would contract a*b + c into an FMA and move
// coverage at triangle edges. Every plane evaluation and the interpolation
// use __fmul_rn / __fadd_rn in the association order of the plain version
// (ops/rasterizer.py): ((px*wa + py*wb) + wc), (1 - w0) - w1 and
// (w0*a0 + w1*a1) + w2*a2; the build keeps nvcc's default --fmad=true.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 16;
constexpr int kFaceChunk = 128;
constexpr int kGeomRows = 16;
constexpr int kGeomUsed = 9;
constexpr float kInf = 1e30f;

__device__ __forceinline__ float plane(float px, float py, float a, float b,
                                       float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

__global__ void __launch_bounds__(kTile * kTile)
raster_kernel(const float* __restrict__ geom, const float* __restrict__ fattr,
              const int4* __restrict__ ranges, float* __restrict__ out_attrs,
              float* __restrict__ out_depth, unsigned char* __restrict__ out_mask,
              int H, int W, int Fp, int A, float znear) {
  __shared__ float sg[kGeomUsed][kFaceChunk];

  const int b = blockIdx.y;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int row0 = (blockIdx.x / tiles_x) * kTile;
  const int col0 = (blockIdx.x % tiles_x) * kTile;
  const int r = row0 + threadIdx.x / kTile;
  const int c = col0 + threadIdx.x % kTile;
  const float px = (float)c + 0.5f;
  const float py = (float)r + 0.5f;

  const int n_chunks = Fp / kFaceChunk;
  const float* g = geom + (size_t)b * kGeomRows * Fp;
  const int4* rg = ranges + (size_t)b * n_chunks;

  float best = kInf;
  int best_face = -1;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int4 box = rg[ch];  // rmin, rmax, cmin, cmax; same for the block
    if (!(box.x < row0 + kTile && box.y >= row0 &&
          box.z < col0 + kTile && box.w >= col0)) {
      continue;
    }
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < kGeomUsed * kFaceChunk; i += blockDim.x) {
      const int row = i / kFaceChunk;
      const int f = i % kFaceChunk;
      sg[row][f] = g[(size_t)row * Fp + ch * kFaceChunk + f];
    }
    __syncthreads();
    for (int f = 0; f < kFaceChunk; ++f) {
      const float w0 = plane(px, py, sg[0][f], sg[1][f], sg[2][f]);
      const float w1 = plane(px, py, sg[3][f], sg[4][f], sg[5][f]);
      const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
      const float z = plane(px, py, sg[6][f], sg[7][f], sg[8][f]);
      const bool covered = (w0 >= 0.0f) & (w1 >= 0.0f) & (w2 >= 0.0f) &
                           (z > znear);
      if (covered && z < best) {
        best = z;
        best_face = ch * kFaceChunk + f;
      }
    }
  }
  if (r >= H || c >= W) return;

  const size_t pix = ((size_t)b * H + r) * W + c;
  float* out = out_attrs + pix * A;
  if (best_face < 0) {
    for (int a = 0; a < A; ++a) out[a] = 0.0f;
    out_depth[pix] = INFINITY;
    out_mask[pix] = 0;
    return;
  }
  const float w0 = plane(px, py, g[best_face], g[(size_t)Fp + best_face],
                         g[(size_t)2 * Fp + best_face]);
  const float w1 = plane(px, py, g[(size_t)3 * Fp + best_face],
                         g[(size_t)4 * Fp + best_face],
                         g[(size_t)5 * Fp + best_face]);
  const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
  const float* fa = fattr + ((size_t)b * Fp + best_face) * 3 * A;
  for (int a = 0; a < A; ++a) {
    out[a] = __fadd_rn(__fadd_rn(__fmul_rn(w0, fa[a]), __fmul_rn(w1, fa[A + a])),
                       __fmul_rn(w2, fa[2 * A + a]));
  }
  out_depth[pix] = best;
  out_mask[pix] = 1;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError().
extern "C" int hp3d_rasterize(const void* geom, const void* fattr,
                              const void* ranges, void* out_attrs,
                              void* out_depth, void* out_mask, int B, int H,
                              int W, int Fp, int A, float znear, void* stream) {
  const int tiles = ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  const dim3 grid(tiles, B);
  raster_kernel<<<grid, kTile * kTile, 0, (cudaStream_t)stream>>>(
      (const float*)geom, (const float*)fattr, (const int4*)ranges,
      (float*)out_attrs, (float*)out_depth, (unsigned char*)out_mask, H, W, Fp,
      A, znear);
  return (int)cudaGetLastError();
}
