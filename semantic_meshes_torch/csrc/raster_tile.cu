// Tile z-resolve of the triangle rasterizer, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// semantic_meshes/rasterize/pallas_kernel.py::_raster_kernel. It computes the
// same function; the plain PyTorch version beside its wrapper is
// semantic_meshes_torch/rasterize/tile_kernel.py::resolve_tiles_plain.
//
// What it computes. One CTA per (32, 128) screen tile b. The tile's
// counts[b] candidate triangles (ascending ids, from the binning pass) are
// tested at each pixel centre: three edge forms pre-multiplied by
// sign(area), inside when every w_i >= 0, and an inverse-depth plane. A
// strict inv_z > buffer keeps the lowest id on a depth tie. Each pixel gets
// z = 1/inv_z (+inf where empty) and the winner's id (-1 where empty).
//
// Layout. The CTA gathers its counts[b] table rows (64 bytes each, at most
// 256 of them = 16 KB) through the candidate ids into shared memory, so the
// (B, N, 16) per-tile gathered table that the TPU path builds in device
// memory never exists. 256 threads; thread t owns column t % 128 and rows
// t / 128 + 2k (k < 16), keeping those 16 pixels' inv_z and id in
// registers. Every thread reads the same candidate row at the same time
// (shared-memory broadcast). A warp stores 32 consecutive pixels, once.
//
// What bounds it on the H100: fp32 ALU work against the image write. Per
// candidate and pixel the four affine forms cost 4 multiplies and 8 adds
// once each form's x term is taken out of the pixel loop (plus four
// compares and two selects), i.e. sum(counts) x 4096 pixels x 12 flops
// against the card's 67 TFLOP/s of non-tensor fp32; the bytes are the
// candidate ids, one read of each table row they name and one write of the
// 8-byte-per-pixel image at 3.35 TB/s. On bench.py's cube scenes the two
// are of one size (at `large`, ~6000 tile-candidates per 2048x1536 view:
// ~4.4 us of fp32 work, ~7.5 us of writes). The design takes each form's x
// term out of the pixel loop (a thread's pixels share a column) and reads
// candidate rows from shared memory, so the inner loop is arithmetic only,
// and it writes each pixel once. Incremental (per-row stepping) evaluation would save more
// multiplies but round differently from the plain version; it is not
// used. Known limit: one CTA per tile cannot spread a heavy tile (up to
// ~130 candidates where the mean is ~8) over several SMs; the kernel runs
// well above its bound (PERF.md).
//
// Rounding: each form is (p0*px + p1*py) + p2 with __fmul_rn/__fadd_rn (no
// contraction into FMA; the build also passes -fmad=false), and the depth
// is the correctly rounded __fdiv_rn(1, inv_z). Ids and depths are then
// bit-identical to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTileW;              // 2
constexpr int kRowsPerThread = kTileH * kTileW / kThreads;  // 16
constexpr int kMaxCand = 256;
constexpr int kVecPerRow = 4;  // 16 f32 lanes = 4 float4

__global__ void __launch_bounds__(kThreads)
raster_tile_kernel(const float4* __restrict__ table,
                   const int* __restrict__ cand,
                   const int* __restrict__ counts,
                   float* __restrict__ zout, int* __restrict__ iout,
                   int n_slots, int nbx, int height, int width,
                   float y_offset) {
  __shared__ float4 rows[kMaxCand * kVecPerRow];

  const int b = blockIdx.x;
  const int tile_y = b / nbx;
  const int tile_x = b - tile_y * nbx;
  const int n_cand = min(counts[b], min(n_slots, kMaxCand));
  const int* tile_cand = cand + static_cast<size_t>(b) * n_slots;
  for (int i = threadIdx.x; i < n_cand * kVecPerRow; i += kThreads) {
    rows[i] = table[static_cast<size_t>(tile_cand[i / kVecPerRow]) *
                        kVecPerRow + (i % kVecPerRow)];
  }
  __syncthreads();

  const int col = threadIdx.x % kTileW;
  const int row0 = threadIdx.x / kTileW;
  const int x = tile_x * kTileW + col;
  const float px = __fadd_rn(static_cast<float>(x), 0.5f);
  float py[kRowsPerThread];
  float invz[kRowsPerThread];
  int idx[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int y = tile_y * kTileH + row0 + k * kRowStep;
    py[k] = __fadd_rn(__fadd_rn(static_cast<float>(y), 0.5f), y_offset);
    invz[k] = 0.0f;
    idx[k] = -1;
  }

  for (int c = 0; c < n_cand; ++c) {
    // lanes: q0 = (a0, b0, c0, a1), q1 = (b1, c1, a2, b2),
    //        q2 = (c2, id, az, bz), q3 = (cz, 0, 0, 0)
    const float4 q0 = rows[c * kVecPerRow + 0];
    const float4 q1 = rows[c * kVecPerRow + 1];
    const float4 q2 = rows[c * kVecPerRow + 2];
    const float q3x = rows[c * kVecPerRow + 3].x;
    const float ax0 = __fmul_rn(q0.x, px);
    const float ax1 = __fmul_rn(q0.w, px);
    const float ax2 = __fmul_rn(q1.z, px);
    const float axz = __fmul_rn(q2.z, px);
    const int tid = __float_as_int(q2.y);
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const float w0 = __fadd_rn(__fadd_rn(ax0, __fmul_rn(q0.y, py[k])), q0.z);
      const float w1 = __fadd_rn(__fadd_rn(ax1, __fmul_rn(q1.x, py[k])), q1.y);
      const float w2 = __fadd_rn(__fadd_rn(ax2, __fmul_rn(q1.w, py[k])), q2.x);
      const float iz = __fadd_rn(__fadd_rn(axz, __fmul_rn(q2.w, py[k])), q3x);
      const bool ok = (w0 >= 0.0f) & (w1 >= 0.0f) & (w2 >= 0.0f) &
                      (iz > invz[k]);
      invz[k] = ok ? iz : invz[k];
      idx[k] = ok ? tid : idx[k];
    }
  }

  if (x >= width) return;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int y = tile_y * kTileH + row0 + k * kRowStep;
    if (y < height) {
      const size_t o = static_cast<size_t>(y) * width + x;
      zout[o] = invz[k] > 0.0f ? __fdiv_rn(1.0f, invz[k]) : __int_as_float(0x7f800000);
      iout[o] = idx[k];
    }
  }
}

}  // namespace

// table (T+1, 16) f32, cand (B, n_slots) i32, counts (B,) i32; outputs z f32
// and ids i32, both (height, width) row-major. Returns cudaGetLastError().
extern "C" int sm_raster_tile(const void* table, const void* cand,
                              const void* counts, void* zout, void* iout,
                              int num_tiles, int n_slots, int nbx, int height,
                              int width, float y_offset, void* stream) {
  if (num_tiles > 0) {
    raster_tile_kernel<<<num_tiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table), static_cast<const int*>(cand),
        static_cast<const int*>(counts), static_cast<float*>(zout),
        static_cast<int*>(iout), n_slots, nbx, height, width, y_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
