// Streaming z-resolve of the dense rasterizer, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `kernel` of
// semantic_meshes/rasterize/dense.py::_make_dense_kernel (z-test
// `_candidate_test`), together with the merge of the micro-fragment image
// that follows it there (dense.py:801-808). It computes the same function;
// the plain PyTorch version beside its wrapper is
// semantic_meshes_torch/rasterize/dense_kernel.py::resolve_dense_plain.
//
// What it computes. One CTA per (16, 128) screen tile b. The sort binning
// left one array of triangle ids, grouped by tile: tile b's own candidates
// are sorted_ids[starts[b], starts[b+1]) and the shared bucket of big
// triangles is sorted_ids[starts[B], starts[B+1]), of which every tile tests
// the first n_global. The CTA tests the global range first, then its own,
// each in chunks of up to 256 ids: the chunk's 64-byte parameter rows are
// gathered from the per-triangle (T+1, 16) table into shared memory (16 KB),
// so the packed, gathered candidate table of the TPU path is never built.
// Each candidate is tested at each pixel centre: three edge forms
// pre-multiplied by sign(area), inside when every w_i >= 0, and an
// inverse-depth plane; a strict inv_z > buffer keeps the earlier candidate
// on a tie. The epilogue turns inv_z into z = 1/inv_z (+inf where empty)
// and merges the micro-fragment image, one packed int64 key per pixel
// (z bits << 32 | id, background +inf), by the lexicographic (z, id)
// minimum with empty ids counting as +inf, as the JAX package does.
//
// The TPU kernel rounds each range start down to a multiple of 64 for its
// DMA engine and so also tests a few candidates of the neighbouring range
// (they fail the inside test); this kernel tests exactly the range.
//
// Layout. 256 threads; thread t owns column t % 128 and rows t / 128 + 2k
// (k < 8), keeping those 8 pixels' inv_z and id in registers. Every thread
// reads the same candidate row at the same time (shared-memory broadcast).
// A warp stores 32 consecutive pixels, once.
//
// What bounds it on the H100: fp32 ALU work. Per candidate and pixel the
// four affine forms cost 4 multiplies and 8 adds once each form's x term is
// taken out of the pixel loop (a thread's pixels share a column), i.e.
// (global + own candidates) x 2048 pixels x 12 flops per tile against
// 67 TFLOP/s of non-tensor fp32; the bytes are one read of the ids, of each
// table row they name and of the micro key image, and one write of the
// 8-byte-per-pixel image at 3.35 TB/s. At bench.py's `scannet` preset the
// flops are several times the bytes. The design keeps the inner loop to
// arithmetic on registers and shared memory and writes each pixel once.
// Known limits, left to a later redesign: the row gathers of a chunk are
// not overlapped with the tests of the one before (no cp.async / TMA double
// buffer), and one CTA per tile cannot spread a heavy tile over several SMs.
//
// Rounding: each form is (p0*px + p1*py) + p2 with __fmul_rn/__fadd_rn (no
// contraction into FMA; the build also passes -fmad=false), and the depth
// is the correctly rounded __fdiv_rn(1, inv_z). Ids and depths are then
// bit-identical to the plain version.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTileW;                 // 2
constexpr int kRowsPerThread = kTileH * kTileW / kThreads;  // 8
constexpr int kChunk = 256;
constexpr int kVecPerRow = 4;  // 16 f32 lanes = 4 float4

__global__ void __launch_bounds__(kThreads)
raster_dense_kernel(const float4* __restrict__ table,
                    const int* __restrict__ sorted_ids,
                    const int* __restrict__ starts,
                    const long long* __restrict__ micro_key,
                    float* __restrict__ zout, int* __restrict__ iout,
                    int num_tiles, int n_global, int nbx, int height,
                    int width, float y_offset) {
  __shared__ float4 rows[kChunk * kVecPerRow];

  const int b = blockIdx.x;
  const int tile_y = b / nbx;
  const int tile_x = b - tile_y * nbx;
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

  // the global bucket first (its first n_global ids), then the tile's own
  const int g_start = starts[num_tiles];
  const int g_end = static_cast<int>(
      min(static_cast<long long>(starts[num_tiles + 1]),
          static_cast<long long>(g_start) + n_global));
  const int range_start[2] = {g_start, starts[b]};
  const int range_end[2] = {g_end, starts[b + 1]};

  for (int r = 0; r < 2; ++r) {
    for (int c0 = range_start[r]; c0 < range_end[r]; c0 += kChunk) {
      const int n = min(kChunk, range_end[r] - c0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int i = threadIdx.x; i < n * kVecPerRow; i += kThreads) {
        rows[i] = table[static_cast<size_t>(sorted_ids[c0 + i / kVecPerRow]) *
                            kVecPerRow + (i % kVecPerRow)];
      }
      __syncthreads();
      for (int c = 0; c < n; ++c) {
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
    }
  }

  if (x >= width) return;
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int y = tile_y * kTileH + row0 + k * kRowStep;
    if (y >= height) continue;
    const size_t o = static_cast<size_t>(y) * width + x;
    float z = invz[k] > 0.0f ? __fdiv_rn(1.0f, invz[k]) : inf;
    int id = idx[k];
    if (micro_key != nullptr) {
      const long long key = micro_key[o];
      const float zm = __int_as_float(static_cast<int>(key >> 32));
      const int im = zm == inf ? -1 : static_cast<int>(key & 0xffffffffLL);
      const int rank_m = im < 0 ? INT_MAX : im;
      const int rank_t = id < 0 ? INT_MAX : id;
      if (zm < z || (zm == z && rank_m < rank_t)) {
        z = zm;
        id = im;
      }
    }
    zout[o] = z;
    iout[o] = id;
  }
}

}  // namespace

// table (T+1, 16) f32; sorted_ids i32 (ids of table rows, grouped by tile);
// starts (num_tiles + 2,) i32; micro_key (height, width) i64 or null;
// outputs z f32 and ids i32, both (height, width) row-major. Returns
// cudaGetLastError().
extern "C" int sm_raster_dense(const void* table, const void* sorted_ids,
                               const void* starts, const void* micro_key,
                               void* zout, void* iout, int num_tiles,
                               int n_global, int nbx, int height, int width,
                               float y_offset, void* stream) {
  if (num_tiles > 0) {
    raster_dense_kernel<<<num_tiles, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table), static_cast<const int*>(sorted_ids),
        static_cast<const int*>(starts),
        static_cast<const long long*>(micro_key), static_cast<float*>(zout),
        static_cast<int*>(iout), num_tiles, n_global, nbx, height, width,
        y_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
