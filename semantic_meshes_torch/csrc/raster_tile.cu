// Tile z-resolve of the triangle rasterizer, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// semantic_meshes/rasterize/pallas_kernel.py::_raster_kernel. It computes the
// same function; the plain PyTorch version beside its wrapper is
// semantic_meshes_torch/rasterize/tile_kernel.py::resolve_tiles_plain.
//
// What it computes. The binning pass gives each (32, 128) screen tile b a
// list of counts[b] <= 256 candidate triangles, ascending ids padded with
// the sentinel row. Each candidate is tested at each pixel centre: three
// edge forms pre-multiplied by sign(area), inside when every w_i >= 0, and
// an inverse-depth plane. A serial scan of the list with a strict inv_z >
// buffer (buffer 0 at first) keeps, per pixel, the first candidate in list
// order that reaches the largest inv_z > 0, so the lowest id on a depth
// tie. Each pixel gets z = 1/inv_z (+inf where empty) and the winner's id
// lane (-1 where empty).
//
// Design. The binning is uneven (at bench.py's `large` preset the mean
// tile holds ~8 candidates, the heaviest ~130, thin slivers of a cube face
// seen edge-on), and a tile owned by one CTA that tests every candidate at
// every one of its 4096 pixels left the kernel as slow as its heaviest
// tiles (PERF.md, raster_tile's redesign).
// 1. Split each tile by pixels. A warp owns 16 columns x 8 rows of a tile
//    (lane l: column l % 16, rows l / 16 + 2k, k < 4, so each form's x term
//    stays out of the pixel loop), 32 rectangles a tile. A CTA of 8 warps
//    takes one 8-row band of a tile, so a tile's pixels are spread over 32
//    warps of four CTAs.
// 2. The CTA stages the tile's list once: thread c fetches row c (64 bytes,
//    cp.async, addressed through the id, which it loads beside the count),
//    and one barrier hands the list (at most 256 rows, 16 KB) to every warp.
// 3. Each warp scans the whole list in order, in batches of 32: lane i tests
//    candidate i of the batch against the warp's rectangle by the exact
//    corner rule (corner_max; raster_common.cuh proves it; the depth plane
//    against the warp's smallest inv_z at the batch's start), and a ballot
//    leaves the survivors, which the whole warp tests at its 128 pixels in
//    order. Each pixel belongs to one warp and that warp sees the full list
//    in order, so the result is the serial scan's by construction: no
//    merge, no scratch, no atomics, no dependence on scheduling.
// On the H100, 16 x 8 rectangles beat 16 x 16 (a heavy rectangle's
// survivors cost half as much per warp; more warps cost more in the empty
// tiles), and the CTA-staged list beat per-warp double-buffered batches
// (one wait instead of one per batch, and 8x fewer row reads from L2); a
// candidate split of heavy tiles was not needed: no rectangle keeps more
// than ~45 survivors (PERF.md, raster_tile's redesign).
//
// What bounds it on the H100. chip_smoke.py's bound is the larger of two
// times. fp32 ALU work: per candidate and pixel the four affine forms cost
// 4 multiplies and 8 adds, 12 operations at each of the 128 pixels of
// every (candidate, warp) test the cull leaves (the launch counts them
// when given `tested`), at 33.5 T un-fused fp32 operations per second (the
// 67 TFLOP/s peak counts an FMA as two, and -fmad=false rules FMA out).
// Bytes: the counts, the listed ids, one read of each table row they name
// and one write of the 8-byte-per-pixel image, at 3.35 TB/s. On bench.py's
// cube scenes the cull leaves so few tests that the bytes bound it, and
// the image write (the launch with every tile empty) is most of the
// kernel's time; the heaviest rectangle's surviving tests (a warp tests a
// survivor at all 4 of a thread's pixels, though a sliver may cover one of
// its rows) are what is left of the imbalance (PERF.md).
//
// Rounding: as raster_common.cuh states, so ids and depths are
// bit-identical to the plain version.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using sm_raster::cp_async16;
using sm_raster::cp_async_commit;
using sm_raster::cp_async_wait_all;
using sm_raster::load_row;
using sm_raster::may_pass;
using sm_raster::Row;
using sm_raster::test_pixels;
using sm_raster::warp_min;

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kWarpCols = 16;                          // a warp's rectangle:
constexpr int kRowsPerThread = 4;                      // 16 x 8 pixels
constexpr int kRowStep = 32 / kWarpCols;               // 2
constexpr int kWarpRows = kRowStep * kRowsPerThread;   // 8
constexpr int kRectCols = kTileW / kWarpCols;          // 8
constexpr int kWarps = kRectCols;  // warps per CTA: one 8-row band a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kBandsPerTile = kTileH / kWarpRows;      // 4 CTAs a tile
static_assert(kBandsPerTile * kWarps * kWarpCols * kWarpRows ==
                  kTileH * kTileW,
              "the warps' rectangles tile the tile");
constexpr int kBatch = 32;  // candidates a warp culls per ballot
constexpr int kMaxCand = 256;
constexpr int kVecPerRow = 4;  // 16 f32 lanes = 4 float4
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads >= kMaxCand, "a thread fetches each row of a list");

// tested: null, or a count the (candidate, warp) tests run are added to
__global__ void __launch_bounds__(kThreads)
raster_tile_kernel(const float4* __restrict__ table,
                   const int* __restrict__ cand,
                   const int* __restrict__ counts,
                   float* __restrict__ zout, int* __restrict__ iout,
                   unsigned long long* __restrict__ tested, int n_slots,
                   int nbx, int height, int width, float y_offset) {
  __shared__ float4 rows[kMaxCand * kVecPerRow];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / kBandsPerTile;
  const int tile_y = b / nbx;
  const int tile_x = b - tile_y * nbx;
  // the warp's rectangle's first pixel, this thread's column and first row
  const int x0 = tile_x * kTileW + warp * kWarpCols;
  const int y0 = tile_y * kTileH + blockIdx.x % kBandsPerTile * kWarpRows;
  const int x = x0 + lane % kWarpCols;
  const int y = y0 + lane / kWarpCols;

  // the count and the list's ids are loaded side by side (slots past the
  // count hold the sentinel row's id); rows are fetched only below the
  // count, as every tile's padding names the same sentinel row (one
  // address for every warp of the grid)
  const int slots = min(n_slots, kMaxCand);
  const int* tile_cand = cand + static_cast<size_t>(b) * n_slots;
  const int count = __ldg(counts + b);
  const int id = threadIdx.x < slots ? __ldg(tile_cand + threadIdx.x) : 0;
  const int n = min(count, slots);
  // thread c fetches row c of the tile's list into shared memory
  if (threadIdx.x < n) {
#pragma unroll
    for (int v = 0; v < kVecPerRow; ++v) {
      cp_async16(rows + threadIdx.x * kVecPerRow + v,
                 table + static_cast<size_t>(id) * kVecPerRow + v);
    }
  }
  cp_async_commit();

  const float px = __fadd_rn(static_cast<float>(x), 0.5f);
  float py[kRowsPerThread];
  float invz[kRowsPerThread];
  int idx[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    py[k] = __fadd_rn(__fadd_rn(static_cast<float>(y + k * kRowStep), 0.5f),
                      y_offset);
    invz[k] = 0.0f;
    idx[k] = -1;
  }
  // the warp's rectangle of pixel centres
  const float pxl = __fadd_rn(static_cast<float>(x0), 0.5f);
  const float pxh = __fadd_rn(static_cast<float>(x0 + kWarpCols - 1), 0.5f);
  const float pyl = __fadd_rn(__fadd_rn(static_cast<float>(y0), 0.5f),
                              y_offset);
  const float pyh = __fadd_rn(
      __fadd_rn(static_cast<float>(y0 + kWarpRows - 1), 0.5f), y_offset);

  cp_async_wait_all();
  __syncthreads();  // the tile's list has landed

  unsigned long long tests = 0;
  for (int cb = 0; cb < n; cb += kBatch) {
    const float4* r = rows + cb * kVecPerRow;
    const float lo = warp_min(invz);
    const bool live =
        cb + lane < n && may_pass(load_row(r, lane), pxl, pxh, pyl, pyh, lo);
    unsigned mask = __ballot_sync(kFull, live);
    tests += __popc(mask);
    while (mask) {
      const Row q = load_row(r, __ffs(mask) - 1);
      mask &= mask - 1;
      test_pixels(q, px, py, invz, idx, __float_as_int(q.q2.y));
    }
  }
  if (tested != nullptr && lane == 0 && tests != 0) atomicAdd(tested, tests);

  if (x >= width) return;
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int yk = y + k * kRowStep;
    if (yk < height) {
      const size_t o = static_cast<size_t>(yk) * width + x;
      zout[o] = invz[k] > 0.0f ? __fdiv_rn(1.0f, invz[k]) : inf;
      iout[o] = idx[k];
    }
  }
}

}  // namespace

// table (T+1, 16) f32, cand (B, n_slots) i32, counts (B,) i32; tested: null
// or one i64 the (candidate, warp) tests run are added to; outputs z f32
// and ids i32, both (height, width) row-major. Returns cudaGetLastError().
extern "C" int sm_raster_tile(const void* table, const void* cand,
                              const void* counts, void* zout, void* iout,
                              void* tested, int num_tiles, int n_slots,
                              int nbx, int height, int width, float y_offset,
                              void* stream) {
  if (num_tiles > 0) {
    raster_tile_kernel<<<num_tiles * kBandsPerTile, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table), static_cast<const int*>(cand),
        static_cast<const int*>(counts), static_cast<float*>(zout),
        static_cast<int*>(iout), static_cast<unsigned long long*>(tested),
        n_slots, nbx, height, width, y_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
