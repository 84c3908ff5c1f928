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
// What it computes. The sort binning left one array of triangle ids,
// grouped by (16, 128) screen tile: tile b's own candidates are
// sorted_ids[starts[b], starts[b+1]) and the shared bucket of big triangles
// is sorted_ids[starts[B], starts[B+1]), of which every tile tests the
// first n_global. A tile's candidate list is those G = min(bucket,
// n_global) global ids, then its own. Each candidate is tested at each
// pixel centre: three edge forms pre-multiplied by sign(area), inside when
// every w_i >= 0, and an inverse-depth plane; a serial scan of the list
// with a strict inv_z > buffer (buffer 0 at first) keeps, per pixel, the
// FIRST candidate in list order that reaches the largest inv_z > 0
// (inv_z <= 0 and NaN never win). The epilogue turns inv_z into
// z = 1/inv_z (+inf where empty) and merges the micro-fragment image, one
// packed int64 key per pixel (z bits << 32 | id, background +inf), by the
// lexicographic (z, id) minimum with empty ids counting as +inf, as the
// JAX package does. The TPU kernel rounds each range start down to a
// multiple of 64 for its DMA engine and so also tests a few candidates of
// the neighbouring range (they fail the inside test); this kernel tests
// exactly the list.
//
// Design. The sort binning is uneven: at bench.py's `scannet` preset 579
// of the 671 tiles are empty and the heaviest holds ~3400 candidates, 20x
// the mean, so one CTA per tile left the kernel as slow as its heaviest
// tile (~0.7 of the kernel's time on the H100).
// 1. Work items. Each tile's list is cut into items of at most kItem
//    candidates (an empty tile is one item with none, so it still gets its
//    epilogue). A persistent grid (SMs x resident CTAs, read once on the
//    host) walks the items round-robin: CTA c takes items c, c + grid,
//    ..., so a heavy tile's items run on neighbouring CTAs at once. The
//    block keeps the inclusive prefix sums of the item counts of a window
//    of kWindow tiles in shared memory (one block scan over `starts`; the
//    window only moves forward) and maps an item index to its tile by a
//    binary search: nothing is enumerated on the host and nothing needs a
//    host sync. kItem = 64 and three CTAs per SM won on the H100 over 32,
//    128 and 256 and two: smaller items spread the heavy tiles wider,
//    larger ones pay less per-item merging and pipeline latency.
// 2. Exact merge across a tile's items. An item scans its candidates in
//    order from buffer 0, so it keeps the first of its candidates that
//    reaches its largest inv_z > 0. A tile of one item writes its image
//    directly. Otherwise each item folds, per pixel it covers, the key
//    (bits(inv_z) << 32) | (0xFFFFFFFF - position in the list) into a
//    per-pixel scratch with atomicMax: positive floats order like their
//    bits, and on equal inv_z the earlier position has the larger key, so
//    the maximum is the serial scan's winner whatever order the items end
//    in. The item that raises the tile's arrival counter last (a barrier,
//    then thread 0's __threadfence around the atomic) reads the keys back,
//    maps the position to its table row's id (by position, not id: a
//    global id precedes a smaller own id), and runs the epilogue. Output
//    bits do not depend on scheduling. The scratch (keys and counters) is
//    zero at launch, and the last arrival zeroes its tile's keys and
//    counter again after reading them, so every launch leaves it zero: the
//    wrapper keeps one per stream and zeroes it only when it allocates it.
// 3. Double buffer. While item i is tested, the 64-byte rows of item i+1
//    are in flight into the second row buffer (cp.async.cg, 16 bytes, four
//    per row, addressed through the ids) and the ids of item i+2 into the
//    second id buffer (cp.async.ca, 4 bytes); one wait_all and a
//    __syncthreads hand over each item. (TMA has no indexed gather on
//    sm_90, hence cp.async.) The epilogue issues all of a thread's loads
//    (micro keys, scratch keys, then ids and table rows) before it uses
//    any.
// 4. Exact per-warp cull. A warp owns 16 columns x 16 rows of the tile
//    (lane l: column l % 16, rows l / 16 + 2k, k < 8; one column per
//    thread keeps each form's x term out of the pixel loop). Each lane
//    tests one candidate of a batch of 32 against the warp's rectangle
//    (corner_max; why that is exact: raster_common.cuh) and a ballot
//    leaves the survivors, which the whole warp then tests at its 256
//    pixels in list order. 16 x 16 was kept over 32 x 8: both cull ~0.79
//    of the (candidate, warp) tests at `scannet`, and 32 x 8 culls more in
//    the heaviest tiles (thin horizontal slivers), but it piles their
//    survivors onto the warps of one row band, and a block waits for its
//    busiest warp; 16 x 16 was faster on the H100.
//
// What bounds it on the H100. The bound chip_smoke.py reports is fp32 ALU
// work: per candidate and pixel the four affine forms cost 4 multiplies
// and 8 adds, 12 operations at each of the 256 pixels of every (candidate,
// warp) test the cull leaves (the launch counts them when given `tested`),
// against 33.5 T un-fused fp32 operations per second (the 67 TFLOP/s
// peak counts an FMA as two, and -fmad=false rules FMA out). The bytes
// are one read of the ids, of each table row they name and of the micro
// key image, and one write of the 8-byte-per-pixel image at 3.35 TB/s,
// plus the per-pixel keys of tiles of several items. What is left: the heavy
// tiles' surviving tests (a warp tests a survivor at all 8 of a thread's
// pixels, though a sliver covers one or two of its rows), a block's wait
// for its busiest warp, and per item a pass through the pipeline (an
// empty tile still costs one) and, for a split tile, the merge.
//
// Rounding: as raster_common.cuh states, so ids and depths are
// bit-identical to the plain version.

#include <climits>
#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using sm_raster::cp_async16;
using sm_raster::cp_async4;
using sm_raster::cp_async_commit;
using sm_raster::cp_async_wait_all;
using sm_raster::load_row;
using sm_raster::may_pass;
using sm_raster::test_pixels;
using sm_raster::warp_min;

constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr int kTilePixels = kTileH * kTileW;           // 2048
constexpr int kThreads = 256;
constexpr int kWarpCols = 16;                          // a warp's rectangle:
constexpr int kWarpRows = 32 * 8 / kWarpCols;          // 16 x 16 pixels
constexpr int kWarpsPerBand = kTileW / kWarpCols;      // 8
constexpr int kRowStep = 32 / kWarpCols;               // 2
constexpr int kRowsPerThread = kWarpRows / kRowStep;   // 8
static_assert(kThreads / 32 * kWarpCols * kWarpRows == kTilePixels,
              "the warps' rectangles tile the tile");
constexpr int kItem = 64;  // candidates per work item (one shared buffer)
constexpr int kVecPerRow = 4;  // 16 f32 lanes = 4 float4
constexpr int kMinBlocksPerSm = 3;  // __launch_bounds__: at most 80 registers
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWindow = 1024;  // tiles per shared-memory window of item counts
// packed micro key of an empty pixel: +inf depth bits, the largest id
constexpr long long kBgKey = (0x7f800000LL << 32) | 0x7fffffffLL;

struct Item {
  int tile;       // -1: no item left
  int first;      // position of its first candidate in the tile's list
  int count;      // its candidates (0 for an empty tile)
  int items;      // work items of the tile
  int own_start;  // starts[tile]
};

// All threads: the shared-memory window of tiles [tile0, tile0 + kWindow):
// the inclusive prefix sums of their item counts max(1, ceil(len /
// kItem)), len = n_glob + own, in incl[]. Returns the window's item total.
__device__ int build_window(int tile0, int num_tiles, int n_glob,
                            const int* __restrict__ starts, int* incl,
                            int* warp_sums) {
  constexpr int kPer = kWindow / kThreads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int cnt[kPer];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int t = tile0 + threadIdx.x * kPer + j;
    cnt[j] = t < num_tiles
                 ? max(1, (n_glob + __ldg(starts + t + 1) - __ldg(starts + t) +
                           kItem - 1) / kItem)
                 : 0;
    sum += cnt[j];
  }
  int run = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, run, d);
    if (lane >= d) run += v;
  }
  if (lane == 31) warp_sums[warp] = run;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) run += warp_sums[w];
    total += warp_sums[w];
  }
  run -= sum;  // items of the window's tiles before this thread's
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    run += cnt[j];
    incl[threadIdx.x * kPer + j] = run;
  }
  __syncthreads();
  return total;
}

// Work item `i` (base <= i < base + the window's total): its tile by a
// binary search of the window's prefix sums, and its place in the tile's
// list.
__device__ __forceinline__ Item item_at(int i, int tile0, int base,
                                        const int* incl,
                                        const int* __restrict__ starts,
                                        int n_glob) {
  const int r = i - base;
  int lo = 0, hi = kWindow - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (incl[mid] > r) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int before = lo > 0 ? incl[lo - 1] : 0;
  Item it;
  it.tile = tile0 + lo;
  it.own_start = __ldg(starts + it.tile);
  it.items = incl[lo] - before;
  it.first = (r - before) * kItem;
  it.count = min(kItem, n_glob + __ldg(starts + it.tile + 1) - it.own_start -
                            it.first);
  return it;
}

// Warp 0: the ids of item `it` (global ids first, then the tile's own).
__device__ __forceinline__ void fetch_ids(const Item& it, int* dst,
                                          const int* __restrict__ sorted_ids,
                                          int g_start, int n_glob, int lane) {
  for (int c = lane; c < it.count; c += 32) {
    const int p = it.first + c;
    const int src = p < n_glob ? g_start + p : it.own_start + (p - n_glob);
    cp_async4(dst + c, sorted_ids + src);
  }
}

// All threads: the 64-byte table rows named by `ids`.
__device__ __forceinline__ void fetch_rows(int count, const int* ids,
                                           float4* dst,
                                           const float4* __restrict__ table) {
  for (int v = threadIdx.x; v < count * kVecPerRow; v += kThreads) {
    cp_async16(dst + v, table + static_cast<size_t>(ids[v / kVecPerRow]) *
                                    kVecPerRow + (v % kVecPerRow));
  }
}

// This thread's pixels (column x, rows y0 + k * kRowStep) of the micro
// image, all loads issued before any is used; background where there is
// no micro image or the pixel lies outside the image.
__device__ __forceinline__ void load_micro(int x, int y0,
                                           const long long* micro_key,
                                           int height, int width,
                                           long long (&mk)[kRowsPerThread]) {
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int y = y0 + k * kRowStep;
    mk[k] = micro_key != nullptr && x < width && y < height
                ? __ldg(micro_key + static_cast<size_t>(y) * width + x)
                : kBgKey;
  }
}

// Writes this thread's pixels: z = 1/inv_z (+inf where inv_z is 0) and
// the id, merged with the micro key by the lexicographic (z, id) minimum
// with empty ids counting as +inf.
__device__ __forceinline__ void store_pixels(
    int x, int y0, const float (&invz)[kRowsPerThread],
    const int (&ids)[kRowsPerThread], const long long (&mk)[kRowsPerThread],
    float* zout, int* iout, int height, int width) {
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int y = y0 + k * kRowStep;
    if (x >= width || y >= height) continue;
    const size_t o = static_cast<size_t>(y) * width + x;
    float z = invz[k] > 0.0f ? __fdiv_rn(1.0f, invz[k]) : inf;
    int id = ids[k];
    const float zm = __int_as_float(static_cast<int>(mk[k] >> 32));
    const int im = zm == inf ? -1 : static_cast<int>(mk[k] & 0xffffffffLL);
    const int rank_m = im < 0 ? INT_MAX : im;
    const int rank_t = id < 0 ? INT_MAX : id;
    if (zm < z || (zm == z && rank_m < rank_t)) {
      z = zm;
      id = im;
    }
    zout[o] = z;
    iout[o] = id;
  }
}

// work: num_tiles * 2048 per-pixel keys, then num_tiles arrival counters
// (uint32); all zero at launch, and left zero. tested: null, or a count
// the (candidate, warp) tests run are added to.
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
raster_dense_kernel(const float4* __restrict__ table,
                    const int* __restrict__ sorted_ids,
                    const int* __restrict__ starts,
                    const long long* __restrict__ micro_key,
                    float* __restrict__ zout, int* __restrict__ iout,
                    unsigned long long* __restrict__ work,
                    unsigned long long* __restrict__ tested, int num_tiles,
                    int n_global, int nbx, int height, int width,
                    float y_offset) {
  __shared__ float4 rows[2][kItem * kVecPerRow];
  __shared__ int ids[2][kItem];
  __shared__ int incl[kWindow];
  __shared__ int warp_sums[kThreads / 32];
  __shared__ Item ring[3];
  __shared__ int last_arrival;

  unsigned long long* keys = work;
  unsigned* arrived = reinterpret_cast<unsigned*>(
      work + static_cast<size_t>(num_tiles) * kTilePixels);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g_start = starts[num_tiles];
  const int n_glob = static_cast<int>(
      max(0LL, min(static_cast<long long>(starts[num_tiles + 1]) - g_start,
                   static_cast<long long>(n_global))));

  // the window of item counts (every thread holds the same copy of its
  // place); it only moves forward, as a CTA's item indices increase
  int win_tile = 0, win_base = 0;
  int win_total = build_window(0, num_tiles, n_glob, starts, incl,
                               warp_sums);
  auto advance_to = [&](int i) {  // uniform in the block
    while (i >= win_base + win_total && win_tile + kWindow < num_tiles) {
      win_base += win_total;
      win_tile += kWindow;
      win_total = build_window(win_tile, num_tiles, n_glob, starts, incl,
                               warp_sums);
    }
  };
  auto resolve = [&](int i) {  // warp 0; the same in every lane
    Item it;
    if (i < win_base + win_total) {
      it = item_at(i, win_tile, win_base, incl, starts, n_glob);
    } else {
      it.tile = -1;
      it.first = it.count = it.items = it.own_start = 0;
    }
    return it;
  };

  // prologue: this CTA's first two items resolved with their ids
  // fetched, the first one's rows in flight
  for (int r = 0; r < 2; ++r) {
    const int i = blockIdx.x + r * gridDim.x;
    advance_to(i);
    if (warp == 0) {
      const Item it = resolve(i);
      if (lane == 0) ring[r] = it;
      if (it.tile >= 0) fetch_ids(it, ids[r], sorted_ids, g_start, n_glob,
                                  lane);
    }
  }
  if (warp == 0) {
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
  if (ring[0].tile >= 0) fetch_rows(ring[0].count, ids[0], rows[0], table);
  cp_async_commit();

  // this thread's column and first row in the tile, and its warp's
  // rectangle's first column and row
  const int wx = warp % kWarpsPerBand * kWarpCols;
  const int wy = warp / kWarpsPerBand * kWarpRows;
  const int col = wx + lane % kWarpCols;
  const int row0 = wy + lane / kWarpCols;
  unsigned long long tests = 0;
  int s = 0;  // buffer of the current item's rows (the next item's ids
              // are in ids[s ^ 1])
  int d = 0;  // ring slot of the current item
  for (int i2 = blockIdx.x + 2 * gridDim.x;; i2 += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // this item's rows and the next one's ids have landed;
                      // every thread is done with the previous item
    const Item it = ring[d];
    if (it.tile < 0) break;
    const Item nx = ring[(d + 1) % 3];
    if (nx.tile >= 0) fetch_rows(nx.count, ids[s ^ 1], rows[s ^ 1], table);
    advance_to(i2);
    if (warp == 0) {
      const Item n2 = resolve(i2);
      if (lane == 0) ring[(d + 2) % 3] = n2;
      if (n2.tile >= 0) fetch_ids(n2, ids[s], sorted_ids, g_start, n_glob,
                                  lane);
    }
    cp_async_commit();

    const int tile_y = it.tile / nbx;
    const int tile_x = it.tile - tile_y * nbx;
    const int x0 = tile_x * kTileW + wx;  // the warp's first pixel
    const int y0 = tile_y * kTileH + wy;
    const int x = tile_x * kTileW + col;
    const int y = tile_y * kTileH + row0;  // this thread's first row
    const float px = __fadd_rn(static_cast<float>(x), 0.5f);
    float py[kRowsPerThread];
    float invz[kRowsPerThread];
    int best[kRowsPerThread];  // index in the item, -1: none
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      py[k] = __fadd_rn(__fadd_rn(static_cast<float>(y + k * kRowStep), 0.5f),
                        y_offset);
      invz[k] = 0.0f;
      best[k] = -1;
    }
    // the warp's rectangle of pixel centres
    const float pxl = __fadd_rn(static_cast<float>(x0), 0.5f);
    const float pxh = __fadd_rn(static_cast<float>(x0 + kWarpCols - 1), 0.5f);
    const float pyl = __fadd_rn(__fadd_rn(static_cast<float>(y0), 0.5f),
                                y_offset);
    const float pyh = __fadd_rn(
        __fadd_rn(static_cast<float>(y0 + kWarpRows - 1), 0.5f), y_offset);
    const float4* r = rows[s];

    for (int cb = 0; cb < it.count; cb += 32) {
      const float lo = warp_min(invz);
      const int c = cb + lane;
      const bool live = c < it.count &&
                        may_pass(load_row(r, c), pxl, pxh, pyl, pyh, lo);
      unsigned mask = __ballot_sync(kFull, live);
      tests += __popc(mask);
      while (mask) {
        const int cc = cb + __ffs(mask) - 1;
        mask &= mask - 1;
        test_pixels(load_row(r, cc), px, py, invz, best, cc);
      }
    }

    long long mk[kRowsPerThread];
    int id[kRowsPerThread];
    if (it.items == 1) {
      load_micro(x, y, micro_key, height, width, mk);
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        id[k] = best[k] < 0 ? -1
                            : __float_as_int(r[best[k] * kVecPerRow + 2].y);
      }
      store_pixels(x, y, invz, id, mk, zout, iout, height, width);
    } else {
      unsigned long long* tkeys =
          keys + static_cast<size_t>(it.tile) * kTilePixels;
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        if (best[k] >= 0) {
          const unsigned pos = static_cast<unsigned>(it.first + best[k]);
          atomicMax(tkeys + (row0 + k * kRowStep) * kTileW + col,
                    (static_cast<unsigned long long>(__float_as_uint(invz[k]))
                     << 32) | (0xffffffffu - pos));
        }
      }
      // the barrier orders the block's keys before thread 0's fence
      // (cumulative) and arrival; the last arrival's fence orders every
      // item's keys before the barrier and the reads after it
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        last_arrival = atomicAdd(arrived + it.tile, 1u) ==
                       static_cast<unsigned>(it.items - 1);
        __threadfence();
      }
      __syncthreads();
      if (last_arrival) {
        load_micro(x, y, micro_key, height, width, mk);
        unsigned long long key[kRowsPerThread];
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          key[k] = __ldcg(tkeys + (row0 + k * kRowStep) * kTileW + col);
        }
        // every item of the tile has arrived: leave its scratch zero for
        // the next launch
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          __stcg(tkeys + (row0 + k * kRowStep) * kTileW + col, 0ull);
        }
        if (threadIdx.x == 0) arrived[it.tile] = 0u;
        int row[kRowsPerThread];
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          const int p = static_cast<int>(
              0xffffffffu - static_cast<unsigned>(key[k] & 0xffffffffu));
          const int src =
              p < n_glob ? g_start + p : it.own_start + (p - n_glob);
          row[k] = key[k] != 0 ? __ldg(sorted_ids + src) : 0;
        }
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          invz[k] = __uint_as_float(static_cast<unsigned>(key[k] >> 32));
          id[k] = key[k] != 0
                      ? __float_as_int(__ldg(reinterpret_cast<const float*>(
                            table + static_cast<size_t>(row[k]) *
                                        kVecPerRow) + 9))
                      : -1;
        }
        store_pixels(x, y, invz, id, mk, zout, iout, height, width);
      }
    }
    d = (d + 1) % 3;
    s ^= 1;
  }
  if (tested != nullptr && lane == 0 && tests != 0) atomicAdd(tested, tests);
}

int grid_cache[kMaxDevices];  // persistent grid size per device, 0: unread

}  // namespace

// table (T+1, 16) f32; sorted_ids i32 (ids of table rows, grouped by tile);
// starts (num_tiles + 2,) i32; micro_key (height, width) i64 or null; work
// (num_tiles * 2048 + ceil(num_tiles / 2),) i64 or longer, zero (and left
// zero); tested: null or one i64 the tests run are added to; outputs z f32
// and ids i32, both (height, width) row-major. Returns the first CUDA
// error of the occupancy query or the launch (0 if none).
extern "C" int sm_raster_dense(const void* table, const void* sorted_ids,
                               const void* starts, const void* micro_key,
                               void* zout, void* iout, void* work,
                               void* tested, int num_tiles, int n_global,
                               int nbx, int height, int width,
                               float y_offset, void* stream) {
  if (num_tiles > 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    int grid = dev < kMaxDevices ? grid_cache[dev] : 0;
    if (grid == 0) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, raster_dense_kernel, kThreads, 0);
      if (err != cudaSuccess) return static_cast<int>(err);
      grid = sms * max(per_sm, 1);
      if (dev < kMaxDevices) grid_cache[dev] = grid;
    }
    raster_dense_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table), static_cast<const int*>(sorted_ids),
        static_cast<const int*>(starts),
        static_cast<const long long*>(micro_key), static_cast<float*>(zout),
        static_cast<int*>(iout), static_cast<unsigned long long*>(work),
        static_cast<unsigned long long*>(tested), num_tiles, n_global, nbx,
        height, width, y_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
