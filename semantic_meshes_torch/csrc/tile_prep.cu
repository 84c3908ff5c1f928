// The tile rasterizer's preparation of one view, hand-written for Hopper
// (sm_90a): triangle setup, the candidate table, and each (32, 128) screen
// tile's list of candidates in ascending id order, its count and the
// overflow of rows past the list's length.
//
// It replaces no TPU kernel: the JAX package computes these steps with XLA
// ops (semantic_meshes/rasterize/xla.py's setup and _bin_triangles). The
// port first wrote them as a chain of PyTorch ops, ~197 launches and 6
// host waits a view at the ScanNet eval's frame (tiles.setup_inputs, then
// tiles._bin_triangles with its (tiles, rows) overlap and a topk of each
// tile's smallest ids, then tile_kernel.candidate_table). That chain stays
// as the CPU implementation and the oracle these kernels are tested
// against bit for bit on the card (tile_kernel.resolve_inputs_plain); the
// wrapper is semantic_meshes_torch/rasterize/tile_prep.py.
//
// What bounds it on the H100. The work is small: ~100 fp32 operations and
// 36 bytes read a setup row, a 64-byte table row and an 8-byte tile
// rectangle written, and N ids a tile. At 10240 rows and 341 tiles of 448
// ids that is ~1.3 MB, ~0.4 us at 3.35 TB/s. The list pass reads every
// row's rectangle once for each tile, 341 x 80 KB = 28 MB, from L2: the
// rectangles are written just before and stay there. The chain it replaces
// was bound by the host's launches, not by the card. So the design is two
// launches, no sort and no (tiles, rows) tensor:
// 1. tile_setup_kernel, one thread a setup row: the setup (the camera
//    transform, the near-plane clipper's piece with clip_near, the
//    pinhole projection; setup_common.cuh), the row's table row, and its
//    inclusive tile rectangle as tiles._tile_bounds makes it, packed into
//    8 bytes (16 bits a bound), or "not binned" for a row that is invalid
//    or off screen. Block 0 writes the sentinel row T and zeroes the
//    overflow. Rows past the last, up to a multiple of kStep, read as not
//    binned, so the list pass needs no bounds test.
// 2. tile_bins_kernel, one block a tile: the block scans the rectangles in
//    ascending row order, kStep rows a step, four consecutive rows a thread
//    (two 16-byte loads, the next step's loaded before this step's scan).
//    A warp scan of the threads' match counts and the warps' totals in
//    shared memory give each listed row its position. It writes the first
//    N = min(cap, rows) ids in ascending order and the sentinel T after
//    them, the count min(listed, N), and adds max(listed - N, 0) to the
//    overflow: the values of topk(largest=False), and the only atomic is
//    one integer add a tile, so the outputs do not depend on the order the
//    blocks run in.
// The camera is a kernel argument, copied from the host at launch (no
// upload and no sync), or read from device memory where the caller holds
// it there.
//
// Rounding: the setup is the plain chain's, op for op (setup_common.cuh),
// and the tile bounds are tiles._tile_range's: floor(v / size) (a power of
// two, so the quotient is exact as the chain's product by its reciprocal
// is), clamped to [-1, n] with NaN passing, converted with NaN -> 0, then
// clamped to [0, n - 1]. The outputs are then bit-identical to the plain
// chain's on the card.

#include <cuda_runtime.h>

#include "setup_common.cuh"

namespace sm_tile_prep {

// Everything of one view; the wrapper fills it (tile_prep.py's _Params,
// field for field) and each launch copies it as its argument. Outside the
// anonymous namespace: the C entry points take it.
struct Params {
  float cam[16];  // rotation (9, row-major), translation 3, focal 2,
                  // principal point 2
  const float* cam_ptr[4];  // those four on the device, or null: by value
  const float* face_vertices;  // (faces, 3, 3), or null: gathered
  const float* vertices;       // (V, 3), read where face_vertices is null
  const void* faces;           // (faces, 3) int32 or int64, likewise
  float4* table;               // (rows + 1, 16)
  uint2* rects;                // (rows rounded up to kStep,) tile bounds
  int* cand;                   // (tiles, n)
  int* counts;                 // (tiles,)
  int* overflow;               // (1,)
  int rows;  // faces, or 2 x faces with clip_near
  int faces64;
  int clip;
  int height;
  int width;
  int nbx;
  int nby;
  int n;  // list length: min(cap, rows)
  float y_offset;
};

}  // namespace sm_tile_prep

namespace {

using sm_setup::Setup;
using sm_setup::sub;
using sm_tile_prep::Params;

constexpr int kThreads = 256;     // rows a block of the setup pass
constexpr int kBinThreads = 256;  // threads a tile of the list pass
constexpr int kPerThread = 4;     // rows a thread a step: two 16-byte loads
constexpr int kStep = kBinThreads * kPerThread;
constexpr int kWarps = kBinThreads / 32;
constexpr float kTileH = 32.0f;  // tiles.TILE_H
constexpr float kTileW = 128.0f;  // tiles.TILE_W
constexpr unsigned kFull = 0xffffffffu;
// the x word of a rectangle no tile is in: x0 = 65535 past every column
// (the wrapper holds nbx under 65535)
constexpr unsigned kNotBinnedX = 0xffffu;

__host__ __device__ constexpr int padded_rows(int rows) {
  return (rows + kStep - 1) / kStep * kStep;
}

// tiles._tile_range's end of coordinate v: clamp(floor(v / size), -1, n)
// (NaN passes), as int32 (NaN -> 0), clamped to [0, n - 1]
__device__ __forceinline__ int tile_of(float v, float size, int n) {
  const float f = sm_setup::clamp_nan(floorf(sm_setup::quot(v, size)), -1.0f,
                                      static_cast<float>(n));
  const int t = isnan(f) ? 0 : static_cast<int>(f);
  return min(max(t, 0), n - 1);
}

// tiles._tile_bounds of one row: its inclusive tile rectangle, packed as
// (bx0 | bx1 << 16, by0 | by1 << 16), or (kNotBinnedX, 0) where the row is
// invalid or off screen (or its range empty: it bins nowhere)
__device__ __forceinline__ uint2 tile_rect(const Params& p, const Setup& s) {
  const float ymin = sub(s.ymin, p.y_offset);
  const float ymax = sub(s.ymax, p.y_offset);
  const int bx0 = tile_of(s.xmin, kTileW, p.nbx);
  const int bx1 = tile_of(s.xmax, kTileW, p.nbx);
  const int by0 = tile_of(ymin, kTileH, p.nby);
  const int by1 = tile_of(ymax, kTileH, p.nby);
  const bool onscreen = s.xmax >= 0.0f &&
                        s.xmin < static_cast<float>(p.width) &&
                        ymax >= 0.0f && ymin < static_cast<float>(p.height);
  if (!(s.valid && onscreen) || bx0 > bx1 || by0 > by1) {
    return make_uint2(kNotBinnedX, 0u);
  }
  return make_uint2(static_cast<unsigned>(bx0) | static_cast<unsigned>(bx1)
                                                     << 16,
                    static_cast<unsigned>(by0) | static_cast<unsigned>(by1)
                                                     << 16);
}

// The world-space vertices of triangle `tri`: its face-vertex rows, or
// gathered from the vertices by its int32 or int64 face
__device__ __forceinline__ void load_triangle(const Params& p, int tri,
                                              float (&w)[3][3]) {
  if (p.face_vertices != nullptr) {
    const float* fv = p.face_vertices + static_cast<size_t>(tri) * 9;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) w[i][j] = __ldg(fv + 3 * i + j);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const size_t at = static_cast<size_t>(tri) * 3 + i;
    const long long v =
        p.faces64 ? __ldg(static_cast<const long long*>(p.faces) + at)
                  : static_cast<long long>(
                        __ldg(static_cast<const int*>(p.faces) + at));
    const float* src = p.vertices + 3 * v;
#pragma unroll
    for (int j = 0; j < 3; ++j) w[i][j] = __ldg(src + j);
  }
}

// Pass 1: one thread a setup row (and a padding row past the last)
__global__ void __launch_bounds__(kThreads)
tile_setup_kernel(const Params p) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sm_setup::sentinel_row(p.table + static_cast<size_t>(p.rows) * 4);
    p.overflow[0] = 0;
  }
  if (row >= p.rows) {
    if (row < padded_rows(p.rows)) {
      p.rects[row] = make_uint2(kNotBinnedX, 0u);
    }
    return;
  }
  float k[16];
  sm_setup::load_camera(p, k);
  float w[3][3];
  load_triangle(p, p.clip ? row >> 1 : row, w);
  Setup s;
  sm_setup::row_setup(k, w, p.clip, row, s);
  sm_setup::table_row(s, row, p.table + static_cast<size_t>(row) * 4);
  p.rects[row] = tile_rect(p, s);
}

// whether tile (tx, ty) lies in the packed rectangle (x, y)
__device__ __forceinline__ unsigned in_rect(unsigned x, unsigned y,
                                            unsigned tx, unsigned ty) {
  return (x & 0xffffu) <= tx && tx <= (x >> 16) && (y & 0xffffu) <= ty &&
         ty <= (y >> 16);
}

// Pass 2: one block a tile, its list
__global__ void __launch_bounds__(kBinThreads)
tile_bins_kernel(const Params p) {
  __shared__ int warp_sums[2][kWarps];
  const int b = blockIdx.x;
  const unsigned ty = b / p.nbx;
  const unsigned tx = b - ty * p.nbx;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint4* rects = reinterpret_cast<const uint4*>(p.rects);
  int* list = p.cand + static_cast<size_t>(b) * p.n;
  const int steps = padded_rows(p.rows) / kStep;
  uint4 r0 = make_uint4(0, 0, 0, 0), r1 = r0;
  if (steps > 0) {
    r0 = rects[2 * threadIdx.x];
    r1 = rects[2 * threadIdx.x + 1];
  }
  int listed = 0;  // rows of the tile in the steps before this one
  for (int step = 0; step < steps; ++step) {
    const int first = step * kStep + threadIdx.x * kPerThread;
    unsigned mask = in_rect(r0.x, r0.y, tx, ty) |
                    in_rect(r0.z, r0.w, tx, ty) << 1 |
                    in_rect(r1.x, r1.y, tx, ty) << 2 |
                    in_rect(r1.z, r1.w, tx, ty) << 3;
    if (step + 1 < steps) {
      const size_t at = static_cast<size_t>(step + 1) * (kStep / 2) +
                        2 * threadIdx.x;
      r0 = rects[at];
      r1 = rects[at + 1];
    }
    // the thread's first position: the matches of the threads before it
    const int c = __popc(mask);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    // two buffers: a step's writes never meet the step before's reads
    int* sums = warp_sums[step & 1];
    if (lane == 31) sums[warp] = incl;
    __syncthreads();
    int pos = listed + incl - c;
    int step_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = sums[w];
      step_total += v;
      if (w < warp) pos += v;
    }
    for (; mask != 0; mask &= mask - 1, ++pos) {
      if (pos < p.n) list[pos] = first + __ffs(mask) - 1;
    }
    listed += step_total;
  }
  const int kept = min(listed, p.n);
  for (int i = kept + threadIdx.x; i < p.n; i += kBinThreads) list[i] = p.rows;
  if (threadIdx.x == 0) {
    p.counts[b] = kept;
    if (listed > p.n) atomicAdd(p.overflow, listed - p.n);
  }
}

}  // namespace

extern "C" {

// the row multiple the rectangles are padded to (the wrapper sizes them
// with it)
int sm_tile_prep_row_align() { return kStep; }

// Pass 1 on `stream`: setup, table, rectangles, the overflow zeroed.
// Returns the launch's CUDA error (0 if none).
int sm_tile_setup(const sm_tile_prep::Params* params, void* stream) {
  const Params& p = *params;
  const int blocks = padded_rows(p.rows) / kThreads;
  tile_setup_kernel<<<blocks > 0 ? blocks : 1, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: each tile's list, its count and the overflow; launches nothing
// for an image of no tile
int sm_tile_bins(const sm_tile_prep::Params* params, void* stream) {
  const Params& p = *params;
  const long long tiles = static_cast<long long>(p.nbx) * p.nby;
  if (tiles <= 0) return 0;
  tile_bins_kernel<<<static_cast<unsigned>(tiles), kBinThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
