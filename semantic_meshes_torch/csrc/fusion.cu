// Fusion of one view, hand-written for Hopper (sm_90a): per primitive, the
// sum of its pixels' weighted class values and its pixel count, then the
// per-view weight mix (semantic_meshes_torch/fusion.py, Mesh.h:90-103).
//
// It replaces no TPU kernel: the JAX package's segment sum
// (semantic_meshes/ops.py::segment_sum) is XLA, not Pallas. The port first
// wrote it as a chain of PyTorch ops, ~63 launches and two host waits a
// view (fusion._segment_sums_plain: the don't-care sum, the values, an
// (N, C + 1) concatenation, a stable sort of int64 keys, bincount, cumsum,
// the sorted gather and segment_reduce). That chain stays as the CPU
// implementation and the oracle these kernels are tested against on the
// card; the wrapper is semantic_meshes_torch/fusion_kernel.py.
//
// What bounds it on the H100: bytes. Each pixel's probability row is read
// once (H x W x C x 4 bytes), its id once (4 bytes), and each primitive's
// output row written once (P x C x 4): 221.6 MB at ScanNet's 1296x968 x 40
// classes and 99372 triangles, 0.066 ms at 3.35 TB/s; 171.5 MB, 0.051 ms,
// at the Cityscapes demo's 2048x1024 x 19. The chain it replaces wrote and
// read three N x (C + 1) float intermediates, and its bincount's atomics
// all met on the one key P that every background pixel takes. The design:
// 1. fusion_keys_kernel: the id image, read by its strides through a
//    32x32 shared-memory tile (so a transposed view costs no copy), becomes
//    int32 keys in row-major (H, W) order: the id where 0 <= id < P, else
//    P. The same grid fills the output with the value a primitive without
//    pixels reads (0 x the mix of one pixel). No atomics.
// 2. torch.sort(stable=True) of the keys, from the wrapper: its indices
//    are the pixel order, pixels of one primitive in row-major order, the
//    dropped ones (key P) at the end.
// 3. fusion_rows_kernel: the sorted positions are cut into chunks of
//    kChunk; one warp walks one chunk in order, lanes over classes, rows
//    loaded kAhead positions ahead and their values formed before they
//    are added. For each position it reads the pixel's
//    probability row once, forms the class sum (don't-care test) with a
//    warp reduction, the base weight and the aggregator's value, and adds
//    the value to the run's float32 sums in sorted order from +0.0, as
//    segment_reduce does. A run of one key that begins and ends inside the
//    chunk writes its output row at once, with the mix; a run that touches
//    a chunk edge writes its partial sums and count to the chunk's carry
//    slot (0: the run came in from the chunk before, 1: it goes on into
//    the next). A chunk whose first key is P returns at once.
// 4. fusion_carry_kernel: one warp a chunk edge; for each run that crosses
//    edges, the partials added in chunk order, the mix, the row.
// The chunk is short (64 positions) so that a frame whose covered pixels
// are few still fills the card with warps (on an H100 at 700 W, 64
// positions took the rows pass from 0.159 to 0.118 ms a view against 256
// at ScanNet's ring, from 0.113 to 0.064 at the Cityscapes demo), and a
// run longer than a chunk is spread over many warps. The summation order
// is fixed (row-major and sequential inside a chunk, then chunk by chunk),
// with no float atomics, so the result is bit-identical from run to run;
// a primitive whose pixels lie inside one chunk gets the plain chain's
// bits, since every operation is the chain's, in its order, each rounded
// to nearest (-fmad=false, __fdiv_rn).
// Aggregators: sum adds p w; summax keeps the first largest component (no
// winner where the row holds a NaN, as amax and == give); mul adds
// w max(log(max(p, 0)), -1e30) with full-precision logf, NaN kept. A
// pixel of weight 0 (don't-care) still adds value x 0 and counts. With
// `raw` the rows hold the sums and, in column C, the count (the sharded
// fuse sums them over ranks before its mix).

#include <cuda_runtime.h>

namespace sm_fusion {

// One view; the wrapper fills it (fusion_kernel.py's _Params, field for
// field) and each launch copies it as its argument.
struct Params {
  const void* ids;  // (H, W) int32 or int64 ids, by strides
  long long ids_s0;
  long long ids_s1;
  const float* probs;  // (H, W, C), by strides
  long long probs_s0;
  long long probs_s1;
  long long probs_s2;
  const float* weights;  // (H, W) by strides, or null: every weight 1
  long long weights_s0;
  long long weights_s1;
  int* keys;               // (H x W,) int32, row-major
  const int* sorted_keys;  // torch.sort's sorted keys
  const long long* order;  // and its permutation: row-major pixel indices
  float* out;              // (P, C) mixed, or (P, C + 1) with raw
  float* carry;            // (chunks, 2, C) partial sums
  int* carry_count;        // (chunks, 2) partial counts
  long long out_size;      // floats of out
  float fill;              // what a primitive without pixels reads
  float iew;               // images_equal_weight, rounded to float32
  float one_minus_iew;     // 1 - images_equal_weight, rounded to float32
  int height;
  int width;
  int classes;
  int primitives;  // P, the key of every dropped pixel
  int chunks;      // ceil(H x W / kChunk)
  int raw;
  int ids64;
};

}  // namespace sm_fusion

namespace {

using sm_fusion::Params;

constexpr int kChunk = 64;    // sorted positions a warp walks
constexpr int kWarps = 8;     // warps a block of the rows and carry passes
constexpr int kTile = 32;     // the keys pass's tile side
constexpr int kTileRows = 8;  // its block is kTile x kTileRows threads
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCountCap = 1 << 24;  // a float sum of ones stops at 2^24
constexpr float kNegLarge = -1e30f;  // finite stand-in for log(0)
constexpr float kDontCare = 0.5f;    // Mesh.h:98

enum { kSum = 0, kSummax = 1, kMul = 2 };

template <typename Id>
__global__ void __launch_bounds__(kTile * kTileRows)
    fusion_keys_kernel(Params p) {
  __shared__ int tile[kTile][kTile + 1];
  const Id* ids = static_cast<const Id*>(p.ids);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  // read along whichever image axis lies closer in memory
  const bool along_rows = p.ids_s1 <= p.ids_s0;
  for (int r = ty; r < kTile; r += kTileRows) {
    const int a = along_rows ? r : tx, b = along_rows ? tx : r;
    const int i = i0 + a, j = j0 + b;
    if (i < p.height && j < p.width) {
      const long long id = static_cast<long long>(
          ids[static_cast<long long>(i) * p.ids_s0 +
              static_cast<long long>(j) * p.ids_s1]);
      tile[a][b] = (id >= 0 && id < p.primitives) ? static_cast<int>(id)
                                                  : p.primitives;
    }
  }
  __syncthreads();
  for (int r = ty; r < kTile; r += kTileRows) {
    const int i = i0 + r, j = j0 + tx;
    if (i < p.height && j < p.width)
      p.keys[static_cast<long long>(i) * p.width + j] = tile[r][tx];
  }
  const long long threads = static_cast<long long>(gridDim.x) * gridDim.y *
                            (kTile * kTileRows);
  for (long long k = (static_cast<long long>(blockIdx.y) * gridDim.x +
                      blockIdx.x) * (kTile * kTileRows) + ty * kTile + tx;
       k < p.out_size; k += threads)
    p.out[k] = p.fill;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, d));
  return x;
}

// The mix of a primitive with `count` pixels, as the plain chain computes
// it: iew / max(count, 1) + (1 - iew), count a float sum of ones.
__device__ __forceinline__ float mix_of(const Params& p, int count) {
  const int n = count < kCountCap ? count : kCountCap;
  return __fadd_rn(__fdiv_rn(p.iew, static_cast<float>(n > 1 ? n : 1)),
                   p.one_minus_iew);
}

// Writes class `c`'s column of primitive `key`'s output row; lane 0 of
// class block 0 also the count column with raw.
__device__ __forceinline__ void write_class(const Params& p, int key, int c,
                                            float sum, float mix) {
  if (p.raw)
    p.out[static_cast<long long>(key) * (p.classes + 1) + c] = sum;
  else
    p.out[static_cast<long long>(key) * p.classes + c] = __fmul_rn(mix, sum);
}

__device__ __forceinline__ void write_count(const Params& p, int key,
                                            int count) {
  if (p.raw)
    p.out[static_cast<long long>(key) * (p.classes + 1) + p.classes] =
        static_cast<float>(count < kCountCap ? count : kCountCap);
}

// The class sum of a pixel's row (the don't-care test) and, for summax,
// the first class that holds the row's largest value (-1 where the row
// holds a NaN). Each lane takes classes lane, lane + 32, ... in order,
// then the warp adds the lanes' sums in butterfly order, so every class
// block of a row finds the same sum. `v` holds the lane's classes of this
// class block; with more than one class block the row is read again.
template <int AGG, int KC>
__device__ __forceinline__ void row_stats(const Params& p,
                                          const float (&v)[KC], bool whole,
                                          long long off, int lane,
                                          float& total, int& winner) {
  float s = 0.f, m = __int_as_float(0xff800000);  // -inf
  bool nan = false;
  if (whole) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if (lane + 32 * k < p.classes) {
        s = __fadd_rn(s, v[k]);
        if constexpr (AGG == kSummax) {
          nan |= isnan(v[k]);
          m = fmaxf(m, v[k]);
        }
      }
    }
  } else {
    for (int c = lane; c < p.classes; c += 32) {
      const float x = p.probs[off + c * p.probs_s2];
      s = __fadd_rn(s, x);
      if constexpr (AGG == kSummax) {
        nan |= isnan(x);
        m = fmaxf(m, x);
      }
    }
  }
  total = warp_sum(s);
  if constexpr (AGG == kSummax) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, d));
    if (__any_sync(kFull, nan)) {
      winner = -1;
      return;
    }
    int first = p.classes;
    if (whole) {
#pragma unroll
      for (int k = KC - 1; k >= 0; --k)
        if (lane + 32 * k < p.classes && v[k] == m) first = lane + 32 * k;
    } else {
      for (int c = lane; c < p.classes; c += 32)
        if (p.probs[off + c * p.probs_s2] == m) {
          first = c;
          break;
        }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      first = min(first, __shfl_xor_sync(kFull, first, d));
    winner = first;
  }
}

// The aggregator's value of class `c` of a pixel whose probability is x
// and base weight w (fusion._pixel_values).
template <int AGG>
__device__ __forceinline__ float value_of(float x, float w, int c,
                                          int winner) {
  if constexpr (AGG == kSum) {
    return __fmul_rn(x, w);
  } else if constexpr (AGG == kSummax) {
    return __fmul_rn(c == winner ? x : 0.f, w);
  } else {
    // clamp(log(clamp(x, min=0)), min=-1e30) x w, NaN kept as clamp keeps
    const float l = logf(isnan(x) ? x : fmaxf(x, 0.f));
    return __fmul_rn(isnan(l) ? l : fmaxf(l, kNegLarge), w);
  }
}

// rows loaded ahead of the one being added, by the classes a lane holds
template <int KC>
__host__ __device__ constexpr int ahead() {
  return KC <= 2 ? 8 : (KC == 4 ? 4 : 2);
}

template <int AGG, int KC>
__global__ void __launch_bounds__(kWarps * 32) fusion_rows_kernel(Params p) {
  constexpr int kAhead = ahead<KC>();
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (chunk >= p.chunks) return;
  const int P = p.primitives;
  const long long pixels = static_cast<long long>(p.height) * p.width;
  const long long c0 = static_cast<long long>(chunk) * kChunk;
  const long long c1 = c0 + kChunk < pixels ? c0 + kChunk : pixels;
  int cur = p.sorted_keys[c0];
  if (cur == P) return;
  const int cbase = blockIdx.y * 32 * KC + lane;  // the lane's first class
  const bool whole = gridDim.y == 1;
  bool head = c0 > 0 && p.sorted_keys[c0 - 1] == cur;
  float acc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = 0.f;
  int count = 0;

  // the run of `cur` ends: its row, or its chunk edge's carry slot
  auto flush = [&](bool tail) {
    if (head || tail) {
      const long long slot =
          static_cast<long long>(chunk) * 2 + (head ? 0 : 1);
#pragma unroll
      for (int k = 0; k < KC; ++k)
        if (cbase + 32 * k < p.classes)
          p.carry[slot * p.classes + cbase + 32 * k] = acc[k];
      if (blockIdx.y == 0 && lane == 0) p.carry_count[slot] = count;
      return;
    }
    const float mix = mix_of(p, count);
#pragma unroll
    for (int k = 0; k < KC; ++k)
      if (cbase + 32 * k < p.classes)
        write_class(p, cur, cbase + 32 * k, acc[k], mix);
    if (blockIdx.y == 0 && lane == 0) write_count(p, cur, count);
  };

  // each lane holds one position of the group of 32: its key and pixel,
  // the next group's fetched while this one is added
  auto fetch = [&](long long pos, int& key, int& pixel) {
    key = P;
    pixel = 0;
    if (pos < c1) {
      key = p.sorted_keys[pos];
      pixel = static_cast<int>(p.order[pos]);
    }
  };
  int next_key, next_pixel;
  fetch(c0 + lane, next_key, next_pixel);
  for (long long g = c0; g < c1; g += 32) {
    const int key = next_key;
    const int i = next_pixel / p.width, j = next_pixel - i * p.width;
    if (g + 32 < c1) fetch(g + 32 + lane, next_key, next_pixel);
    const long long off = static_cast<long long>(i) * p.probs_s0 +
                          static_cast<long long>(j) * p.probs_s1;
    const float weight =
        (p.weights == nullptr || key == P)
            ? 1.f
            : p.weights[static_cast<long long>(i) * p.weights_s0 +
                        static_cast<long long>(j) * p.weights_s1];
    for (int a = 0; a < 32; a += kAhead) {
      // kAhead rows loaded, then their values formed, independent of the
      // runs; then added in order
      float v[kAhead][KC];
      int keys[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        keys[u] = __shfl_sync(kFull, key, a + u);
        const long long o = __shfl_sync(kFull, off, a + u);
#pragma unroll
        for (int k = 0; k < KC; ++k)
          v[u][k] = (keys[u] != P && cbase + 32 * k < p.classes)
                        ? p.probs[o + (cbase + 32 * k) * p.probs_s2]
                        : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        float total;
        int winner = -1;
        row_stats<AGG, KC>(p, v[u], whole,
                           __shfl_sync(kFull, off, a + u), lane, total,
                           winner);
        const float w = __shfl_sync(kFull, weight, a + u);
        const float bw = total > kDontCare ? w : 0.f;
#pragma unroll
        for (int k = 0; k < KC; ++k)
          v[u][k] = value_of<AGG>(v[u][k], bw, cbase + 32 * k, winner);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (keys[u] != cur) {
          flush(false);
          if (keys[u] == P) return;  // the dropped pixels: the chunk ends
          head = false;
          cur = keys[u];
#pragma unroll
          for (int k = 0; k < KC; ++k) acc[k] = 0.f;
          count = 0;
        }
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[k] = __fadd_rn(acc[k], v[u][k]);
        ++count;
      }
    }
  }
  flush(c1 < pixels && p.sorted_keys[c1] == cur);
}

// One warp a chunk edge b (between chunks b - 1 and b). A run that crosses
// it and starts in chunk b - 1 is finished here: chunk b - 1's slot 1,
// then slot 0 of each chunk it runs through, added in chunk order.
__global__ void __launch_bounds__(kWarps * 32) fusion_carry_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5) + 1;
  if (b >= p.chunks) return;
  const long long edge = static_cast<long long>(b) * kChunk;
  const int key = p.sorted_keys[edge];
  if (key == p.primitives || p.sorted_keys[edge - 1] != key) return;
  if (b > 1 && p.sorted_keys[edge - kChunk - 1] == key) return;
  int last = b;
  while (last + 1 < p.chunks &&
         p.sorted_keys[static_cast<long long>(last + 1) * kChunk] == key)
    ++last;
  int count = p.carry_count[(b - 1) * 2 + 1];
  for (int c = b; c <= last; ++c) count += p.carry_count[c * 2];
  const float mix = mix_of(p, count);
  for (int cls = lane; cls < p.classes; cls += 32) {
    float sum = p.carry[(static_cast<long long>(b - 1) * 2 + 1) * p.classes +
                        cls];
    for (int c = b; c <= last; ++c)
      sum = __fadd_rn(
          sum, p.carry[static_cast<long long>(c) * 2 * p.classes + cls]);
    write_class(p, key, cls, sum, mix);
  }
  if (lane == 0) write_count(p, key, count);
}

template <int AGG, int KC>
void launch_rows(const Params& p, cudaStream_t stream) {
  const int blocks = (p.chunks + kWarps - 1) / kWarps;
  const int class_blocks = (p.classes + 32 * KC - 1) / (32 * KC);
  fusion_rows_kernel<AGG, KC>
      <<<dim3(blocks, class_blocks), kWarps * 32, 0, stream>>>(p);
}

template <int AGG>
void launch_rows_by_classes(const Params& p, cudaStream_t stream) {
  if (p.classes <= 32)
    launch_rows<AGG, 1>(p, stream);
  else if (p.classes <= 64)
    launch_rows<AGG, 2>(p, stream);
  else if (p.classes <= 128)
    launch_rows<AGG, 4>(p, stream);
  else
    launch_rows<AGG, 8>(p, stream);  // more than 256: class blocks
}

}  // namespace

extern "C" {

// positions a chunk (the wrapper sizes the carry buffers with it)
int sm_fusion_chunk() { return kChunk; }

// Pass 1 on `stream`: the keys, and the output filled. Returns the
// launch's CUDA error (0 if none).
int sm_fusion_keys(const sm_fusion::Params* params, void* stream) {
  const sm_fusion::Params& p = *params;
  const dim3 grid((p.width + kTile - 1) / kTile,
                  (p.height + kTile - 1) / kTile);
  const dim3 block(kTile, kTileRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.ids64)
    fusion_keys_kernel<long long><<<grid, block, 0, s>>>(p);
  else
    fusion_keys_kernel<int><<<grid, block, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3: the rows of runs inside a chunk and the carry slots.
// aggregator: 0 sum, 1 summax, 2 mul.
int sm_fusion_rows(const sm_fusion::Params* params, int aggregator,
                   void* stream) {
  const sm_fusion::Params& p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aggregator == kSum)
    launch_rows_by_classes<kSum>(p, s);
  else if (aggregator == kSummax)
    launch_rows_by_classes<kSummax>(p, s);
  else
    launch_rows_by_classes<kMul>(p, s);
  return static_cast<int>(cudaGetLastError());
}

// Pass 4: the rows of runs that cross chunk edges.
int sm_fusion_carry(const sm_fusion::Params* params, void* stream) {
  const sm_fusion::Params& p = *params;
  const int blocks = (p.chunks + kWarps - 1) / kWarps;
  fusion_carry_kernel<<<blocks, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
