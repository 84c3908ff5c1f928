// The dense rasterizer's preparation of one view, hand-written for Hopper
// (sm_90a): triangle setup, classification, the tile ids of the sort
// binning, the candidate table, the binning's tile ranges and overflow,
// and the micro-fragment image.
//
// It replaces no TPU kernel: the JAX package computes these steps with XLA
// ops (semantic_meshes/rasterize/dense.py and xla.py's setup), and the port
// first wrote them as a chain of PyTorch ops, ~550 small launches a view
// (semantic_meshes_torch/rasterize/dense.py::resolve_inputs_plain). That
// chain stays as the CPU implementation and the oracle these kernels are
// tested against bit for bit on the card; the wrapper is
// semantic_meshes_torch/rasterize/dense_prep.py.
//
// What bounds it on the H100. The work is small: ~100 fp32 operations and
// 36 bytes read a setup row, 64 + 20 bytes written (a table row and five
// sorted ids), and one 8-byte write a pixel for the micro image's
// background. At ScanNet's 99372 rows and 1296x968 pixels that is
// 99372 x 120 B = 11.9 MB plus 10.0 MB, ~22 MB or ~6.6 us at 3.35 TB/s
// (the stable sort's own passes come on top). The chain of PyTorch ops it
// replaces was bound by the host's launches, not by the card. So the design is fewest launches, each pass
// one thread a row with every intermediate in registers:
// 1. dense_setup_kernel: setup (camera transform, pinhole projection, the
//    near-plane clipper's piece with clip_near), classification, the five
//    tile ids, the table row, and per block of kThreads rows the count of
//    micro rows and of pairs; the grid also fills the micro image with the
//    background key.
// 2. torch.sort(stable=True) of the tile ids (from the wrapper).
// 3. dense_bins_kernel: one thread a position of the sorted ids: the ids
//    (position // 5), each tile's range start (where the sorted key steps
//    past it, as searchsorted's left side), the e_cap clamp and the
//    overflow of pairs past e_cap and of big rows past n_global.
// 4. dense_micro_kernel: one thread a row: the row's setup again (cheaper
//    than a round trip through memory), the compaction rank of a micro row
//    under a micro-row budget (the counts of the blocks before it plus a
//    ballot inside the block), and each of its micro_max^2 fragments merged
//    into the packed (z bits << 32) | id image with a 64-bit atomicMin: the
//    minimum does not depend on the order, so the image is deterministic.
//    Block 0 adds the dropped micro rows to the overflow.
// The camera is a kernel argument, copied from the host at launch (no
// upload and no sync), or read from device memory where the caller holds
// it there (the lens path's virtual focal).
//
// Rounding: every operation is the plain chain's, in its order, each
// rounded to nearest (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; the
// build passes -fmad=false too), the reciprocals as __fdiv_rn(1, x) as
// PyTorch's reciprocal computes them, every float -> int32 conversion
// saturating with NaN -> 0 and int32 sums wrapping, as XLA's (and the
// plain chain's) do. The outputs are then bit-identical to the plain
// chain's on the card.

#include <cuda_runtime.h>

namespace sm_dense_prep {

// Everything of one view; the wrapper fills it (dense_prep.py's _Params,
// field for field) and each launch copies it as its argument. Outside the
// anonymous namespace: the C entry points take it, and a type with internal
// linkage would hide them from the library's exported symbols.
struct Params {
  float cam[16];  // rotation (9, row-major), translation 3, focal 2,
                  // principal point 2
  const float* cam_ptr[4];  // those four on the device, or null: by value
  const float* face_vertices;  // (faces, 3, 3)
  const int* tri_ids;          // (rows,) ids to emit, or null: the row
  float4* table;               // (rows + 1, 16), or null: no binning
  int* tile_ids;               // (rows * 5,), or null: no binning
  unsigned* block_counts;      // (row blocks, 2): micro rows, pairs
  long long* micro_key;        // (height, width)
  const int* sorted_keys;      // torch.sort's sorted tile ids
  const long long* order;      // and its permutation
  int* sorted_ids;             // (min(e_cap, rows * 5),)
  int* starts;                 // (tiles + 2,)
  int* overflow;               // (1,)
  long long e_cap;
  long long n_global;
  int rows;  // faces, or 2 x faces with clip_near
  int clip;
  int height;
  int width;
  int nbx;
  int num_tiles;
  float y_offset;
  int y_band;     // int(y_offset)
  int micro_max;
  int split;      // rows [0, split) are uni rows (micro_split), else 0
  int cap;        // micro-row budget, or -1: every micro row emits
  int zero_budget;  // e_cap_rows == 0: no binning, overflow = every pair
};

}  // namespace sm_dense_prep

namespace {

using sm_dense_prep::Params;

constexpr int kThreads = 256;  // rows a block (the block counts' unit)
constexpr int kSpan = 5;       // tile ids a row: 4 span cells + 1 global
constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr float kZNear = 1e-6f;      // tiles.Z_NEAR
constexpr float kClipZNear = 1e-4f;  // tiles.CLIP_Z_NEAR
constexpr long long kBgKey = (0x7f800000LL << 32) | 0x7fffffffLL;
constexpr unsigned kFull = 0xffffffffu;

struct Setup {
  float a[3], b[3], c[3];
  float denom, az, bz, cz;
  float xmin, xmax, ymin, ymax;
  bool valid;
};

struct Class {
  bool micro, small, big;
  int bx0, by0, span_h, span_w;
  long long ix0, iy0;  // first covered pixel centre (int32 range)
};

// each operation rounded to nearest on its own, never contracted
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float quot(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.clamp's rule: NaN passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.amin / amax over three: NaN if any is NaN
__device__ __forceinline__ float min3(float x, float y, float z) {
  return isnan(x) || isnan(y) || isnan(z) ? __int_as_float(0x7fffffff)
                                          : fminf(fminf(x, y), z);
}
__device__ __forceinline__ float max3(float x, float y, float z) {
  return isnan(x) || isnan(y) || isnan(z) ? __int_as_float(0x7fffffff)
                                          : fmaxf(fmaxf(x, y), z);
}

// torch.sign on the card: (0 < a) - (a < 0), so NaN and -0 give 0
__device__ __forceinline__ float sign(float a) {
  return static_cast<float>((0.0f < a) - (a < 0.0f));
}

// XLA's f32 -> int32 convert of an integral value: saturating, NaN -> 0
// (dense.py's _to_i32)
__device__ __forceinline__ long long to_i32(float x) {
  if (isnan(x)) return 0;
  if (x >= 2147483648.0f) return 2147483647LL;
  if (x <= -2147483648.0f) return -2147483648LL;
  return static_cast<long long>(x);
}

__device__ __forceinline__ int wrap_i32(long long x) {
  return static_cast<int>(static_cast<unsigned>(x));
}

// The camera: by value, each group overridden by its device pointer
__device__ __forceinline__ void load_camera(const Params& p, float (&k)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) k[i] = p.cam[i];
  constexpr int kOff[5] = {0, 9, 12, 14, 16};
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (p.cam_ptr[g] != nullptr) {
#pragma unroll
      for (int i = kOff[g]; i < kOff[g + 1]; ++i)
        k[i] = __ldg(p.cam_ptr[g] + (i - kOff[g]));
    }
  }
}

// geometry.rigid_transform: ((r0 x + r1 y) + r2 z) + t, row by row
__device__ __forceinline__ void transform(const float (&k)[16],
                                          const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = add(add(add(mul(k[3 * i], v[0]), mul(k[3 * i + 1], v[1])),
                     mul(k[3 * i + 2], v[2])),
                 k[9 + i]);
  }
}

// one end of an edge cut at the clipping plane (geometry.clip_triangles_
// near's isect): x and y moved along the edge, z pinned to the plane
__device__ __forceinline__ void isect(const float* p0, const float* p1,
                                      float* out) {
  const float z0 = p0[2], z1 = p1[2];
  float t = quot(sub(kClipZNear, z0), z1 == z0 ? 1.0f : sub(z1, z0));
  t = clamp_nan(t, 0.0f, 1.0f);
  out[0] = add(p0[0], mul(t, sub(p1[0], p0[0])));
  out[1] = add(p0[1], mul(t, sub(p1[1], p0[1])));
  out[2] = kClipZNear;
}

// Piece `piece` of camera-space triangle v cut at z = kClipZNear
// (geometry.clip_triangles_near, select for select); returns its validity
__device__ __forceinline__ bool clip_piece(float (&v)[3][3], int piece) {
  const bool f0 = v[0][2] > kClipZNear;
  const bool f1 = v[1][2] > kClipZNear;
  const bool f2 = v[2][2] > kClipZNear;
  const int pattern = f0 + 2 * f1 + 4 * f2;
  const int shift = pattern == 2 || pattern == 6 ? 1
                    : pattern == 4 || pattern == 5 ? 2 : 0;
  // the vertices cyclically shifted so the in-front ones come first: a, b, c
  float q[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int src = (k + shift) % 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      q[k][j] = src == 0 ? v[0][j] : src == 1 ? v[1][j] : v[2][j];
    }
  }
  float ab[3], ac[3], bc[3];
  isect(q[0], q[1], ab);
  isect(q[0], q[2], ac);
  isect(q[1], q[2], bc);
  const int n_in = f0 + f1 + f2;
  // piece 0: the whole triangle | (a, ab, ac) | (a, b, bc); piece 1:
  // (a, bc, ac)
  const bool whole = piece == 0 && n_in == 3;
  const bool one = piece == 0 && n_in == 1;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    v[0][j] = q[0][j];
    v[1][j] = piece != 0 ? bc[j] : one ? ab[j] : q[1][j];
    v[2][j] = piece != 0 ? ac[j] : whole ? q[2][j] : one ? ac[j] : bc[j];
  }
  return piece == 0 ? n_in >= 1 : n_in == 2;
}

// tiles._setup_from_projected, op for op
__device__ __forceinline__ void setup_from(const float (&px)[3],
                                           const float (&py)[3],
                                           const float (&z)[3], Setup& s) {
  constexpr int kI[3] = {1, 2, 0};
  constexpr int kJ[3] = {2, 0, 1};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float ax = px[kI[e]], ay = py[kI[e]];
    const float bx = px[kJ[e]], by = py[kJ[e]];
    const float dy = sub(by, ay);
    s.a[e] = -dy;
    s.b[e] = sub(bx, ax);
    s.c[e] = sub(mul(dy, ax), mul(s.b[e], ay));
  }
  s.denom = add(add(add(mul(s.a[0], px[0]), mul(s.b[0], py[0])), s.c[0]),
                0.0f);  // -0 -> +0
  const float safe = s.denom == 0.0f ? 1.0f : s.denom;
  float iz[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    iz[i] = quot(1.0f, isnan(z[i]) ? z[i] : fmaxf(z[i], kZNear));
  }
  s.az = quot(add(add(mul(s.a[0], iz[0]), mul(s.a[1], iz[1])),
                 mul(s.a[2], iz[2])), safe);
  s.bz = quot(add(add(mul(s.b[0], iz[0]), mul(s.b[1], iz[1])),
                 mul(s.b[2], iz[2])), safe);
  s.cz = quot(add(add(mul(s.c[0], iz[0]), mul(s.c[1], iz[1])),
                 mul(s.c[2], iz[2])), safe);
  s.valid = z[0] > kZNear && z[1] > kZNear && z[2] > kZNear &&
            s.denom != 0.0f;
  s.xmin = min3(px[0], px[1], px[2]);
  s.xmax = max3(px[0], px[1], px[2]);
  s.ymin = min3(py[0], py[1], py[2]);
  s.ymax = max3(py[0], py[1], py[2]);
}

// Setup of setup row `row` (tiles.setup_from_face_vertices, or with
// clip_near tiles.setup_clipped: rows 2i and 2i + 1 are triangle i's
// pieces)
__device__ __forceinline__ void row_setup(const Params& p,
                                          const float (&k)[16], int row,
                                          Setup& s) {
  const int tri = p.clip ? row >> 1 : row;
  const float* fv = p.face_vertices + static_cast<size_t>(tri) * 9;
  float v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float w[3] = {__ldg(fv + 3 * i), __ldg(fv + 3 * i + 1),
                  __ldg(fv + 3 * i + 2)};
    transform(k, w, v[i]);
  }
  bool piece_valid = true;
  if (p.clip) piece_valid = clip_piece(v, row & 1);
  float px[3], py[3], z[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    px[i] = add(mul(k[12], quot(v[i][0], v[i][2])), k[14]);
    py[i] = add(mul(k[13], quot(v[i][1], v[i][2])), k[15]);
    z[i] = v[i][2];
  }
  setup_from(px, py, z, s);
  s.valid = s.valid && piece_valid;
}

// dense._classify (with _micro_pixel_range) of one row
__device__ __forceinline__ Class classify(const Params& p, const Setup& s,
                                          int row) {
  const int nby = (p.height + kTileH - 1) / kTileH;
  const float ymin = sub(s.ymin, p.y_offset);
  const float ymax = sub(s.ymax, p.y_offset);
  auto tile = [](float v, float size, int n) {
    long long t = to_i32(floorf(quot(v, size)));
    return static_cast<int>(t < 0 ? 0 : t > n - 1 ? n - 1 : t);
  };
  Class c;
  c.bx0 = tile(s.xmin, static_cast<float>(kTileW), p.nbx);
  const int bx1 = tile(s.xmax, static_cast<float>(kTileW), p.nbx);
  c.by0 = tile(ymin, static_cast<float>(kTileH), nby);
  const int by1 = tile(ymax, static_cast<float>(kTileH), nby);
  const bool onscreen = s.xmax >= 0.0f &&
                        s.xmin < static_cast<float>(p.width) &&
                        ymax >= 0.0f && ymin < static_cast<float>(p.height);
  const bool valid = s.valid && onscreen;
  c.span_h = by1 - c.by0 + 1;
  c.span_w = bx1 - c.bx0 + 1;
  c.ix0 = to_i32(ceilf(sub(s.xmin, 0.5f)));
  c.iy0 = to_i32(ceilf(sub(s.ymin, 0.5f)));
  const int nx = wrap_i32(to_i32(floorf(sub(s.xmax, 0.5f))) - c.ix0 + 1);
  const int ny = wrap_i32(to_i32(floorf(sub(s.ymax, 0.5f))) - c.iy0 + 1);
  c.micro = valid && nx <= p.micro_max && ny <= p.micro_max;
  if (row < p.split) c.micro = c.micro && nx <= 1 && ny <= 1;
  c.small = valid && !c.micro && c.span_h <= 2 && c.span_w <= 2;
  c.big = valid && !c.micro && !c.small;
  return c;
}

// Sum over the block of one value a thread (every thread calls it)
__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// Pass 1: one thread a setup row, plus the micro image's background
__global__ void __launch_bounds__(kThreads)
dense_setup_kernel(const Params p, int row_blocks) {
  __shared__ unsigned scratch[kThreads / 32];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const size_t pixels = static_cast<size_t>(p.height) * p.width;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < pixels; i += static_cast<size_t>(gridDim.x) * kThreads) {
    p.micro_key[i] = kBgKey;
  }
  if (blockIdx.x >= row_blocks) return;  // uniform in the block
  bool micro = false;
  unsigned pairs = 0;
  if (row < p.rows) {
    float k[16];
    load_camera(p, k);
    Setup s;
    row_setup(p, k, row, s);
    const Class c = classify(p, s, row);
    micro = c.micro;
    pairs = (c.small ? c.span_h * c.span_w : 0) + (c.big ? 1 : 0);
    if (p.tile_ids != nullptr) {
      // slots 0..3: the span cells of a small row; slot 4: the global
      // bucket of a big row; the sentinel tile B + 1 otherwise
      const int sentinel = p.num_tiles + 1;
      int* out = p.tile_ids + static_cast<size_t>(row) * kSpan;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int dy = q / 2, dx = q % 2;
        out[q] = c.small && dy < c.span_h && dx < c.span_w
                     ? (c.by0 + dy) * p.nbx + (c.bx0 + dx)
                     : sentinel;
      }
      out[4] = c.big ? p.num_tiles : sentinel;
    }
    if (p.table != nullptr) {
      // tile_kernel.candidate_table's row: edge forms pre-multiplied by
      // sign(area), c = -1 where invalid; the id's own bits; the plane
      const float sgn = sign(s.valid ? s.denom : 0.0f);
      const bool bad = sgn == 0.0f;
      float e[9];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        e[3 * q] = bad ? 0.0f : mul(s.a[q], sgn);
        e[3 * q + 1] = bad ? 0.0f : mul(s.b[q], sgn);
        e[3 * q + 2] = bad ? -1.0f : mul(s.c[q], sgn);
      }
      const int id = p.tri_ids != nullptr ? __ldg(p.tri_ids + row) : row;
      float4* out = p.table + static_cast<size_t>(row) * 4;
      out[0] = make_float4(e[0], e[1], e[2], e[3]);
      out[1] = make_float4(e[4], e[5], e[6], e[7]);
      out[2] = make_float4(e[8], __int_as_float(id), s.az, s.bz);
      out[3] = make_float4(s.cz, 0.0f, 0.0f, 0.0f);
    }
  }
  if (p.table != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    // the sentinel row T: never inside
    float4* out = p.table + static_cast<size_t>(p.rows) * 4;
    out[0] = make_float4(0.0f, 0.0f, -1.0f, 0.0f);
    out[1] = make_float4(0.0f, -1.0f, 0.0f, 0.0f);
    out[2] = make_float4(-1.0f, 0.0f, 0.0f, 0.0f);
    out[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const unsigned n_micro = __syncthreads_count(micro);
  const unsigned n_pairs = block_sum(pairs, scratch);
  if (threadIdx.x == 0) {
    p.block_counts[2 * blockIdx.x] = n_micro;
    p.block_counts[2 * blockIdx.x + 1] = n_pairs;
  }
}

// Pass 3: one thread a position of the sorted tile ids (and one past the
// end): the ids, the tile starts (clamped to e_cap) and the overflow
__global__ void __launch_bounds__(kThreads) dense_bins_kernel(const Params p) {
  const long long n = static_cast<long long>(p.rows) * kSpan;
  const long long pos = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (pos > n) return;
  if (pos < n && pos < p.e_cap) {
    p.sorted_ids[pos] = static_cast<int>(p.order[pos] / kSpan);
  }
  // tiles t with keys[pos - 1] < t <= keys[pos] start at pos: the first
  // position whose key is at least t (searchsorted, side="left")
  const int last = p.num_tiles + 1;
  const int prev = pos > 0 ? p.sorted_keys[pos - 1] : -1;
  const int cur = pos < n ? p.sorted_keys[pos] : last + 1;
  for (int t = prev + 1; t <= cur && t <= last; ++t) {
    p.starts[t] = static_cast<int>(pos < p.e_cap ? pos : p.e_cap);
    if (t == last) {
      // the global bucket's raw start: a binary search for the first key
      // at least B
      long long lo = 0, hi = pos;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (p.sorted_keys[mid] < p.num_tiles) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const long long end = pos < p.e_cap ? pos : p.e_cap;
      const long long beg = lo < p.e_cap ? lo : p.e_cap;
      const long long past_cap = pos > p.e_cap ? pos - p.e_cap : 0;
      const long long past_global =
          end - beg > p.n_global ? end - beg - p.n_global : 0;
      p.overflow[0] = wrap_i32(past_cap + past_global);
    }
  }
}

// Pass 4: one thread a setup row: its micro fragments into the image
__global__ void __launch_bounds__(kThreads)
dense_micro_kernel(const Params p) {
  __shared__ unsigned scratch[kThreads / 32];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row_blocks = gridDim.x;
  float k[16];
  Setup s;
  Class c;
  c.micro = false;
  if (row < p.rows) {
    load_camera(p, k);
    row_setup(p, k, row, s);
    c = classify(p, s, row);
  }
  bool emit = c.micro;
  if (p.cap >= 0) {
    // compaction (dense._compact_micro): the first `cap` micro rows in
    // ascending row order emit, the rest are dropped and counted
    unsigned before = 0;
    for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x); b += kThreads)
      before += p.block_counts[2 * b];
    before = block_sum(before, scratch);
    const unsigned ballot = __ballot_sync(kFull, c.micro);
    if (lane == 0) scratch[warp] = __popc(ballot);
    __syncthreads();
    unsigned rank = before + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += scratch[w];
    __syncthreads();
    emit = c.micro && rank < static_cast<unsigned>(p.cap);
  }
  if (blockIdx.x == 0) {
    unsigned micro_total = 0, pair_total = 0;
    for (int b = threadIdx.x; b < row_blocks; b += kThreads) {
      micro_total += p.block_counts[2 * b];
      pair_total += p.block_counts[2 * b + 1];
    }
    micro_total = block_sum(micro_total, scratch);
    pair_total = block_sum(pair_total, scratch);
    if (threadIdx.x == 0) {
      const long long dropped =
          p.cap >= 0 && micro_total > static_cast<unsigned>(p.cap)
              ? static_cast<long long>(micro_total) - p.cap
              : 0;
      const int base = p.zero_budget ? static_cast<int>(pair_total)
                                     : p.overflow[0];
      p.overflow[0] = wrap_i32(static_cast<long long>(base) + dropped);
    }
  }
  if (!emit) return;
  // dense._rasterize_micro: slot (dy, dx) tests the pixel centre
  // (ix0 + dx, iy0 + dy); a uni row (row < split) emits slot (0, 0) only
  const long long id = p.tri_ids != nullptr ? __ldg(p.tri_ids + row) : row;
  const float sgn = sign(s.denom);
  const int m = p.micro_max;
  const int slots = row < p.split ? 1 : m * m;
  for (int q = 0; q < slots; ++q) {
    const long long ix = c.ix0 + q % m;
    const long long iy = c.iy0 + q / m;
    const long long iy_local = iy - p.y_band;
    const float pxc = add(__ll2float_rn(ix), 0.5f);
    const float pyc = add(__ll2float_rn(iy), 0.5f);
    const float w0 = add(add(mul(s.a[0], pxc), mul(s.b[0], pyc)), s.c[0]);
    const float w1 = add(add(mul(s.a[1], pxc), mul(s.b[1], pyc)), s.c[1]);
    const float w2 = add(add(mul(s.a[2], pxc), mul(s.b[2], pyc)), s.c[2]);
    const bool inside = mul(w0, sgn) >= 0.0f && mul(w1, sgn) >= 0.0f &&
                        mul(w2, sgn) >= 0.0f;
    const float inv_z = add(add(mul(s.az, pxc), mul(s.bz, pyc)), s.cz);
    if (inside && inv_z > 0.0f && ix >= 0 && ix < p.width && iy_local >= 0 &&
        iy_local < p.height) {
      const long long zbits = __float_as_int(quot(1.0f, inv_z));
      atomicMin(p.micro_key + iy_local * p.width + ix, (zbits << 32) | id);
    }
  }
}

}  // namespace

extern "C" {

// rows a block of the setup and micro passes (the wrapper sizes the block
// counts with it)
int sm_dense_prep_rows_per_block() { return kThreads; }

// Pass 1 on `stream`: setup, classification, tile ids, table rows, block
// counts and the micro image's background. Returns the launch's CUDA error
// (0 if none).
int sm_dense_setup(const sm_dense_prep::Params* params, void* stream) {
  const Params& p = *params;
  int row_blocks = (p.rows + kThreads - 1) / kThreads;
  if (row_blocks < 1) row_blocks = 1;  // block 0 writes the counts of none
  const long long pixels = static_cast<long long>(p.height) * p.width;
  const long long fill_blocks = (pixels + kThreads * 16 - 1) / (kThreads * 16);
  const long long grid = row_blocks > fill_blocks ? row_blocks : fill_blocks;
  dense_setup_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p, row_blocks);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3: sorted ids, tile starts and the pairs' overflow
int sm_dense_bins(const sm_dense_prep::Params* params, void* stream) {
  const Params& p = *params;
  const long long positions = static_cast<long long>(p.rows) * kSpan + 1;
  dense_bins_kernel<<<static_cast<unsigned>((positions + kThreads - 1) /
                                            kThreads),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Pass 4: micro fragments, and the dropped micro rows added to the
// overflow (with zero_budget, the overflow is every pair plus those)
int sm_dense_micro(const sm_dense_prep::Params* params, void* stream) {
  const Params& p = *params;
  int row_blocks = (p.rows + kThreads - 1) / kThreads;
  if (row_blocks < 1) row_blocks = 1;
  dense_micro_kernel<<<row_blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
