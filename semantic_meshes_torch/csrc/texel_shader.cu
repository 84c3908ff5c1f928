// The texel shader of one view, hand-written for Hopper (sm_90a): each
// pixel's triangle id becomes the id of the texel it falls in
// (semantic_meshes_torch/render.py::_texel_prim_image, the reference's
// TexturedTriangle::getTexelIndex, TexturedTriangleRenderer.h:31-41).
//
// It replaces no TPU kernel: the JAX package shades with XLA ops
// (semantic_meshes/render.py::_texel_prim_image). The port first wrote it
// as a chain of PyTorch ops, ~175 launches and 4 host waits (one camera
// upload each) a view (render._texel_prim_image_plain). That chain stays
// as the CPU implementation and the oracle these kernels are tested
// against bit for bit on the card; the wrapper is
// semantic_meshes_torch/texel_kernel.py.
//
// What bounds it on the H100: bytes. The id image is read and the texel
// image written once (8 bytes a pixel), a table row of 48 bytes is written
// and read once a face, and the faces and vertices are read once: at
// ScanNet's 1296x968 pixels and 99372 faces ~10.0 + 9.5 + 1.8 MB, ~6 us at
// 3.35 TB/s. The chain it replaces was bound by the host's launches and
// its uploads, not by the card. So the design is two launches with every
// intermediate in registers:
// 1. texel_table_kernel, one thread a face: the face's three vertices
//    read in place (int32 or int64 faces), the nine f32 coefficients of
//    the affine forms A1, A2 and S = A0 + A1 + A2 (u = A1 / S, v = A2 / S
//    at a pixel centre), and one row of 12 int32: the coefficients' bits,
//    the resolution, the first texel index and a pad, so that a pixel
//    reads its row as three 16-byte loads. Pinhole form: A_i = w_i x inv_z_i
//    from the triangle setup; clip_near: A_i = d . (V_j x V_k) of the
//    camera-space vertices, which holds where a vertex is behind the
//    camera.
// 2. texel_shade_kernel, one thread a pixel: the id read by its strides,
//    the row gathered, the three forms at the pixel centre (y_offset
//    added), u and v, the grid cell and the texel's index inside the
//    triangle, and first + index, or the caller's `none` where the pixel
//    is empty (id < 0 or >= faces) or its face has resolution 0.
// The camera is a kernel argument, copied from the host at launch (no
// upload and no sync), or read from device memory where the caller holds
// it there (a batch's slices, the lens path's virtual focal).
//
// Rounding: every operation is the plain chain's, in its order, each
// rounded to nearest (setup_common.cuh: __fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn; the build passes -fmad=false too), the reciprocals as
// __fdiv_rn(1, x) as PyTorch's reciprocal computes them, the grid cell's
// float -> int32 conversion saturating with NaN -> 0 and the int32 sums
// wrapping, as XLA's (and the plain chain's) do. The ids are then
// bit-identical to the plain chain's on the card.

#include <cuda_runtime.h>

#include "setup_common.cuh"

namespace sm_texel {

// One view; the wrapper fills it (texel_kernel.py's _Params, field for
// field) and each launch copies it as its argument. Outside the anonymous
// namespace: the C entry points take it.
struct Params {
  float cam[16];  // rotation (9, row-major), translation 3, focal 2,
                  // principal point 2
  const float* cam_ptr[4];  // those four on the device, or null: by value
  const float* vertices;    // (V, 3)
  const void* faces;        // (faces, 3) int32 or int64
  const int* resolutions;   // (faces,)
  const int* first;         // (faces,) first texel index
  int* table;               // (faces, 12)
  const void* ids;          // (H, W) int32 or int64 triangle ids, by strides
  long long ids_s0;
  long long ids_s1;
  int* out;                 // (H, W) texel ids, row-major
  int faces_count;
  int faces64;
  int ids64;
  int clip;
  int height;
  int width;
  float y_offset;
  int none;  // the id of a pixel of no texel
};

}  // namespace sm_texel

namespace {

using sm_texel::Params;
using sm_setup::add;
using sm_setup::mul;
using sm_setup::quot;
using sm_setup::sub;

constexpr int kThreads = 256;
constexpr int kRow = 12;          // int32 lanes of a table row
constexpr float kUvEps = 1e-6f;   // geometry.TEXEL_UV_EPS

// The pinhole forms A_i = (a_i, b_i, c_i) x inv_z_i: tiles.project_vertices,
// tiles._setup_from_projected's edges (edge i is opposite vertex i) and
// reciprocal(clamp(z, Z_NEAR)), op for op
__device__ __forceinline__ void pinhole_forms(const float (&k)[16],
                                              const float (&v)[3][3],
                                              float (&aff)[3][3]) {
  float px[3], py[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) sm_setup::project(k, v[i], px[i], py[i]);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    float a, b, c;
    sm_setup::edge(px, py, e, a, b, c);
    const float iz = sm_setup::inv_depth(v[e][2]);
    aff[e][0] = mul(a, iz);
    aff[e][1] = mul(b, iz);
    aff[e][2] = mul(c, iz);
  }
}

// The camera-space ray forms A_i = d . (V_j x V_k) for the pixel ray
// d = ((x - cx) / fx, (y - cy) / fy, 1): the cross product written out,
// the focals divided truly, then c = (n2 - cx a) - cy b
__device__ __forceinline__ void ray_forms(const float (&k)[16],
                                          const float (&v)[3][3],
                                          float (&aff)[3][3]) {
  constexpr int kJ[3] = {1, 2, 0};
  constexpr int kK[3] = {2, 0, 1};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float* vj = v[kJ[e]];
    const float* vk = v[kK[e]];
    const float n0 = sub(mul(vj[1], vk[2]), mul(vj[2], vk[1]));
    const float n1 = sub(mul(vj[2], vk[0]), mul(vj[0], vk[2]));
    const float n2 = sub(mul(vj[0], vk[1]), mul(vj[1], vk[0]));
    const float a = quot(n0, k[12]);
    const float b = quot(n1, k[13]);
    aff[e][0] = a;
    aff[e][1] = b;
    aff[e][2] = sub(sub(n2, mul(k[14], a)), mul(k[15], b));
  }
}

// Pass 1: one thread a face, its table row
template <typename Face>
__global__ void __launch_bounds__(kThreads)
    texel_table_kernel(const Params p) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= p.faces_count) return;
  float k[16];
  sm_setup::load_camera(p, k);
  const Face* f =
      static_cast<const Face*>(p.faces) + 3 * static_cast<size_t>(t);
  float v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* w = p.vertices + 3 * static_cast<size_t>(__ldg(f + i));
    const float world[3] = {__ldg(w), __ldg(w + 1), __ldg(w + 2)};
    sm_setup::transform(k, world, v[i]);
  }
  float aff[3][3];
  if (p.clip)
    ray_forms(k, v, aff);
  else
    pinhole_forms(k, v, aff);
  int4 row[3];
  row[0] = make_int4(__float_as_int(aff[1][0]), __float_as_int(aff[1][1]),
                     __float_as_int(aff[1][2]), __float_as_int(aff[2][0]));
  row[1] = make_int4(__float_as_int(aff[2][1]), __float_as_int(aff[2][2]),
                     __float_as_int(add(add(aff[0][0], aff[1][0]),
                                        aff[2][0])),
                     __float_as_int(add(add(aff[0][1], aff[1][1]),
                                        aff[2][1])));
  row[2] = make_int4(__float_as_int(add(add(aff[0][2], aff[1][2]),
                                        aff[2][2])),
                     __ldg(p.resolutions + t), __ldg(p.first + t), 0);
  int4* out =
      reinterpret_cast<int4*>(p.table + kRow * static_cast<size_t>(t));
  out[0] = row[0];
  out[1] = row[1];
  out[2] = row[2];
}

// geometry._grid_cell: clip(int32(floor((x - eps) r)), 0, r - 1), with the
// plain chain's NaN -> 0 and its clamp to [-1, r] before the conversion
// (inf clamps to the same cell as nan_to_num's largest float)
__device__ __forceinline__ int grid_cell(float x, int r, float rf) {
  float f = floorf(mul(sub(x, kUvEps), rf));
  if (isnan(f)) f = 0.0f;
  f = fmaxf(fminf(f, rf), -1.0f);
  const int i = max(static_cast<int>(f), 0);
  return min(i, r - 1);
}

// Pass 2: one thread a pixel, its texel id
template <typename Id>
__global__ void __launch_bounds__(kThreads)
    texel_shade_kernel(const Params p) {
  const long long pixel =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (pixel >= static_cast<long long>(p.height) * p.width) return;
  const int y = static_cast<int>(pixel / p.width);
  const int x = static_cast<int>(pixel - static_cast<long long>(y) * p.width);
  const long long id = static_cast<long long>(__ldg(
      static_cast<const Id*>(p.ids) + y * p.ids_s0 + x * p.ids_s1));
  int result = p.none;
  if (id >= 0 && id < p.faces_count) {
    const int4* row =
        reinterpret_cast<const int4*>(p.table) + 3 * static_cast<size_t>(id);
    const int4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
    const int res = r2.y;
    if (res >= 1) {
      // tiles.pixel_centres: (row + 0.5) + y_offset, column + 0.5
      const float px = add(static_cast<float>(x), 0.5f);
      const float py = add(add(static_cast<float>(y), 0.5f), p.y_offset);
      auto form = [&](int c0, int c1, int c2) {
        return add(add(mul(__int_as_float(c0), px),
                       mul(__int_as_float(c1), py)),
                   __int_as_float(c2));
      };
      const float s = form(r1.z, r1.w, r2.x);
      const float u = quot(form(r0.x, r0.y, r0.z), s);
      const float v = quot(form(r0.w, r1.x, r1.y), s);
      // geometry.texel_index_uv
      const float rf = static_cast<float>(res);
      const int iu = grid_cell(u, res, rf);
      int iv = grid_cell(v, res, rf);
      const int kk = min(iu + iv, res - 1);
      iv = min(iv, kk);
      const unsigned tri_n = static_cast<unsigned>(kk) *
                             static_cast<unsigned>(kk + 1);
      const int rel = (static_cast<int>(tri_n) >> 1) + iv;
      result = static_cast<int>(static_cast<unsigned>(r2.z) +
                                static_cast<unsigned>(rel));
    }
  }
  p.out[pixel] = result;
}

}  // namespace

extern "C" {

// Pass 1 on `stream`: the table. Returns the launch's CUDA error (0 if
// none); launches nothing for a mesh of no face.
int sm_texel_table(const sm_texel::Params* params, void* stream) {
  const Params& p = *params;
  if (p.faces_count <= 0) return 0;
  const unsigned grid = (p.faces_count + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.faces64)
    texel_table_kernel<long long><<<grid, kThreads, 0, s>>>(p);
  else
    texel_table_kernel<int><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: the texel ids
int sm_texel_shade(const sm_texel::Params* params, void* stream) {
  const Params& p = *params;
  const long long pixels = static_cast<long long>(p.height) * p.width;
  if (pixels <= 0) return 0;
  const unsigned grid =
      static_cast<unsigned>((pixels + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.ids64)
    texel_shade_kernel<long long><<<grid, kThreads, 0, s>>>(p);
  else
    texel_shade_kernel<int><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
