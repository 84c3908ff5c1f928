// Device code shared by the per-view setup passes, dense_prep.cu,
// tile_prep.cu and texel_shader.cu: the operations each rounded on its
// own, the camera passed by value, and the plain chain's triangle setup
// (geometry.rigid_transform, geometry.pinhole_project, the near-plane
// clipper geometry.clip_triangles_near, tiles._setup_from_projected) and
// its candidate-table row (tile_kernel.candidate_table), which the dense
// and the tile preparation both compute a setup row at a time.
//
// Rounding: each operation is the plain chain's, in its order, rounded to
// nearest (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; never contracted
// into an FMA, and the build passes -fmad=false too), so the results are
// bit-identical to the plain chain's.

#pragma once

#include <cuda_runtime.h>

namespace sm_setup {

constexpr float kZNear = 1e-6f;  // tiles.Z_NEAR

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

// The camera of a view's Params `p` (fields `cam` and `cam_ptr`): by value,
// each group (rotation 9, translation 3, focal 2, principal point 2)
// overridden by its device pointer where the caller holds it there
template <typename Params>
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

// geometry.pinhole_project of a camera-space point: f * (x / z) + c
__device__ __forceinline__ void project(const float (&k)[16], const float* v,
                                        float& px, float& py) {
  px = add(mul(k[12], quot(v[0], v[2])), k[14]);
  py = add(mul(k[13], quot(v[1], v[2])), k[15]);
}

// tiles._setup_from_projected's edge e, the one opposite vertex e:
// w_e(x, y) = a x + b y + c, the signed area of (p_i, p_j, pixel)
__device__ __forceinline__ void edge(const float (&px)[3],
                                     const float (&py)[3], int e, float& a,
                                     float& b, float& c) {
  const int i = e == 0 ? 1 : e == 1 ? 2 : 0;
  const int j = e == 0 ? 2 : e == 1 ? 0 : 1;
  const float dy = sub(py[j], py[i]);
  a = -dy;
  b = sub(px[j], px[i]);
  c = sub(mul(dy, px[i]), mul(b, py[i]));
}

// reciprocal(clamp(z, Z_NEAR)): NaN passes the clamp, as torch.clamp's
__device__ __forceinline__ float inv_depth(float z) {
  return quot(1.0f, isnan(z) ? z : fmaxf(z, kZNear));
}

constexpr float kClipZNear = 1e-4f;  // tiles.CLIP_Z_NEAR

// One setup row: the three edge forms, twice the signed area, the
// inverse-depth plane, the bounding box and validity
struct Setup {
  float a[3], b[3], c[3];
  float denom, az, bz, cz;
  float xmin, xmax, ymin, ymax;
  bool valid;
};

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
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    sm_setup::edge(px, py, e, s.a[e], s.b[e], s.c[e]);
  }
  s.denom = add(add(add(mul(s.a[0], px[0]), mul(s.b[0], py[0])), s.c[0]),
                0.0f);  // -0 -> +0
  const float safe = s.denom == 0.0f ? 1.0f : s.denom;
  float iz[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) iz[i] = sm_setup::inv_depth(z[i]);
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

// Setup of setup row `row` of the triangle whose world-space vertices are
// `w` (tiles.setup_from_face_vertices, or with clip_near
// tiles.setup_clipped: rows 2i and 2i + 1 are triangle i's pieces)
__device__ __forceinline__ void row_setup(const float (&k)[16],
                                          const float (&w)[3][3], bool clip,
                                          int row, Setup& s) {
  float v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) sm_setup::transform(k, w[i], v[i]);
  bool piece_valid = true;
  if (clip) piece_valid = clip_piece(v, row & 1);
  float px[3], py[3], z[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sm_setup::project(k, v[i], px[i], py[i]);
    z[i] = v[i][2];
  }
  setup_from(px, py, z, s);
  s.valid = s.valid && piece_valid;
}

// tile_kernel.candidate_table's row of setup `s` with id `id`: edge forms
// pre-multiplied by sign(area), c = -1 where invalid; the id's own bits;
// the plane
__device__ __forceinline__ void table_row(const Setup& s, int id,
                                          float4* out) {
  const float sgn = sign(s.valid ? s.denom : 0.0f);
  const bool bad = sgn == 0.0f;
  float e[9];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    e[3 * q] = bad ? 0.0f : mul(s.a[q], sgn);
    e[3 * q + 1] = bad ? 0.0f : mul(s.b[q], sgn);
    e[3 * q + 2] = bad ? -1.0f : mul(s.c[q], sgn);
  }
  out[0] = make_float4(e[0], e[1], e[2], e[3]);
  out[1] = make_float4(e[4], e[5], e[6], e[7]);
  out[2] = make_float4(e[8], __int_as_float(id), s.az, s.bz);
  out[3] = make_float4(s.cz, 0.0f, 0.0f, 0.0f);
}

// The table's sentinel row T: never inside
__device__ __forceinline__ void sentinel_row(float4* out) {
  out[0] = make_float4(0.0f, 0.0f, -1.0f, 0.0f);
  out[1] = make_float4(0.0f, -1.0f, 0.0f, 0.0f);
  out[2] = make_float4(-1.0f, 0.0f, 0.0f, 0.0f);
  out[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace sm_setup
