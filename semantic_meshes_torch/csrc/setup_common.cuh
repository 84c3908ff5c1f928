// Device code shared by the per-view setup passes, dense_prep.cu and
// texel_shader.cu: the operations each rounded on its own, the camera
// passed by value, and the steps of the plain chain's triangle setup that
// both repeat (geometry.rigid_transform, geometry.pinhole_project,
// tiles._setup_from_projected's edges and inverse depths).
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

}  // namespace sm_setup
