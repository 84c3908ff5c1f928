// Device code shared by the two z-resolve kernels, raster_tile.cu and
// raster_dense.cu: cp.async helpers, the exact per-warp corner cull, and
// the test of one candidate at a thread's pixels.
//
// Why the cull is exact. Each form is computed as fl(fl(fl(a*px) +
// fl(b*py)) + c), every op rounded to nearest. Rounding is monotone on
// the extended reals, so x -> fl(a*x) is non-decreasing for a >= 0
// (including -0) and non-increasing for a < 0, and fl(u + v) is
// non-decreasing in u and in v. Hence, over a warp's pixel centres (a
// product of its columns' px and its rows' py, each increasing with the
// pixel index since fl is monotone), the form at a pixel where it is not
// NaN is at most its value at the corner (px_hi if a >= 0 else px_lo,
// py_hi if b >= 0 else py_lo), computed in the same op order: where u and
// v are bounded by the corner's u_c, v_c and u + v is defined, so is
// u_c + v_c or the corner is NaN. So if the corner's w < 0 (false for
// NaN), no pixel of the warp has w >= 0 and the warp skips the candidate;
// a NaN corner never culls. inf is an ordinary extended value here; inf *
// 0 can only arise at py = 0 (px >= 0.5 always; py >= 0.5 when y_offset
// >= 0) and gives a NaN pixel that fails anyway; ±0 compare equal and
// give equal sums. The same holds for the inverse-depth plane against a
// lower bound of the warp's buffer (its minimum, taken per batch of 32:
// the buffer only grows, and the test is a strict >): if the corner's
// inv_z <= that minimum, no pixel can take the candidate.
//
// Rounding: each form is (p0*px + p1*py) + p2 with __fmul_rn/__fadd_rn (no
// contraction into FMA; the build also passes -fmad=false), and the depth
// is the correctly rounded __fdiv_rn(1, inv_z). Ids and depths are then
// bit-identical to the plain versions.

#pragma once

#include <cuda_runtime.h>

namespace sm_raster {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes global -> shared
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// waits until at most `n` of this thread's committed groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// (a*px + b*py) + c at the corner of [pxl, pxh] x [pyl, pyh] where it is
// largest (see the note above), in the per-pixel test's op order.
__device__ __forceinline__ float corner_max(float a, float b, float c,
                                            float pxl, float pxh, float pyl,
                                            float pyh) {
  const float px = a >= 0.0f ? pxh : pxl;
  const float py = b >= 0.0f ? pyh : pyl;
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// A candidate's 64-byte table row, read from shared memory: lanes
// q0 = (a0, b0, c0, a1), q1 = (b1, c1, a2, b2), q2 = (c2, id, az, bz),
// q3 = (cz, 0, 0, 0).
struct Row {
  float4 q0, q1, q2;
  float q3x;
};

__device__ __forceinline__ Row load_row(const float4* rows, int c) {
  return Row{rows[c * 4 + 0], rows[c * 4 + 1], rows[c * 4 + 2],
             rows[c * 4 + 3].x};
}

// The smallest inv_z in a warp's buffer (every lane's rows), in every lane.
template <int kRows>
__device__ __forceinline__ float warp_min(const float (&invz)[kRows]) {
  float lo = invz[0];
#pragma unroll
  for (int k = 1; k < kRows; ++k) lo = fminf(lo, invz[k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
  return lo;
}

// False only where the corner rule proves that candidate q passes at no
// pixel centre of [pxl, pxh] x [pyl, pyh] whose buffer is at least lo.
__device__ __forceinline__ bool may_pass(const Row& q, float pxl, float pxh,
                                         float pyl, float pyh, float lo) {
  return !(corner_max(q.q0.x, q.q0.y, q.q0.z, pxl, pxh, pyl, pyh) < 0.0f) &&
         !(corner_max(q.q0.w, q.q1.x, q.q1.y, pxl, pxh, pyl, pyh) < 0.0f) &&
         !(corner_max(q.q1.z, q.q1.w, q.q2.x, pxl, pxh, pyl, pyh) < 0.0f) &&
         !(corner_max(q.q2.z, q.q2.w, q.q3x, pxl, pxh, pyl, pyh) <= lo);
}

// Candidate q at a thread's pixels (column centre px, row centres py[k]):
// where it is inside (every w_i >= 0) and nearer (inv_z > invz[k], strict,
// so the earlier candidate keeps a tie), it takes the pixel: invz[k] and
// win[k] = value. Each x term is computed once for the column.
template <int kRows>
__device__ __forceinline__ void test_pixels(const Row& q, float px,
                                            const float (&py)[kRows],
                                            float (&invz)[kRows],
                                            int (&win)[kRows], int value) {
  const float ax0 = __fmul_rn(q.q0.x, px);
  const float ax1 = __fmul_rn(q.q0.w, px);
  const float ax2 = __fmul_rn(q.q1.z, px);
  const float axz = __fmul_rn(q.q2.z, px);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const float w0 = __fadd_rn(__fadd_rn(ax0, __fmul_rn(q.q0.y, py[k])),
                               q.q0.z);
    const float w1 = __fadd_rn(__fadd_rn(ax1, __fmul_rn(q.q1.x, py[k])),
                               q.q1.y);
    const float w2 = __fadd_rn(__fadd_rn(ax2, __fmul_rn(q.q1.w, py[k])),
                               q.q2.x);
    const float iz = __fadd_rn(__fadd_rn(axz, __fmul_rn(q.q2.w, py[k])),
                               q.q3x);
    const bool ok = (w0 >= 0.0f) & (w1 >= 0.0f) & (w2 >= 0.0f) &
                    (iz > invz[k]);
    invz[k] = ok ? iz : invz[k];
    win[k] = ok ? value : win[k];
  }
}

}  // namespace sm_raster
