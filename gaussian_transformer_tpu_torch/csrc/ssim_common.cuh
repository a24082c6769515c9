// Shared pieces of the fused SSIM kernels K3 (ssim_fwd.cu) and K4
// (ssim_bwd.cu) for Hopper (sm_90a): the 11 taps, the register-blocked
// separable 11-tap passes, the window staging, and the SSIM map and its
// partials.
//
// Register blocking. A pass makes R consecutive outputs (down a column for
// the vertical pass, along a row for the horizontal one) from the R + 10
// values it loads once from shared memory; each loaded value forms its
// products (x^2, y^2, xy) once and feeds every output whose window holds
// it. Each output still sums its taps in ascending order, one fmaf a tap,
// from 0: the arithmetic of a plain per-output loop, so the outputs keep
// their bits. R = 7 or 8 gives 17 / 77 or 18 / 88 shared loads per FMA
// (0.22 or 0.20), under the quarter at which the SM's shared-memory pipe
// (one 32-lane load a clock) keeps up with its four 32-lane FMAs a clock.
// The loops are unrolled whole: no index arithmetic inside them.
//
// Bank conflicts. A vertical pass maps lanes along a row (consecutive
// columns: consecutive banks). A horizontal pass maps lanes down a column
// of jobs (consecutive rows) and reads buffers whose pitch is odd, so the
// 32 lanes' addresses fall in 32 banks.

#pragma once

#include <cuda_runtime.h>

namespace ssim {

constexpr int kK = 11;
constexpr int kHalf = kK / 2;
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);

// The taps gaussian_window(11, 1.5).sum(axis=1) as float32 (ops/fused_ssim.py
// ``taps()``; tests/test_torch_ssim.py holds these literals to it bit for
// bit). They are compile-time constants, so no launch uploads them.
__host__ __device__ constexpr float tap(int k) {
  return (k == 0 || k == 10) ? 0x1.0d956ep-10f
       : (k == 1 || k == 9)  ? 0x1.f1fe06p-8f
       : (k == 2 || k == 8)  ? 0x1.26eb1ap-5f
       : (k == 3 || k == 7)  ? 0x1.bff104p-4f
       : (k == 4 || k == 6)  ? 0x1.b43c40p-3f
       :                       0x1.106562p-2f;
}

// The least odd number >= n: the pitch of a buffer a horizontal pass reads.
constexpr int odd_at_least(int n) { return n | 1; }

constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Copies rows [gy0, gy0 + rows) x columns [gx0, gx0 + cols) of the [H, W]
// plane ``src`` (row stride ``ld`` floats) into ``dst`` (row pitch
// ``pitch``) with cp.async, zeros outside the plane (the 'same' padding:
// cp.async with a source size of 0 fills zeros). gx0, cols and pitch are
// multiples of 4 and ``dst`` is 16-byte aligned. With ``vec`` (vec_ok) each
// copy moves 16 bytes, which lie all inside the plane or all outside it;
// else 4. Warps take rows, lanes columns. The caller waits with
// stage_wait() and a __syncthreads().
__device__ __forceinline__ void stage_window(float* dst, int pitch, const float* __restrict__ src,
                                             int ld, int H, int W, int gy0, int gx0, int rows,
                                             int cols, bool vec) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarps) {
    const int gy = gy0 + r;
    const bool row_in = gy >= 0 && gy < H;
    const float* row = src + (size_t)(row_in ? gy : 0) * ld;
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + r * pitch);
    if (vec) {
      for (int c = 4 * lane; c < cols; c += 128) {
        const int gx = gx0 + c;
        const bool in = row_in && gx >= 0 && gx < W;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s + 4 * c),
                     "l"(in ? row + gx : src), "r"(in ? 16 : 0));
      }
    } else {
      for (int c = lane; c < cols; c += 32) {
        const int gx = gx0 + c;
        const bool in = row_in && gx >= 0 && gx < W;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s + 4 * c),
                     "l"(in ? row + gx : src), "r"(in ? 4 : 0));
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Whether stage_window may copy 16 bytes at a time from the planes of two
// images (bases a, b; row strides lda, ldb; plane strides psa, psb, in
// floats): W, the strides and the bases all keep 16-byte alignment.
inline bool vec_ok(const void* a, const void* b, int W, int lda, int ldb,
                                       long long psa, long long psb) {
  const unsigned long long bits = (unsigned long long)a | (unsigned long long)b;
  return ((bits & 15) | ((W | lda | ldb) & 3) | ((psa | psb) & 3)) == 0;
}

__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Vertical pass of the five fields (mu1, mu2, E[x^2], E[y^2], E[xy]) at R
// consecutive rows of one column: x[m * pitch], y[m * pitch] for m in
// [0, R + 10) are the column's inputs from the first output row's window top.
template <int R>
__device__ __forceinline__ void vpass_fields(const float* x, const float* y, int pitch,
                                             float (&f)[5][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < 5; ++j) f[j][i] = 0.0f;
  }
#pragma unroll
  for (int m = 0; m < R + kK - 1; ++m) {
    const float a = x[m * pitch], b = y[m * pitch];
    const float aa = a * a, bb = b * b, ab = a * b;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = m - i;
      if (k >= 0 && k < kK) {
        f[0][i] = fmaf(a, tap(k), f[0][i]);
        f[1][i] = fmaf(b, tap(k), f[1][i]);
        f[2][i] = fmaf(aa, tap(k), f[2][i]);
        f[3][i] = fmaf(bb, tap(k), f[3][i]);
        f[4][i] = fmaf(ab, tap(k), f[4][i]);
      }
    }
  }
}

// One 11-tap pass of one map at R consecutive outputs: v[m * stride] for m
// in [0, R + 10) are the inputs from the first output's window start
// (stride 1 along a row, the pitch down a column).
template <int R>
__device__ __forceinline__ void pass1(const float* v, int stride, float (&out)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) out[i] = 0.0f;
#pragma unroll
  for (int m = 0; m < R + kK - 1; ++m) {
    const float a = v[m * stride];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = m - i;
      if (k >= 0 && k < kK) out[i] = fmaf(a, tap(k), out[i]);
    }
  }
}

// The SSIM map from the five filtered fields (the reference's
// ``_map_partials`` form, map only).
__device__ __forceinline__ float ssim_map(float mu1, float mu2, float m11, float m22,
                                          float m12) {
  const float a_ = 2.0f * mu1 * mu2 + kC1;
  const float sigma12 = m12 - mu1 * mu2;
  const float b_ = 2.0f * sigma12 + kC2;
  const float c_ = mu1 * mu1 + mu2 * mu2 + kC1;
  const float d_ = (m11 - mu1 * mu1) + (m22 - mu2 * mu2) + kC2;
  return a_ * b_ * (1.0f / (c_ * d_));
}

// The map's partials w.r.t. the fields (the reference's ``_map_partials``):
// p = (d_mu1, d_mu2, d_m11, d_m12); d_m22 == d_m11.
__device__ __forceinline__ void map_partials(float mu1, float mu2, float m11, float m22,
                                             float m12, float (&p)[4]) {
  const float a_ = 2.0f * mu1 * mu2 + kC1;
  const float sigma12 = m12 - mu1 * mu2;
  const float b_ = 2.0f * sigma12 + kC2;
  const float c_ = mu1 * mu1 + mu2 * mu2 + kC1;
  const float d_ = (m11 - mu1 * mu1) + (m22 - mu2 * mu2) + kC2;
  const float inv_cd = 1.0f / (c_ * d_);
  const float map = a_ * b_ * inv_cd;
  const float d_m12 = 2.0f * a_ * inv_cd;
  const float d_m11 = -map / d_;
  const float common = map * (d_ - c_) * inv_cd;
  p[0] = 2.0f * mu2 * (b_ - a_) * inv_cd - 2.0f * mu1 * common;
  p[1] = 2.0f * mu1 * (b_ - a_) * inv_cd - 2.0f * mu2 * common;
  p[2] = d_m11;
  p[3] = d_m12;
}

}  // namespace ssim
