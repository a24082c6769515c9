// Fused SSIM backward for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_transformer_tpu/ops/fused_ssim.py:132
// (_bwd_kernel, launched by _pallas_bwd :220). Same function: the gradients
// (d_img1, d_img2) of g * mean-SSIM (11x11, sigma 1.5, 'same' zero padding,
// C1 = 0.01^2, C2 = 0.03^2) over images [N, H, W] f32. With the five filtered
// fields mu1, mu2, m11 = E[x^2], m22 = E[y^2], m12 = E[xy], the map's
// closed-form partials (_map_partials :83) scaled by g / (N H W) on pixels
// inside the image (0 outside: the cotangent of a 'same' filter is zero
// padded), and the window being symmetric, the transposed filter is the same
// filter:
//   d_img1 = W*P_mu1 + 2 img1 W*P_m11 + img2 W*P_m12
//   d_img2 = W*P_mu2 + 2 img2 W*P_m11 + img1 W*P_m12   (P_m22 == P_m11)
//
// Bound. It reads each image once and writes two gradients (16 bytes a
// pixel) against 441 fp32 operations a pixel (chip_smoke.py
// K4_OPS_PER_PIXEL: the products, the fields' two passes, the partials, the
// four maps filtered back, the combine): at 1080p it is bound by operations.
//
// Design. One CTA of 512 threads per (image, 32-row x 64-column output
// tile), two CTAs an SM (32 warps). Phases, on ssim_common.cuh's
// register-blocked passes:
//   0. cp.async stages both images' window, 52 rows x 88 columns (a halo
//      of 10 a side, widened to 16-byte aligned copies; zeros outside the
//      image);
//   1. the vertical pass of the five fields on the tile extended by 5 a
//      side (42 rows) over the 84 window columns, 7 rows a thread;
//   2. the horizontal pass on the extended 42 x 74 tile, 7 columns a
//      thread, the map's partials and the four scaled cotangent maps;
//   3. the vertical pass of the four maps onto the 32 output rows, 8 rows
//      a thread;
//   4. their horizontal pass, 8 columns a thread, into shared memory;
//   5. the pointwise combine, lanes along the rows: the images' reads (an
//      L2 hit) and the gradients' writes are coalesced.
// Halo work: the fields on 1.52x the output pixels, their vertical pass on
// 1.72x (the 32x32 tile before: 1.72x and 2.13x). Shared memory is one
// 109,688-byte buffer reused across the phases: the windows and the
// fields' vertical pass (phases 0-2), then the cotangent maps at its end
// (2-3), their vertical pass at its start (3-4) and the filtered maps in
// the cotangents' place (4-5). The partials of phase 2 wait in registers
// until every thread has read the fields, so the cotangents may overwrite
// them.
//
// Build (nvcc -Xptxas -v, sm_90a): 64 registers, no spills, 109,688 bytes
// of dynamic shared memory, two CTAs an SM. Each output is the parent
// design's arithmetic, tap for tap: the gradients are the same bits.

#include <cuda_runtime.h>

#include "ssim_common.cuh"

namespace {

using namespace ssim;

constexpr int kTH = 32;                  // output tile rows
constexpr int kTW = 64;                  // output tile columns
constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;
constexpr int kIH = kTH + 4 * kHalf;     // 52: input window rows
constexpr int kIW = kTW + 4 * kHalf;     // 84: input window columns used
constexpr int kX0 = 2;                   // staged from 2 columns further left,
constexpr int kSW = kIW + 2 * kX0;       // 88 columns: 16-byte aligned copies
constexpr int kEH = kTH + 2 * kHalf;     // 42: extended tile (fields, cotangents)
constexpr int kEW = kTW + 2 * kHalf;     // 74
constexpr int kRv1 = 7;                  // rows a thread, fields' vertical pass
constexpr int kRh2 = 7;                  // columns a thread, fields' horizontal pass
constexpr int kRv3 = 8;                  // rows a thread, cotangents' vertical pass
constexpr int kRh4 = 8;                  // columns a thread, cotangents' horizontal pass
constexpr int kG2 = ceil_div(kEW, kRh2);             // 11 column groups (77 columns)
constexpr int kG4 = kTW / kRh4;                      // 8
static_assert(kEH % kRv1 == 0 && kTH % kRv3 == 0 && kTW % kRh4 == 0, "whole groups");

// Pitches (floats) and buffer sizes.
constexpr int kPI = kSW;                                              // windows
constexpr int kPV = odd_at_least(kG2 * kRh2 + kK - 1 > kIW ? kG2 * kRh2 + kK - 1 : kIW);  // 87
constexpr int kPC = odd_at_least(kEW);                                // 75: cotangents
constexpr int kPW = odd_at_least(kG4 * kRh4 + kK - 1 > kEW ? kG4 * kRh4 + kK - 1 : kEW);  // 75
constexpr int kPQ = odd_at_least(kTW);                               // 65: filtered maps
constexpr int kInF = kIH * kPI;          // one window
constexpr int kVF = 5 * kEH * kPV;       // the fields' vertical pass
constexpr int kCotF = 4 * kEH * kPC;     // the four cotangent maps
constexpr int kVcF = 4 * kTH * kPW;      // their vertical pass
constexpr int kSmemF = 2 * kInF + kVF;
constexpr int kCotAt = kSmemF - kCotF;   // the cotangents sit at the buffer's end,
static_assert(kVcF <= kCotAt, "their vertical pass at its start");
static_assert(4 * kTH * kPQ <= kCotF, "the filtered maps take the cotangents' place");
constexpr int kSmemBytes = kSmemF * (int)sizeof(float);

__global__ void __launch_bounds__(kThreads, kMinBlocks) ssim_bwd_kernel(
    const float* __restrict__ img1, const float* __restrict__ img2,
    const float* __restrict__ g, float inv_count, int H, int W, int ld1, int ld2, long long ps1,
    long long ps2, bool vec, float* __restrict__ d1, float* __restrict__ d2) {
  extern __shared__ float smem[];
  float* s1 = smem;                // [kIH][kPI]
  float* s2 = s1 + kInF;           // [kIH][kPI]
  float* v = s2 + kInF;            // [5][kEH][kPV]
  float* cot = smem + kCotAt;      // [4][kEH][kPC], after phase 2's reads
  float* vc = smem;                // [4][kTH][kPW], after phase 1's reads
  float* qs = cot;                 // [4][kTH][kPQ], after phase 3's reads

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ox = blockIdx.x * kTW;
  const int oy = blockIdx.y * kTH;
  const size_t plane = (size_t)H * W;
  const float* a = img1 + n * ps1;
  const float* b = img2 + n * ps2;

  stage_window(s1, kPI, a, ld1, H, W, oy - 2 * kHalf, ox - 2 * kHalf - kX0, kIH, kSW, vec);
  stage_window(s2, kPI, b, ld2, H, W, oy - 2 * kHalf, ox - 2 * kHalf - kX0, kIH, kSW, vec);
  const float scale = g[0] * inv_count;  // g / (N H W), read while the copies fly
  stage_wait();
  __syncthreads();

  // 1. Vertical pass of the five fields: extended rows, every window column.
  for (int job = tid; job < kIW * (kEH / kRv1); job += kThreads) {
    const int rg = job / kIW, c = job - rg * kIW;
    const int r0 = rg * kRv1;
    float f[5][kRv1];
    vpass_fields<kRv1>(s1 + r0 * kPI + kX0 + c, s2 + r0 * kPI + kX0 + c, kPI, f);
#pragma unroll
    for (int i = 0; i < kRv1; ++i) {
#pragma unroll
      for (int j = 0; j < 5; ++j) v[(j * kEH + r0 + i) * kPV + c] = f[j][i];
    }
  }
  __syncthreads();

  // 2. Horizontal pass on the extended tile, the map's partials and the
  // scaled cotangent maps (zero outside the image). A job is one extended
  // row and kRh2 columns; lanes run down the rows.
  constexpr int kJobs2 = kEH * kG2;
  static_assert(kJobs2 <= kThreads, "one job a thread: the fields wait in registers");
  float p[4][kRh2];
  int e = 0, c0 = 0;
  const bool has2 = tid < kJobs2;
  if (has2) {
    const int cg = tid / kEH;
    e = tid - cg * kEH;
    c0 = cg * kRh2;
    float f[5][kRh2];
#pragma unroll
    for (int j = 0; j < 5; ++j) pass1<kRh2>(v + (j * kEH + e) * kPV + c0, 1, f[j]);
    const int gy = oy - kHalf + e;
    const bool row_in = gy >= 0 && gy < H;
#pragma unroll
    for (int i = 0; i < kRh2; ++i) {
      float q[4];
      map_partials(f[0][i], f[1][i], f[2][i], f[3][i], f[4][i], q);
      const int gx = ox - kHalf + c0 + i;
      const float s = (row_in && gx >= 0 && gx < W) ? scale : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j][i] = q[j] * s;
    }
  }
  __syncthreads();  // every read of the fields' buffer is done
  if (has2) {
#pragma unroll
    for (int i = 0; i < kRh2; ++i) {
      if (c0 + i < kEW) {
#pragma unroll
        for (int j = 0; j < 4; ++j) cot[(j * kEH + e) * kPC + c0 + i] = p[j][i];
      }
    }
  }
  __syncthreads();

  // 3. Vertical pass of the four cotangent maps onto the output rows.
  for (int job = tid; job < kEW * (kTH / kRv3); job += kThreads) {
    const int rg = job / kEW, c = job - rg * kEW;
    const int r0 = rg * kRv3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float q[kRv3];
      pass1<kRv3>(cot + (j * kEH + r0) * kPC + c, kPC, q);
#pragma unroll
      for (int i = 0; i < kRv3; ++i) vc[(j * kTH + r0 + i) * kPW + c] = q[i];
    }
  }
  __syncthreads();

  // 4. Horizontal pass of the four maps; lanes run down the rows.
  if (tid < kTH * kG4) {
    const int cg = tid / kTH;
    const int r = tid - cg * kTH;
    const int cc = cg * kRh4;
    if (oy + r < H) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float q[kRh4];
        pass1<kRh4>(vc + (j * kTH + r) * kPW + cc, 1, q);
#pragma unroll
        for (int i = 0; i < kRh4; ++i) qs[(j * kTH + r) * kPQ + cc + i] = q[i];
      }
    }
  }
  __syncthreads();

  // 5. The pointwise combine; lanes run along the rows, so the images'
  // reads and the gradients' writes are coalesced.
  for (int px = tid; px < kTH * kTW; px += kThreads) {
    const int r = px / kTW, c = px - r * kTW;
    const int gy = oy + r, gx = ox + c;
    if (gy < H && gx < W) {
      const float q0 = qs[(0 * kTH + r) * kPQ + c], q1 = qs[(1 * kTH + r) * kPQ + c];
      const float q2 = qs[(2 * kTH + r) * kPQ + c], q3 = qs[(3 * kTH + r) * kPQ + c];
      const size_t o = n * plane + (size_t)gy * W + gx;
      const float x = __ldg(a + (size_t)gy * ld1 + gx);
      const float y = __ldg(b + (size_t)gy * ld2 + gx);
      d1[o] = q0 + 2.0f * x * q2 + y * q3;
      d2[o] = q1 + 2.0f * y * q2 + x * q3;
    }
  }
}

}  // namespace

// img1/img2: N planes of H x W floats, unit column stride, row strides
// ld1/ld2 and plane strides ps1/ps2 (floats); d1/d2: contiguous [N, H, W].
extern "C" int ssim_bwd(const void* img1, const void* img2, const void* g, float inv_count, int N,
                        int H, int W, int ld1, int ld2, long long ps1, long long ps2, void* d1,
                        void* d2, void* stream) {
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssim_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ssim_bwd_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    attrs_set = true;
  }
  if (N > 0 && H > 0 && W > 0) {
    const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, N);
    ssim_bwd_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        (const float*)img1, (const float*)img2, (const float*)g, inv_count, H, W, ld1, ld2, ps1,
        ps2, vec_ok(img1, img2, W, ld1, ld2, ps1, ps2), (float*)d1, (float*)d2);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
