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
// Design. One CTA of 256 threads per (image, 32x32 output tile). The block
// loads both images' 52x52 window (a halo of 2 (K - 1) / 2 = 10 per side,
// zeros outside the image) into shared memory; computes the five fields on
// the tile extended by 5 per side (42x42: vertical pass into a 5x42x52
// buffer, then the horizontal pass), turns them into the four scaled
// cotangent maps (4x42x42), filters those back to the 32x32 tile (vertical
// pass into the reused field buffer, horizontal pass in registers) and
// combines pointwise. About 94 KB of shared memory a block, above the 48 KB
// static limit: the entry point opts in once with cudaFuncSetAttribute
// (dynamic shared memory), which leaves two blocks per SM. The TPU kernel
// walked 64-row bands with whole-width slabs in VMEM; a Hopper block holds
// far less on-chip memory, so the tile is 2-D and neighbouring blocks
// re-read and re-filter the halo (from L2).
//
// Bound. It reads each image once and writes two gradients (16 bytes per
// pixel) and does ~700 fp32 operations per output pixel (the five fields and
// their partials on the 1.72x larger extended tile, four maps filtered back,
// the combine), so at 1080p it is bound by operations. The scale g is read
// from device memory, so the launch needs no host synchronisation.

#include <cuda_runtime.h>

namespace {

constexpr int kK = 11;
constexpr int kHalf = kK / 2;
constexpr int kB = 32;               // output tile side
constexpr int kE = kB + kK - 1;      // 42: extended tile (fields, cotangents)
constexpr int kI = kB + 2 * (kK - 1);  // 52: input window
constexpr int kThreads = 256;
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);

// Shared memory layout, in floats.
constexpr int kInF = kI * kI;        // one image window
constexpr int kVF = 5 * kE * kI;     // vertical pass of the five fields
constexpr int kCotF = 4 * kE * kE;   // four cotangent maps
constexpr int kSmemBytes = (2 * kInF + kVF + kCotF) * (int)sizeof(float);
static_assert(4 * kB * kE <= kVF, "the cotangents' vertical pass reuses the field buffer");

__global__ void __launch_bounds__(kThreads) ssim_bwd_kernel(
    const float* __restrict__ img1, const float* __restrict__ img2,
    const float* __restrict__ taps_in, const float* __restrict__ g, float inv_count, int H,
    int W, float* __restrict__ d1, float* __restrict__ d2) {
  extern __shared__ float smem[];
  float* s1 = smem;               // [kI][kI]
  float* s2 = s1 + kInF;          // [kI][kI]
  float* v = s2 + kInF;           // [5][kE][kI], later [4][kB][kE]
  float* cot = v + kVF;           // [4][kE][kE]
  __shared__ float taps[kK];

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ox = blockIdx.x * kB;
  const int oy = blockIdx.y * kB;
  const size_t plane = (size_t)H * W;
  const float* a = img1 + n * plane;
  const float* b = img2 + n * plane;
  const float scale = g[0] * inv_count;  // g / (N H W)

  if (tid < kK) taps[tid] = taps_in[tid];
  for (int i = tid; i < kInF; i += kThreads) {
    const int r = i / kI, c = i % kI;
    const int gy = oy - 2 * kHalf + r, gx = ox - 2 * kHalf + c;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    s1[i] = in ? a[(size_t)gy * W + gx] : 0.0f;
    s2[i] = in ? b[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  // Vertical pass of the five fields: extended rows, every window column.
  for (int i = tid; i < kE * kI; i += kThreads) {
    const int r = i / kI, c = i % kI;
    float m1 = 0.0f, m2 = 0.0f, m11 = 0.0f, m22 = 0.0f, m12 = 0.0f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float x = s1[(r + k) * kI + c], y = s2[(r + k) * kI + c], t = taps[k];
      m1 += x * t;
      m2 += y * t;
      m11 += (x * x) * t;
      m22 += (y * y) * t;
      m12 += (x * y) * t;
    }
    v[(0 * kE + r) * kI + c] = m1;
    v[(1 * kE + r) * kI + c] = m2;
    v[(2 * kE + r) * kI + c] = m11;
    v[(3 * kE + r) * kI + c] = m22;
    v[(4 * kE + r) * kI + c] = m12;
  }
  __syncthreads();

  // Horizontal pass, the map's partials, and the scaled cotangent maps on
  // the extended tile (zero outside the image).
  for (int i = tid; i < kE * kE; i += kThreads) {
    const int r = i / kE, c = i % kE;
    float f[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float t = taps[k];
#pragma unroll
      for (int j = 0; j < 5; ++j) f[j] += v[(j * kE + r) * kI + c + k] * t;
    }
    const float mu1 = f[0], mu2 = f[1];
    const float a_ = 2.0f * mu1 * mu2 + kC1;
    const float sigma12 = f[4] - mu1 * mu2;
    const float b_ = 2.0f * sigma12 + kC2;
    const float c_ = mu1 * mu1 + mu2 * mu2 + kC1;
    const float d_ = (f[2] - mu1 * mu1) + (f[3] - mu2 * mu2) + kC2;
    const float inv_cd = 1.0f / (c_ * d_);
    const float map = a_ * b_ * inv_cd;
    const float d_m12 = 2.0f * a_ * inv_cd;
    const float d_m11 = -map / d_;
    const float common = map * (d_ - c_) * inv_cd;
    const float d_mu1 = 2.0f * mu2 * (b_ - a_) * inv_cd - 2.0f * mu1 * common;
    const float d_mu2 = 2.0f * mu1 * (b_ - a_) * inv_cd - 2.0f * mu2 * common;
    const int gy = oy - kHalf + r, gx = ox - kHalf + c;
    const float s = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? scale : 0.0f;
    cot[(0 * kE + r) * kE + c] = d_mu1 * s;
    cot[(1 * kE + r) * kE + c] = d_mu2 * s;
    cot[(2 * kE + r) * kE + c] = d_m11 * s;
    cot[(3 * kE + r) * kE + c] = d_m12 * s;
  }
  __syncthreads();

  // Vertical pass of the four cotangent maps onto the output rows.
  for (int i = tid; i < kB * kE; i += kThreads) {
    const int r = i / kE, c = i % kE;
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float t = taps[k];
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] += cot[(j * kE + r + k) * kE + c] * t;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[(j * kB + r) * kE + c] = q[j];
  }
  __syncthreads();

  // Horizontal pass and the pointwise combine.
  for (int i = tid; i < kB * kB; i += kThreads) {
    const int r = i / kB, c = i % kB;
    const int gy = oy + r, gx = ox + c;
    if (gy >= H || gx >= W) continue;
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float t = taps[k];
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] += v[(j * kB + r) * kE + c + k] * t;
    }
    const float x = s1[(r + 2 * kHalf) * kI + c + 2 * kHalf];
    const float y = s2[(r + 2 * kHalf) * kI + c + 2 * kHalf];
    const size_t o = n * plane + (size_t)gy * W + gx;
    d1[o] = q[0] + 2.0f * x * q[2] + y * q[3];
    d2[o] = q[1] + 2.0f * y * q[2] + x * q[3];
  }
}

}  // namespace

extern "C" int ssim_bwd(const void* img1, const void* img2, const void* taps, const void* g,
                        float inv_count, int N, int H, int W, void* d1, void* d2,
                        void* stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssim_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  if (N > 0 && H > 0 && W > 0) {
    const dim3 grid((W + kB - 1) / kB, (H + kB - 1) / kB, N);
    ssim_bwd_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        (const float*)img1, (const float*)img2, (const float*)taps, (const float*)g, inv_count,
        H, W, (float*)d1, (float*)d2);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
