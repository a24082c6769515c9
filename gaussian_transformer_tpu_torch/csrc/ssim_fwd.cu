// Fused SSIM forward for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_transformer_tpu/ops/fused_ssim.py:106
// (_fwd_kernel, launched by _pallas_fwd :184). Same function: the mean
// 11x11, sigma 1.5 windowed SSIM with 'same' zero padding, C1 = 0.01^2,
// C2 = 0.03^2, over images [N, H, W] f32. Each block writes one partial sum;
// the wrapper adds the partials in float64 and divides by N*H*W.
//
// Design. One CTA of 256 threads per (image, 32x32 output tile). The block
// loads both images' 42x42 halo (zeros outside the image: the 'same'
// padding) into shared memory, runs the vertical 11-tap pass over the five
// fields (mu1, mu2, E[x^2], E[y^2], E[xy]) into a 5x32x42 shared buffer,
// then the horizontal pass and the SSIM map per output pixel, masks pixels
// outside the image and reduces in the block. About 41 KB of shared memory a
// block. The TPU kernel walked 64-row bands with whole-width slabs in VMEM;
// a Hopper block holds far less on-chip memory, so the tile is 2-D and the
// halo is re-read by neighbouring blocks (from L2).
//
// Bound. It reads each image once (8 bytes per pixel of input) and does
// ~240 fp32 operations per pixel (two 11-tap passes over five fields plus
// the map), so at 1080p it is bound by operations, at tens of microseconds.
// The taps come from the wrapper: _gaussian_window(11, 1.5).sum(axis=1).

#include <cuda_runtime.h>

namespace {

constexpr int kK = 11;
constexpr int kHalf = kK / 2;
constexpr int kBX = 32;
constexpr int kBY = 32;
constexpr int kHX = kBX + kK - 1;  // 42
constexpr int kHY = kBY + kK - 1;  // 42
constexpr int kThreads = 256;
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);

__global__ void __launch_bounds__(kThreads) ssim_fwd_kernel(
    const float* __restrict__ img1, const float* __restrict__ img2,
    const float* __restrict__ taps_in, int H, int W, float* __restrict__ partials) {
  __shared__ float s1[kHY][kHX];
  __shared__ float s2[kHY][kHX];
  __shared__ float v[5][kBY][kHX];
  __shared__ float taps[kK];
  __shared__ float warp_sums[kThreads / 32];

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ox = blockIdx.x * kBX;
  const int oy = blockIdx.y * kBY;
  const float* a = img1 + (size_t)n * H * W;
  const float* b = img2 + (size_t)n * H * W;

  if (tid < kK) taps[tid] = taps_in[tid];
  for (int i = tid; i < kHY * kHX; i += kThreads) {
    const int r = i / kHX, c = i % kHX;
    const int gy = oy - kHalf + r, gx = ox - kHalf + c;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    s1[r][c] = in ? a[(size_t)gy * W + gx] : 0.0f;
    s2[r][c] = in ? b[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  // Vertical pass: rows of the output tile, every halo column.
  for (int i = tid; i < kBY * kHX; i += kThreads) {
    const int r = i / kHX, c = i % kHX;
    float m1 = 0.0f, m2 = 0.0f, m11 = 0.0f, m22 = 0.0f, m12 = 0.0f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float x = s1[r + k][c], y = s2[r + k][c], g = taps[k];
      m1 += x * g;
      m2 += y * g;
      m11 += (x * x) * g;
      m22 += (y * y) * g;
      m12 += (x * y) * g;
    }
    v[0][r][c] = m1;
    v[1][r][c] = m2;
    v[2][r][c] = m11;
    v[3][r][c] = m22;
    v[4][r][c] = m12;
  }
  __syncthreads();

  // Horizontal pass and the SSIM map (the reference's _map_partials form).
  float sum = 0.0f;
  for (int i = tid; i < kBY * kBX; i += kThreads) {
    const int r = i / kBX, c = i % kBX;
    float f[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float g = taps[k];
#pragma unroll
      for (int j = 0; j < 5; ++j) f[j] += v[j][r][c + k] * g;
    }
    const float mu1 = f[0], mu2 = f[1];
    const float a_ = 2.0f * mu1 * mu2 + kC1;
    const float sigma12 = f[4] - mu1 * mu2;
    const float b_ = 2.0f * sigma12 + kC2;
    const float c_ = mu1 * mu1 + mu2 * mu2 + kC1;
    const float d_ = (f[2] - mu1 * mu1) + (f[3] - mu2 * mu2) + kC2;
    const float map = a_ * b_ * (1.0f / (c_ * d_));
    if (oy + r < H && ox + c < W) sum += map;
  }

  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = sum;
  __syncthreads();
  if (tid < 32) {
    sum = tid < kThreads / 32 ? warp_sums[tid] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (tid == 0) {
      partials[((size_t)n * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = sum;
    }
  }
}

}  // namespace

extern "C" int ssim_fwd(const void* img1, const void* img2, const void* taps, int N, int H,
                        int W, void* partials, void* stream) {
  if (N > 0 && H > 0 && W > 0) {
    const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY, N);
    ssim_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)img1, (const float*)img2, (const float*)taps, H, W, (float*)partials);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
