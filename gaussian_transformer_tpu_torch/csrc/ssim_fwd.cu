// Fused SSIM forward for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_transformer_tpu/ops/fused_ssim.py:106
// (_fwd_kernel, launched by _pallas_fwd :184). Same function: the mean
// 11x11, sigma 1.5 windowed SSIM with 'same' zero padding, C1 = 0.01^2,
// C2 = 0.03^2, over images [N, H, W] f32, written to one float.
//
// Bound. It reads each image once (8 bytes a pixel) against 240 fp32
// operations a pixel (chip_smoke.py K3_OPS_PER_PIXEL: the products, two
// 11-tap passes over five fields, the map): at 1080p it is bound by
// operations.
//
// Design. One CTA of 256 threads per (image, 32-row x 64-column output
// tile), three CTAs an SM (24 warps). cp.async stages both images' 42 x 80
// window (the 74 columns the filter needs, widened to 16-byte aligned
// copies; zeros outside the image); the vertical pass of the five fields
// runs 8 rows a thread over the window columns into a 5 x 32 x 75 buffer;
// the horizontal pass runs 8 columns a thread and takes each output in
// registers to the SSIM map (ssim_common.cuh). The fields' vertical pass
// covers 1.16x the output pixels (the 32x32 tile before: 1.31x). Each CTA
// sums its masked map in a fixed order into its partial; the last CTA to
// finish (a device counter, which that CTA resets) adds the partials in
// float64 in a fixed order, divides by N H W and writes the mean. The
// result does not depend on the order in which CTAs finish (no float
// atomics), and the wrapper launches nothing else: no host
// synchronisation, no follow-up ops. Two launches may not run at once on
// two streams of one card: they would share the counter.
//
// Build (nvcc -Xptxas -v, sm_90a): 80 registers, no spills, 74,880 bytes of
// dynamic and 48 of static shared memory, three CTAs an SM. The per-pixel
// map is the parent design's arithmetic; only the order of the sum moved.

#include <cuda_runtime.h>

#include "ssim_common.cuh"

namespace {

using namespace ssim;

constexpr int kTH = 32;                 // output tile rows
constexpr int kTW = 64;                 // output tile columns
constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;
constexpr int kIH = kTH + 2 * kHalf;    // 42: input window rows
constexpr int kIW = kTW + 2 * kHalf;    // 74: input window columns used
constexpr int kX0 = 3;                  // staged from 3 columns further left,
constexpr int kSW = kIW + 2 * kX0;      // 80 columns: 16-byte aligned copies
constexpr int kRv = 8;                  // rows a thread, vertical pass
constexpr int kRh = 8;                  // columns a thread, horizontal pass
constexpr int kG = kTW / kRh;           // 8 column groups
static_assert(kTH % kRv == 0 && kTW % kRh == 0, "whole groups");
constexpr int kPI = kSW;                                                 // windows
constexpr int kPV = odd_at_least(kG * kRh + kK - 1 > kIW ? kG * kRh + kK - 1 : kIW);  // 75
constexpr int kInF = kIH * kPI;
constexpr int kVF = 5 * kTH * kPV;
constexpr int kSmemBytes = (2 * kInF + kVF) * (int)sizeof(float);
constexpr int kWarps = kThreads / 32;

// Blocks of the current launch that have written their partial; the last
// one resets it to 0 for the next launch (launches on one stream are
// ordered).
__device__ unsigned int g_blocks_done = 0;

__global__ void __launch_bounds__(kThreads, kMinBlocks) ssim_fwd_kernel(
    const float* __restrict__ img1, const float* __restrict__ img2, int H, int W, int ld1,
    int ld2, long long ps1, long long ps2, bool vec, float* __restrict__ partials,
    float* __restrict__ mean) {
  extern __shared__ float smem[];
  float* s1 = smem;            // [kIH][kPI]
  float* s2 = s1 + kInF;       // [kIH][kPI]
  float* v = s2 + kInF;        // [5][kTH][kPV]
  __shared__ float warp_sums[kWarps];
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ox = blockIdx.x * kTW;
  const int oy = blockIdx.y * kTH;

  stage_window(s1, kPI, img1 + n * ps1, ld1, H, W, oy - kHalf, ox - kHalf - kX0, kIH, kSW, vec);
  stage_window(s2, kPI, img2 + n * ps2, ld2, H, W, oy - kHalf, ox - kHalf - kX0, kIH, kSW, vec);
  stage_wait();
  __syncthreads();

  // Vertical pass: output rows, every window column.
  for (int job = tid; job < kIW * (kTH / kRv); job += kThreads) {
    const int rg = job / kIW, c = job - rg * kIW;
    const int r0 = rg * kRv;
    float f[5][kRv];
    vpass_fields<kRv>(s1 + r0 * kPI + kX0 + c, s2 + r0 * kPI + kX0 + c, kPI, f);
#pragma unroll
    for (int i = 0; i < kRv; ++i) {
#pragma unroll
      for (int j = 0; j < 5; ++j) v[(j * kTH + r0 + i) * kPV + c] = f[j][i];
    }
  }
  __syncthreads();

  // Horizontal pass and the map; lanes run down the rows.
  float sum = 0.0f;
  if (tid < kTH * kG) {
    const int cg = tid / kTH;
    const int r = tid - cg * kTH;
    const int c0 = cg * kRh;
    float f[5][kRh];
#pragma unroll
    for (int j = 0; j < 5; ++j) pass1<kRh>(v + (j * kTH + r) * kPV + c0, 1, f[j]);
    if (oy + r < H) {
#pragma unroll
      for (int i = 0; i < kRh; ++i) {
        const float map = ssim_map(f[0][i], f[1][i], f[2][i], f[3][i], f[4][i]);
        if (ox + c0 + i < W) sum += map;
      }
    }
  }

  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = sum;
  __syncthreads();
  const unsigned int nblocks = gridDim.x * gridDim.y * gridDim.z;
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    partials[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(&g_blocks_done, 1u) == nblocks - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block: the partials in float64, each thread a fixed stride,
  // then thread 0 in thread order (the windows' buffer is free by now).
  __threadfence();
  double* dsum = reinterpret_cast<double*>(smem);
  double acc = 0.0;
  for (unsigned int i = tid; i < nblocks; i += kThreads) acc += (double)__ldcg(partials + i);
  dsum[tid] = acc;
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
    for (int t = 0; t < kThreads; ++t) total += dsum[t];
    mean[0] = (float)(total / ((double)gridDim.z * H * W));
    g_blocks_done = 0;
  }
}

}  // namespace

// img1/img2: N planes of H x W floats, unit column stride, row strides
// ld1/ld2 and plane strides ps1/ps2 (floats).
extern "C" int ssim_fwd(const void* img1, const void* img2, int N, int H, int W, int ld1, int ld2,
                        long long ps1, long long ps2, void* partials, void* mean, void* stream) {
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssim_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ssim_fwd_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    attrs_set = true;
  }
  if (N > 0 && H > 0 && W > 0) {
    const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, N);
    ssim_fwd_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        (const float*)img1, (const float*)img2, H, W, ld1, ld2, ps1, ps2,
        vec_ok(img1, img2, W, ld1, ld2, ps1, ps2), (float*)partials, (float*)mean);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
