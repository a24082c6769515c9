// Layout probe: block sums of a stream for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/layout_probe.py:47 (kernel, inside probe :46,
// launched by pl.pallas_call :51). Same function: the f32 sum of each block
// of a 2-D f32 or bf16 array; the TPU kernel wrote every block's sum into
// one cell, so it kept the last one, and this kernel writes them all
// (out[g] for block g).
//
// A block is n_seg segments of seg_vecs 16-byte vectors, seg_stride_vecs
// apart; block g starts g * block_stride_vecs vectors in. A row block of a
// row-major array is one contiguous segment; a column block of [16, N] is
// 16 segments, one per row.
//
// Design. One CTA of 256 threads per block. Each thread reads 16-byte
// vectors at a stride of 256 (a warp reads 512 contiguous bytes per load),
// widens bf16 exactly to f32 (a bf16 is the high half of an f32), and adds
// into four f32 accumulators; then the four, a warp's 32 lanes by shuffles,
// and the 8 warps' partials in order. Every sum is taken in one fixed order,
// so the result is deterministic.
//
// Bound. One f32 add per 4 (f32) or 2 (bf16) bytes read: bound by bytes.
// Every byte is read once, coalesced, with no staging copy; the loop is
// unrolled so that each thread keeps several loads in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float bf16_lo(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int u) { return __uint_as_float(u & 0xffff0000u); }

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) block_sums_kernel(
    const uint4* __restrict__ x, int n_seg, long long seg_vecs, long long seg_stride_vecs,
    long long block_stride_vecs, float* __restrict__ out) {
  __shared__ float partial[kWarps];
  const uint4* blk = x + (long long)blockIdx.x * block_stride_vecs;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int s = 0; s < n_seg; ++s) {
    const uint4* seg = blk + s * seg_stride_vecs;
#pragma unroll 8
    for (long long i = threadIdx.x; i < seg_vecs; i += kThreads) {
      const uint4 v = __ldg(seg + i);
      if (kBf16) {
        a0 += bf16_lo(v.x) + bf16_hi(v.x);
        a1 += bf16_lo(v.y) + bf16_hi(v.y);
        a2 += bf16_lo(v.z) + bf16_hi(v.z);
        a3 += bf16_lo(v.w) + bf16_hi(v.w);
      } else {
        a0 += __uint_as_float(v.x);
        a1 += __uint_as_float(v.y);
        a2 += __uint_as_float(v.z);
        a3 += __uint_as_float(v.w);
      }
    }
  }
  float v = (a0 + a1) + (a2 + a3);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += partial[w];
    out[blockIdx.x] = total;
  }
}

}  // namespace

extern "C" int block_sums(const void* x, int is_bf16, int n_blocks, int n_seg, long long seg_vecs,
                          long long seg_stride_vecs, long long block_stride_vecs, void* out,
                          void* stream) {
  if (n_blocks > 0) {
    if (is_bf16) {
      block_sums_kernel<true><<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const uint4*)x, n_seg, seg_vecs, seg_stride_vecs, block_stride_vecs, (float*)out);
    } else {
      block_sums_kernel<false><<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const uint4*)x, n_seg, seg_vecs, seg_stride_vecs, block_stride_vecs, (float*)out);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
