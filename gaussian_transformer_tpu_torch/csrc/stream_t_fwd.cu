// Transposed-layout stream compositor forward for Hopper (sm_90a).
//
// Replaces the TPU kernel attic/stream_t.py:134 (_fwd_kernel_t, launched by
// _run_fwd_t :372). Same function as K1 (stream_fwd.cu): walk each 16x16
// tile's depth-ordered run of the padded-CSR instance stream front to back
// and composite per pixel with the upstream rasterizer's rules:
//   alpha = min(0.99, opacity * exp(min(power, 0)))
//   skip where power > 0 or alpha < 1/255
//   stop BEFORE the contribution that would take T below 1e-4
// on the stream stored as planes, props_t [16, I_pad] (plane j of row r at
// props_t[j * ld + r]), with ABSOLUTE means evaluated at absolute pixel
// centers, as the reference's _pixel_coords_cols / _alpha_math_t do.
// Outputs the pre-background color [T, 3, 256] and final transmittance
// [T, 256] of every tile.
//
// Design. K1's geometry: one CTA of 256 threads per tile, one thread per
// pixel, each tile over its own row range [chunk_start[t], chunk_end[t]) *
// chunk (searchsorted over the non-decreasing chunk->tile map by the
// wrapper), nothing carried between blocks, a block-wide exit through
// __syncthreads_count once all 256 pixels have terminated. The TPU kernel
// put instances on lanes and scanned T along them; here each thread walks
// its pixel's rows sequentially. The layout's use on this card: a batch of
// 256 rows is staged by reading only the 9 planes the walk needs (x, y,
// conic a, b, c, r, g, b, opacity), each plane a coalesced 1 KB run
// (thread p reads row base + p of every plane), 36 bytes a row where K1
// stages all 64 of a row. The staged rows are laid out 12 floats apart in
// shared memory, so the walk reads each row as three float4 broadcasts, as
// K1 does.
//
// Bound. As K1: per walked (row, pixel) pair ~14 fp32 operations plus one
// expf, ~6 more where the row contributes, on 36 bytes per row shared by
// 256 pixels, so it is bound by operations. The early exit keeps the pair
// count down.
//
// The per-pair arithmetic is stream_common.cuh's, shared with the backward
// (stream_t_bwd.cu), which must replay this walk bit for bit.

#include <cuda_runtime.h>

#include "stream_common.cuh"

namespace {

using namespace stream_common;

constexpr int kBatch = kPixels;  // rows staged per pass: one per thread (12 KB)

__global__ void __launch_bounds__(kPixels) stream_t_fwd_kernel(
    const float* __restrict__ props_t, const int* __restrict__ chunk_start,
    const int* __restrict__ chunk_end, long long ld, int chunk, int grid_w,
    float* __restrict__ color, float* __restrict__ final_t) {
  __shared__ float4 rows[kBatch * kPlaneRowV];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)((t % grid_w) * kTile + p % kTile);
  const float py = (float)((t / grid_w) * kTile + p / kTile);
  const long long r0 = (long long)chunk_start[t] * chunk;
  const long long r1 = (long long)chunk_end[t] * chunk;

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int done = 0;
  for (long long base = r0; base < r1; base += kBatch) {
    const int n = (int)min((long long)kBatch, r1 - base);
    __syncthreads();  // the previous batch is fully consumed
    if (p < n) stage_planes(props_t, ld, base + p, (float*)rows + p * kPlaneRowF);
    __syncthreads();
    if (!done) {
      for (int k = 0; k < n; ++k) {
        const float4 v0 = rows[k * kPlaneRowV];      // x, y, a, b
        const float4 v1 = rows[k * kPlaneRowV + 1];  // c, r, g, b
        const float opac = rows[k * kPlaneRowV + 2].x;
        const float power = splat_power(v0.x, v0.y, v0.z, v0.w, v1.x, px, py);
        const float alpha = fminf(kAlphaCap, splat_alpha_raw(opac, power));
        if (splat_skipped(power, alpha)) continue;
        const float test_t = next_t(T, alpha);
        if (test_t < kMinT) {
          done = 1;
          break;
        }
        const float w = alpha * T;
        c0 += v1.y * w;
        c1 += v1.z * w;
        c2 += v1.w * w;
        T = test_t;
      }
    }
    if (__syncthreads_count(done) == kPixels) break;
  }
  float* out = color + (size_t)t * 3 * kPixels;
  out[p] = c0;
  out[kPixels + p] = c1;
  out[2 * kPixels + p] = c2;
  final_t[(size_t)t * kPixels + p] = T;
}

}  // namespace

extern "C" int stream_t_fwd(const void* props_t, const void* chunk_start, const void* chunk_end,
                            long long ld, int chunk, int grid_w, int n_tiles, void* color,
                            void* final_t, void* stream) {
  if (n_tiles > 0) {
    stream_t_fwd_kernel<<<n_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (const float*)props_t, (const int*)chunk_start, (const int*)chunk_end, ld, chunk, grid_w,
        (float*)color, (float*)final_t);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
