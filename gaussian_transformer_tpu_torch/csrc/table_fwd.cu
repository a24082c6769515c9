// Table compositor forward for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_transformer_tpu/render/pallas_composite.py:187
// (_fwd_kernel, launched by _fwd :397). Same function: for each 16x16 tile t,
// walk the rows of its [K, 16] slab of the property table front to back and
// composite every pixel with the upstream rasterizer's rules:
//   alpha = min(0.99, opacity * exp(min(power, 0)))
//   skip where power > 0 or alpha < 1/255
//   stop BEFORE the contribution that would take T below 1e-4
// The walk covers counts[t] rounded up to a chunk of 32 rows (at most K), as
// the reference's chunked loop does; rows past counts[t] are the all-zero
// sentinel and never contribute. Outputs the pre-background color
// [T, 3, 256] and final transmittance [T, 256] (the background blend stays
// in PyTorch).
//
// Design. K1's (stream_fwd.cu): one CTA of 256 threads per tile, one thread
// per pixel. The TPU kernel ran 8 tiles per program to amortize grid steps
// and walked 32-row chunks with Hillis-Steele scans across them; here a tile
// is a block, so each thread walks its pixel's rows sequentially. Rows are
// staged 256 at a time in shared memory with coalesced 16-byte loads, and
// every thread then reads the same row (a broadcast, no bank conflicts). A
// block leaves as soon as __syncthreads_count says all 256 pixels have
// terminated. The means in the table and the pixel centers are ABSOLUTE
// screen coordinates, as the reference evaluates them.
//
// Bound. As K1: per walked (row, pixel) pair ~14 fp32 operations plus one
// expf, ~6 more where the row contributes, on 36 useful bytes per row shared
// by 256 pixels, so it is bound by operations.
// The table pads every tile to K rows; only the walked rows are read.
//
// The per-pair arithmetic lives in stream_common.cuh, shared with the
// backward (table_bwd.cu), which must replay this walk bit for bit.

#include <cuda_runtime.h>

#include "stream_common.cuh"

namespace {

using namespace stream_common;

constexpr int kBatch = 256;  // rows staged per pass (16 KB)

__global__ void __launch_bounds__(kPixels) table_fwd_kernel(
    const float4* __restrict__ props, const int* __restrict__ counts, int K, int grid_w,
    float* __restrict__ color, float* __restrict__ final_t) {
  __shared__ float4 rows[kBatch * kRowV];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)((t % grid_w) * kTile + p % kTile);
  const float py = (float)((t / grid_w) * kTile + p / kTile);
  const int n_rows = walked_rows(counts[t], K);
  const float4* tile_rows = props + (size_t)t * K * kRowV;

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int done = 0;
  for (int base = 0; base < n_rows; base += kBatch) {
    const int n = min(kBatch, n_rows - base);
    __syncthreads();  // the previous batch is fully consumed
    const float4* src = tile_rows + (size_t)base * kRowV;
    for (int i = p; i < n * kRowV; i += kPixels) rows[i] = src[i];
    __syncthreads();
    if (!done) {
      for (int k = 0; k < n; ++k) {
        const float4 v0 = rows[k * kRowV];      // x, y, a, b
        const float4 v1 = rows[k * kRowV + 1];  // c, r, g, b
        const float opac = rows[k * kRowV + 2].x;
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

extern "C" int table_fwd(const void* props, const void* counts, int K, int grid_w, int n_tiles,
                         void* color, void* final_t, void* stream) {
  if (n_tiles > 0) {
    table_fwd_kernel<<<n_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (const float4*)props, (const int*)counts, K, grid_w, (float*)color, (float*)final_t);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
