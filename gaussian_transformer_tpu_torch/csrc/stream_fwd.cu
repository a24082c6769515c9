// Stream compositor forward for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_transformer_tpu/render/stream.py:266
// (_fwd_kernel, launched by _run_fwd :773). Same function: walk each 16x16
// tile's depth-ordered run of the padded-CSR instance stream front to back
// and composite per pixel with the upstream rasterizer's rules:
//   alpha = min(0.99, opacity * exp(min(power, 0)))
//   skip where power > 0 or alpha < 1/255
//   stop BEFORE the contribution that would take T below 1e-4
// Outputs the pre-background color [T, 3, 256] and final transmittance
// [T, 256] of every tile (the background blend stays in PyTorch).
//
// Design. One CTA of 256 threads per tile, one thread per pixel. The TPU
// kernel walked the whole stream in order on one core and carried the
// transmittance across grid steps, flushing per-tile accumulators by DMA;
// here tiles are independent blocks, so each block reads only its own row
// range [chunk_start[t], chunk_end[t]) * chunk (computed once by the wrapper
// with searchsorted over the non-decreasing chunk->tile map) and nothing is
// carried between blocks. Rows are staged 256 at a time in shared memory
// with coalesced 16-byte loads; every thread then reads the same row
// (a broadcast, no bank conflicts). A block leaves as soon as
// __syncthreads_count says all 256 pixels have terminated.
//
// Bound. Per (row, pixel) pair the loop does ~20 fp32 operations plus one
// expf, on 36 useful bytes per row shared by 256 pixels, so it is bound by
// operations (fp32 outside the tensor cores), not by memory. The early exit
// is what keeps the pair count down. Load balance across tiles is uneven
// (dense tiles have long runs); a later version can split long runs.
//
// Property row layout (16 floats): x, y, conic a, b, c, r, g, b, opacity, pad.
// Pixel centers are integer coordinates in the tile-local frame
// (dx = (x - tile_origin) - px_local), as the TPU kernel evaluates them.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per block
constexpr int kRowF = 16;               // floats per property row
constexpr int kRowV = kRowF / 4;        // float4 per property row
constexpr int kBatch = 256;             // rows staged per pass (16 KB)

// The constants as the reference forms them: a double rounded to float.
constexpr float kAlphaCap = (float)0.99;
constexpr float kMinAlpha = (float)(1.0 / 255.0);
constexpr float kMinT = (float)1e-4;

__global__ void __launch_bounds__(kPixels) stream_fwd_kernel(
    const float4* __restrict__ props, const int* __restrict__ chunk_start,
    const int* __restrict__ chunk_end, int chunk, int grid_w,
    float* __restrict__ color, float* __restrict__ final_t) {
  __shared__ float4 rows[kBatch * kRowV];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)(p % kTile);
  const float py = (float)(p / kTile);
  const float ox = (float)((t % grid_w) * kTile);
  const float oy = (float)((t / grid_w) * kTile);
  const long long r0 = (long long)chunk_start[t] * chunk;
  const long long r1 = (long long)chunk_end[t] * chunk;

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int done = 0;
  for (long long base = r0; base < r1; base += kBatch) {
    const int n = (int)min((long long)kBatch, r1 - base);
    __syncthreads();  // the previous batch is fully consumed
    const float4* src = props + base * kRowV;
    for (int i = p; i < n * kRowV; i += kPixels) rows[i] = src[i];
    __syncthreads();
    if (!done) {
      for (int k = 0; k < n; ++k) {
        const float4 v0 = rows[k * kRowV];      // x, y, a, b
        const float4 v1 = rows[k * kRowV + 1];  // c, r, g, b
        const float opac = rows[k * kRowV + 2].x;
        const float dx = (v0.x - ox) - px;
        const float dy = (v0.y - oy) - py;
        const float power = -0.5f * (v0.z * dx * dx + v1.x * dy * dy) - v0.w * dx * dy;
        const float alpha = fminf(kAlphaCap, opac * expf(fminf(power, 0.0f)));
        if (power > 0.0f || alpha < kMinAlpha) continue;
        const float test_t = T * (1.0f - alpha);
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

extern "C" int stream_fwd(const void* props, const void* chunk_start, const void* chunk_end,
                          int chunk, int grid_w, int n_tiles, void* color, void* final_t,
                          void* stream) {
  if (n_tiles > 0) {
    stream_fwd_kernel<<<n_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (const float4*)props, (const int*)chunk_start, (const int*)chunk_end, chunk, grid_w,
        (float*)color, (float*)final_t);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
