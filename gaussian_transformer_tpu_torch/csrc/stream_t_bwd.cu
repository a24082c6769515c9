// Transposed-layout stream compositor backward for Hopper (sm_90a).
//
// Replaces the TPU kernel attic/stream_t.py:222 (_bwd_kernel_t, launched by
// _bwd_rule_t :421). Same function: replay each 16x16 tile's depth-ordered
// run of the stream, stored as planes props_t [16, I_pad], front to back and
// emit the gradient planes dprops_t [16, I_pad]:
//   x, y, conic a, b, c, rgb (sum_p w gC), opacity, then 7 zero planes,
// with the rows no pixel reaches (after every pixel of the tile has
// terminated, padding rows and the trash chunks) zero. Per pixel, with T the
// transmittance before the row, w = alpha T, and S the running (inclusive)
// sum of w <rgb, gC>, the suffix identity with the forward's color as
// C_total gives
//   g_alpha = <rgb, gC> T + (S - <gC, C_total> - gT T_final) / max(1 - alpha, 1e-6)
//   g_alpha = 0 where alpha_raw > 0.99 (the cap) or the row is skipped
//   g_power = g_alpha alpha
// and the row's 9 gradients are sums over the tile's pixels of the
// reference's per-pixel terms (attic/stream_t.py:317-337), with dx = x - px
// and dy = y - py in ABSOLUTE screen coordinates:
//   g_power (-(a dx) - b dy), g_power (-(c dy) - b dx), -0.5 g_power dx^2,
//   -g_power dx dy, -0.5 g_power dy^2, w gC (3), g_power / max(opacity, 1e-12).
//
// Design. K7's walk (stream_t_fwd.cu: one CTA of 256 threads per tile over
// its own row range, the 9 used planes staged coalesced, the alpha and
// transmittance functions of stream_common.cuh, so every pixel stops at
// exactly the row where K7 stopped it) with K6's per-pixel terms
// (stream_common.cuh pixel_grad_terms), reduced per row: a warp reduces its
// 32 lanes with shuffles (skipped when no lane of the warp contributes) and
// writes 9 partials to shared memory; at the end of each 64-row batch
// thread p adds the 8 warps' partials of row base + p in a fixed order
// (deterministic, no atomics: a row belongs to one tile) and writes its 16
// planes, so each plane's store
// is coalesced across the batch. The block then zeroes its rows past the
// exit; block n_tiles zeroes the trash chunks. Every element of dprops_t is
// written exactly once.
//
// Bound. Per walked (row, pixel) pair K7's ~14 fp32 operations plus one
// expf; per contributing pair ~52 more (the T update, the g_alpha division,
// the geometric terms, 9 sums); 36 bytes read per row, 64 written. So it is
// bound by operations, and the warp reductions are the largest share.

#include <cuda_runtime.h>

#include "stream_common.cuh"

namespace {

using namespace stream_common;

constexpr int kBatch = 64;  // rows staged per pass
constexpr int kSums = 9;  // the 9 gradient planes (opacity as sum g_power)

__global__ void __launch_bounds__(kPixels) stream_t_bwd_kernel(
    const float* __restrict__ props_t, const float* __restrict__ tiledata,
    const int* __restrict__ chunk_start, const int* __restrict__ chunk_end, long long ld,
    int chunk, int grid_w, int n_tiles, float* __restrict__ dprops_t) {
  __shared__ float4 rows[kBatch * kPlaneRowV];
  __shared__ float red[kBatch][kWarps][kSums];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const long long r0 = (long long)chunk_start[t] * chunk;
  const long long r1 = (long long)chunk_end[t] * chunk;

  long long base = r0;
  if (t < n_tiles) {
    const float px = (float)((t % grid_w) * kTile + p % kTile);
    const float py = (float)((t / grid_w) * kTile + p / kTile);
    // The tile's residual/cotangent rows: C_total 0:3, T_final 3, gC 4:7, gT 7.
    const float* td = tiledata + (size_t)t * 8 * kPixels + p;
    const float gc0 = td[4 * kPixels], gc1 = td[5 * kPixels], gc2 = td[6 * kPixels];
    const float gdot_total = gc0 * td[0] + gc1 * td[kPixels] + gc2 * td[2 * kPixels];
    const float gt_final = td[7 * kPixels] * td[3 * kPixels];

    float T = 1.0f, S = 0.0f;
    int done = 0;
    for (; base < r1; base += kBatch) {
      const int n = (int)min((long long)kBatch, r1 - base);
      __syncthreads();  // the previous batch is fully consumed
      if (p < n) stage_planes(props_t, ld, base + p, (float*)rows + p * kPlaneRowF);
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        float s[kSums];
#pragma unroll
        for (int j = 0; j < kSums; ++j) s[j] = 0.0f;
        bool live = false;
        if (!done) {
          const float4 v0 = rows[k * kPlaneRowV];      // x, y, a, b
          const float4 v1 = rows[k * kPlaneRowV + 1];  // c, r, g, b
          const float opac = rows[k * kPlaneRowV + 2].x;
          const float power = splat_power(v0.x, v0.y, v0.z, v0.w, v1.x, px, py);
          const float alpha_raw = splat_alpha_raw(opac, power);
          const float alpha = fminf(kAlphaCap, alpha_raw);
          if (!splat_skipped(power, alpha)) {
            const float test_t = next_t(T, alpha);
            if (test_t < kMinT) {
              done = 1;
            } else {
              live = true;
              const float w = alpha * T;
              const float rdg = v1.y * gc0 + v1.z * gc1 + v1.w * gc2;
              S += w * rdg;
              float gp = 0.0f;
              if (!(alpha_raw > kAlphaCap)) {
                const float g_alpha =
                    rdg * T + ((S - gdot_total) - gt_final) / fmaxf(1.0f - alpha, 1e-6f);
                gp = g_alpha * alpha;
              }
              pixel_grad_terms(gp, w, gc0, gc1, gc2, v0.x - px, v0.y - py, v0.z, v0.w, v1.x, s);
              T = test_t;
            }
          }
        }
        if (__any_sync(0xffffffffu, live)) {
#pragma unroll
          for (int j = 0; j < kSums; ++j) {
            float v = s[j];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            s[j] = v;
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < kSums; ++j) red[k][warp][j] = s[j];
        }
      }
      __syncthreads();
      if (p < n) {
        float m[kSums];
#pragma unroll
        for (int j = 0; j < kSums; ++j) {
          float v = 0.0f;
#pragma unroll
          for (int wi = 0; wi < kWarps; ++wi) v += red[p][wi][j];
          m[j] = v;
        }
        m[8] /= fmaxf(((const float*)rows)[p * kPlaneRowF + 8], 1e-12f);  // / opacity
        float* out = dprops_t + base + p;
#pragma unroll
        for (int j = 0; j < kSums; ++j) out[j * ld] = m[j];
#pragma unroll
        for (int j = kSums; j < kRowF; ++j) out[j * ld] = 0.0f;
      }
      if (__syncthreads_count(done) == kPixels) {
        base += kBatch;
        break;
      }
    }
  }
  // Rows past the termination of every pixel, and the trash chunks.
  for (long long i = base + p; i < r1; i += kPixels) {
#pragma unroll
    for (int j = 0; j < kRowF; ++j) dprops_t[j * ld + i] = 0.0f;
  }
}

}  // namespace

extern "C" int stream_t_bwd(const void* props_t, const void* tiledata, const void* chunk_start,
                            const void* chunk_end, long long ld, int chunk, int grid_w, int n_tiles,
                            void* dprops_t, void* stream) {
  // n_tiles + 1 blocks: block n_tiles zeroes the trash chunks.
  stream_t_bwd_kernel<<<n_tiles + 1, kPixels, 0, (cudaStream_t)stream>>>(
      (const float*)props_t, (const float*)tiledata, (const int*)chunk_start,
      (const int*)chunk_end, ld, chunk, grid_w, n_tiles, (float*)dprops_t);
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
