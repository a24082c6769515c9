// Stream compositor backward for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_transformer_tpu/render/stream.py:411
// (_bwd_kernel, launched by _stream_bwd_rule :822). Same function: replay
// each 16x16 tile's depth-ordered run of the padded-CSR stream front to back
// and emit one gradient row per stream row:
//   dx, dy, conic a, b, c, rgb (sum_p w gC), opacity, then 7 zeros.
// Per pixel, with T the transmittance before the row, w = alpha T, and S the
// running (inclusive) sum of w <rgb, gC>:
//   g_alpha = <rgb, gC> T + (S - <gC, C_total> - gT T_final) / max(1 - alpha, 1e-6)
//   g_alpha = 0 where alpha_raw > 0.99 (the cap) or the row is skipped
//   g_power = g_alpha alpha
// and the row's gradients follow from six moments of g_power over the tile's
// pixels, m = sum_p g_power [1, px, py, px^2, py^2, px py] (the reference's
// formulas, stream.py:559-599), plus three sums sum_p w gC.
//
// Design. The launch geometry is K1's (stream_fwd.cu): one CTA of 256
// threads per tile, one thread per pixel, the tile's row range from the same
// searchsorted chunk ranges, rows staged in shared memory. The walk uses the
// alpha and transmittance functions of stream_common.cuh, so every pixel
// stops at exactly the row where K1 stopped it. The TPU kernel carried its
// state across sequential grid steps; here a tile is one block, so nothing
// is carried between blocks and no atomics are needed (a row belongs to one
// tile). Each row needs 9 sums over the tile's 256 pixels: a warp reduces its
// 32 lanes with shuffles (skipped when no lane of the warp contributes, the
// common case at a splat's edge) and writes 9 partials to shared memory; at
// the end of each 64-row batch one thread per row adds the 8 warps' partials
// in a fixed order (deterministic) and writes the row. Rows after the block
// has terminated, padding rows and the trash chunks (block n_tiles) get zeros.
//
// Bound. Per (row, pixel) pair ~45 fp32 operations (K1's alpha and T walk,
// the g_alpha division, 9 products) plus one expf and, where a warp is live,
// 9 x 5 shuffle-adds; the row's 36 useful bytes are shared by 256 pixels. So
// it is bound by operations, and the warp reductions are the largest share of
// them. A faster version would reduce several rows per shuffle round.

#include <cuda_runtime.h>

#include "stream_common.cuh"

namespace {

using namespace stream_common;

constexpr int kBatch = 64;  // rows staged per pass
constexpr int kWarps = kPixels / 32;
constexpr int kSums = 9;  // m0..m5, then sum w gC per channel

__global__ void __launch_bounds__(kPixels) stream_bwd_kernel(
    const float4* __restrict__ props, const float* __restrict__ tiledata,
    const int* __restrict__ chunk_start, const int* __restrict__ chunk_end, int chunk,
    int grid_w, int n_tiles, float4* __restrict__ dprops) {
  __shared__ float4 rows[kBatch * kRowV];
  __shared__ float red[kBatch][kWarps][kSums];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const long long r0 = (long long)chunk_start[t] * chunk;
  const long long r1 = (long long)chunk_end[t] * chunk;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  long long base = r0;
  if (t < n_tiles) {
    const float px = (float)(p % kTile);
    const float py = (float)(p / kTile);
    const float ox = (float)((t % grid_w) * kTile);
    const float oy = (float)((t / grid_w) * kTile);
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
      const float4* src = props + base * kRowV;
      for (int i = p; i < n * kRowV; i += kPixels) rows[i] = src[i];
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        float s[kSums];
#pragma unroll
        for (int j = 0; j < kSums; ++j) s[j] = 0.0f;
        bool live = false;
        if (!done) {
          const float4 v0 = rows[k * kRowV];      // x, y, a, b
          const float4 v1 = rows[k * kRowV + 1];  // c, r, g, b
          const float opac = rows[k * kRowV + 2].x;
          const float power =
              splat_power(__fsub_rn(v0.x, ox), __fsub_rn(v0.y, oy), v0.z, v0.w, v1.x, px, py);
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
              s[6] = w * gc0;
              s[7] = w * gc1;
              s[8] = w * gc2;
              if (!(alpha_raw > kAlphaCap)) {
                const float g_alpha =
                    rdg * T + ((S - gdot_total) - gt_final) / fmaxf(1.0f - alpha, 1e-6f);
                const float gp = g_alpha * alpha;
                s[0] = gp;
                s[1] = gp * px;
                s[2] = gp * py;
                s[3] = gp * (px * px);
                s[4] = gp * (py * py);
                s[5] = gp * (px * py);
              }
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
        const float4 v0 = rows[p * kRowV];
        const float4 v1 = rows[p * kRowV + 1];
        const float opac = rows[p * kRowV + 2].x;
        const float x = v0.x - ox, y = v0.y - oy;
        const float a = v0.z, b = v0.w, c = v1.x;
        const float s_dx = x * m[0] - m[1];  // sum_p g_power dx
        const float s_dy = y * m[0] - m[2];
        float4* out = dprops + (base + p) * kRowV;
        out[0] = make_float4(-(a * s_dx + b * s_dy), -(c * s_dy + b * s_dx),
                             -0.5f * (x * x * m[0] - 2.0f * x * m[1] + m[3]),
                             -(x * y * m[0] - x * m[2] - y * m[1] + m[5]));
        out[1] = make_float4(-0.5f * (y * y * m[0] - 2.0f * y * m[2] + m[4]), m[6], m[7], m[8]);
        out[2] = make_float4(m[0] / fmaxf(opac, 1e-12f), 0.0f, 0.0f, 0.0f);
        out[3] = zero4;
      }
      if (__syncthreads_count(done) == kPixels) {
        base += kBatch;
        break;
      }
    }
  }
  // Rows past the termination of every pixel, and the trash chunks.
  for (long long i = base * kRowV + p; i < r1 * kRowV; i += kPixels) dprops[i] = zero4;
}

}  // namespace

extern "C" int stream_bwd(const void* props, const void* tiledata, const void* chunk_start,
                          const void* chunk_end, int chunk, int grid_w, int n_tiles,
                          void* dprops, void* stream) {
  // n_tiles + 1 blocks: block n_tiles zeroes the trash chunks.
  stream_bwd_kernel<<<n_tiles + 1, kPixels, 0, (cudaStream_t)stream>>>(
      (const float4*)props, (const float*)tiledata, (const int*)chunk_start,
      (const int*)chunk_end, chunk, grid_w, n_tiles, (float4*)dprops);
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
