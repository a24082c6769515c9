// Table compositor backward for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_transformer_tpu/render/pallas_composite.py:237
// (_bwd_kernel, launched by _bwd_rule :429). Same function: replay each
// tile's walk of its [K, 16] table slab front to back and emit one gradient
// row per table row:
//   x, y, conic a, b, c, rgb (sum_p w gC), opacity, then 7 zeros,
// with the rows the walk does not reach (past counts[t] rounded up to 32, or
// after every pixel of the tile has terminated) all zero. Per pixel, with T
// the transmittance before the row, w = alpha T, and S the running
// (inclusive) sum of w <rgb, gC>, the suffix identity with the forward's
// color as C_total gives
//   g_alpha = <rgb, gC> T + (S - <gC, C_total> - gT T_final) / max(1 - alpha, 1e-6)
//   g_alpha = 0 where alpha_raw > 0.99 (the cap) or the row is skipped
//   g_power = g_alpha alpha
// and the row's 9 gradients are sums over the tile's pixels of the
// reference's per-pixel terms (pallas_composite.py:319-351), with dx = x - px
// and dy = y - py in absolute screen coordinates:
//   g_power (-(a dx) - b dy), g_power (-(c dy) - b dx), -0.5 g_power dx^2,
//   -g_power dx dy, -0.5 g_power dy^2, w gC (3), g_power / max(opacity, 1e-12).
//
// Design. K2's (stream_bwd.cu) on K5's geometry (table_fwd.cu): one CTA of
// 256 threads per tile, one thread per pixel, rows staged in shared memory,
// the walk through the alpha and transmittance functions of
// stream_common.cuh, so every pixel stops at exactly the row where K5
// stopped it. The TPU kernel ran 8 tiles per program with Hillis-Steele
// scans over 32-row chunks; here a tile is a block and the walk is
// sequential. No atomics: a table row belongs to one tile. Each row's 9 sums
// over 256 pixels: a warp reduces its 32 lanes with shuffles (skipped when no
// lane of the warp contributes) and writes 9 partials to shared memory; at
// the end of each 64-row batch one thread per row adds the 8 warps' partials
// in a fixed order (deterministic) and writes the row. The block then zeroes
// the rest of its slab up to K.
//
// Bound. Per walked (row, pixel) pair K5's ~14 fp32 operations plus one
// expf; per contributing pair ~52 more (the T update, the g_alpha division,
// the geometric terms, 9 sums); the row's 36 useful bytes are shared by 256
// pixels. So it is bound by operations, except that
// the [T, K, 16] output is written whole: where the table is mostly padding
// the zero rows' bytes can come close.

#include <cuda_runtime.h>

#include "stream_common.cuh"

namespace {

using namespace stream_common;

constexpr int kBatch = 64;  // rows staged per pass
constexpr int kWarps = kPixels / 32;
constexpr int kSums = 9;  // the 9 gradient columns (opacity as sum g_power)

__global__ void __launch_bounds__(kPixels) table_bwd_kernel(
    const float4* __restrict__ props, const int* __restrict__ counts,
    const float* __restrict__ color, const float* __restrict__ final_t,
    const float* __restrict__ g_color, const float* __restrict__ g_t, int K, int grid_w,
    float4* __restrict__ dprops) {
  __shared__ float4 rows[kBatch * kRowV];
  __shared__ float red[kBatch][kWarps][kSums];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = (float)((t % grid_w) * kTile + p % kTile);
  const float py = (float)((t / grid_w) * kTile + p / kTile);
  const int n_rows = walked_rows(counts[t], K);
  const float4* tile_rows = props + (size_t)t * K * kRowV;
  float4* out_rows = dprops + (size_t)t * K * kRowV;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // The tile's residuals and cotangents at this pixel.
  const size_t o3 = (size_t)t * 3 * kPixels + p;
  const size_t o1 = (size_t)t * kPixels + p;
  const float gc0 = g_color[o3], gc1 = g_color[o3 + kPixels], gc2 = g_color[o3 + 2 * kPixels];
  const float gdot_total = gc0 * color[o3] + gc1 * color[o3 + kPixels] + gc2 * color[o3 + 2 * kPixels];
  const float gt_final = g_t[o1] * final_t[o1];

  float T = 1.0f, S = 0.0f;
  int done = 0;
  int written = 0;  // rows [0, written) hold gradients
  for (int base = 0; base < n_rows; base += kBatch) {
    const int n = min(kBatch, n_rows - base);
    __syncthreads();  // the previous batch is fully consumed
    const float4* src = tile_rows + (size_t)base * kRowV;
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
            s[5] = w * gc0;
            s[6] = w * gc1;
            s[7] = w * gc2;
            if (!(alpha_raw > kAlphaCap)) {
              const float g_alpha =
                  rdg * T + ((S - gdot_total) - gt_final) / fmaxf(1.0f - alpha, 1e-6f);
              const float gp = g_alpha * alpha;
              const float dx = v0.x - px, dy = v0.y - py;
              const float a = v0.z, b = v0.w, c = v1.x;
              s[0] = gp * (-(a * dx) - b * dy);
              s[1] = gp * (-(c * dy) - b * dx);
              s[2] = gp * (-0.5f * dx * dx);
              s[3] = gp * (-(dx * dy));
              s[4] = gp * (-0.5f * dy * dy);
              s[8] = gp;
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
      const float opac = rows[p * kRowV + 2].x;
      float4* out = out_rows + (size_t)(base + p) * kRowV;
      out[0] = make_float4(m[0], m[1], m[2], m[3]);
      out[1] = make_float4(m[4], m[5], m[6], m[7]);
      out[2] = make_float4(m[8] / fmaxf(opac, 1e-12f), 0.0f, 0.0f, 0.0f);
      out[3] = zero4;
    }
    written = base + n;
    if (__syncthreads_count(done) == kPixels) break;
  }
  // The rows the walk did not reach, up to K.
  for (size_t i = (size_t)written * kRowV + p; i < (size_t)K * kRowV; i += kPixels) out_rows[i] = zero4;
}

}  // namespace

extern "C" int table_bwd(const void* props, const void* counts, const void* color,
                         const void* final_t, const void* g_color, const void* g_t, int K,
                         int grid_w, int n_tiles, void* dprops, void* stream) {
  if (n_tiles > 0) {
    table_bwd_kernel<<<n_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (const float4*)props, (const int*)counts, (const float*)color, (const float*)final_t,
        (const float*)g_color, (const float*)g_t, K, grid_w, (float4*)dprops);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
