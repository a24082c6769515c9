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
// reference's per-pixel terms (pallas_composite.py:319-351,
// stream_common.cuh pixel_grad_terms), with dx = x - px and dy = y - py in
// absolute screen coordinates:
//   g_power (-(a dx) - b dy), g_power (-(c dy) - b dx), -0.5 g_power dx^2,
//   -g_power dx dy, -0.5 g_power dy^2, w gC (3), g_power / max(opacity, 1e-12).
//
// Design. K2's (stream_bwd.cu) on K5's geometry (table_fwd.cu): one CTA of
// 256 threads per tile, one thread per pixel, rows staged in shared memory,
// the walk through the alpha and transmittance functions of
// stream_common.cuh (replay_step), so every pixel stops at exactly the row
// where K5 stopped it. The TPU kernel ran 8 tiles per program with
// Hillis-Steele scans over 32-row chunks; here a tile is a block and the walk
// is sequential. No atomics: a table row belongs to one tile. The rows go in
// batches of B = 32 in two phases, as K2's:
//   walk: each pixel stores its (g_power, w) per row in shared memory, each
//     warp its ballot of contributing lanes;
//   reduce: (row, 32-pixel segment) jobs, 8 per row on adjacent lanes, each
//     adding its segment's per-pixel terms in pixel order from the staged
//     row's x, y, a, b, c, the absolute pixel centre and the staged gC
//     (skipping a segment no pixel of which contributes); three xor-shuffle
//     levels add the 8 partials and 4 lanes write the row's 4 float4.
// The per-pixel terms stay per pixel (not K2's moments), since absolute
// coordinates lose digits in the moment form. 73 KB of dynamic shared memory
// a block, three blocks an SM; the reduce loop is unrolled 4 times. The
// block then zeroes the rest of its slab up to K.
//
// Bound. Per walked (row, pixel) pair K5's ~14 fp32 operations plus one expf
// and one shared store; per contributing pair ~27 more (the T update, the
// g_alpha division); the reduce phase ~27 per (row, pixel) of a live segment
// (dx, dy, the five geometric terms, 9 sums). The row's 36 useful bytes are
// shared by 256 pixels, so it is bound by operations, except that the
// [T, K, 16] output is written whole: where the table is mostly padding the
// zero rows' bytes come close (at 1080p in training they bound it).

#include <cuda_runtime.h>

#include "stream_common.cuh"

namespace {

using namespace stream_common;

__global__ void __launch_bounds__(kPixels, 3) table_bwd_kernel(
    const float4* __restrict__ props, const int* __restrict__ counts,
    const float* __restrict__ color, const float* __restrict__ final_t,
    const float* __restrict__ g_color, const float* __restrict__ g_t, int K, int grid_w,
    float4* __restrict__ dprops) {
  extern __shared__ float4 smem[];
  const ReplaySmem sm = replay_smem(smem);
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int job_row = p / kSegments;  // the reduce phase's job: row of the batch,
  const int seg = p % kSegments;      // and pixel segment
  const float ox = (float)((t % grid_w) * kTile);
  const float oy = (float)((t / grid_w) * kTile);
  const float px = ox + (float)(p % kTile);  // absolute pixel centre (exact)
  const float py = oy + (float)(p / kTile);
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
  sm.gc[pad_pixel(p)] = make_float4(gc0, gc1, gc2, 0.0f);

  float T = 1.0f, S = 0.0f;
  int done = 0;
  int written = 0;  // rows [0, written) hold gradients
  for (int base = 0; base < n_rows; base += kReplayRows) {
    const int n = min(kReplayRows, n_rows - base);
    const float4* src = tile_rows + (size_t)base * kRowV;
    for (int i = p; i < n * kRowV; i += kPixels) sm.rows[i] = src[i];
    __syncthreads();  // the batch's rows (and gC) are staged
    for (int k = 0; k < n; ++k) {
      float gp = 0.0f, w = 0.0f;
      bool live = false;
      if (!done) {
        const float4 v0 = sm.rows[k * kRowV];      // x, y, a, b
        const float4 v1 = sm.rows[k * kRowV + 1];  // c, r, g, b
        const float opac = sm.rows[k * kRowV + 2].x;
        const float power = splat_power(v0.x, v0.y, v0.z, v0.w, v1.x, px, py);
        live = replay_step(power, opac, v1, gc0, gc1, gc2, gdot_total, gt_final, T, S, done, gp, w);
      }
      replay_store(sm, k, p, live, gp, w);
    }
    __syncthreads();  // the batch's (g_power, w) are stored
    float m[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) m[j] = 0.0f;
    if (job_row < n && segment_bits(sm, job_row, seg) != 0u) {
      const float4 v0 = sm.rows[job_row * kRowV];  // x, y, a, b
      const float c = sm.rows[job_row * kRowV + 1].x;
      const float2* gw = sm.gw + job_row * kPadRow + seg * kSegStride;
      const float4* gc = sm.gc + seg * kSegStride;
      const float seg_y = oy + (float)(seg * (kSegPixels / kTile));  // the segment's first pixel row
#pragma unroll 4
      for (int i = 0; i < kSegPixels; ++i) {
        const float2 v = gw[i];
        const float4 g = gc[i];
        const float dx = v0.x - (ox + (float)(i % kTile));
        const float dy = v0.y - (seg_y + (float)(i / kTile));
        float terms[9];
        pixel_grad_terms(v.x, v.y, g.x, g.y, g.z, dx, dy, v0.z, v0.w, c, terms);
#pragma unroll
        for (int j = 0; j < 9; ++j) m[j] += terms[j];
      }
    }
    sum_segments(m);
    if (job_row < n && seg < kRowV) {
      float4 o = zero4;
      if (seg == 0) {
        o = make_float4(m[0], m[1], m[2], m[3]);
      } else if (seg == 1) {
        o = make_float4(m[4], m[5], m[6], m[7]);
      } else if (seg == 2) {
        o.x = m[8] / fmaxf(sm.rows[job_row * kRowV + 2].x, 1e-12f);
      }
      out_rows[(size_t)(base + job_row) * kRowV + seg] = o;
    }
    written = base + n;
    if (__syncthreads_count(done) == kPixels) break;  // also: the batch is consumed
  }
  // The rows the walk did not reach, up to K.
  for (size_t i = (size_t)written * kRowV + p; i < (size_t)K * kRowV; i += kPixels) out_rows[i] = zero4;
}

bool smem_opted_in = false;

}  // namespace

extern "C" int table_bwd(const void* props, const void* counts, const void* color,
                         const void* final_t, const void* g_color, const void* g_t, int K,
                         int grid_w, int n_tiles, void* dprops, void* stream) {
  const cudaError_t err = replay_smem_opt_in(table_bwd_kernel, smem_opted_in);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    table_bwd_kernel<<<n_tiles, kPixels, kReplaySmemBytes, (cudaStream_t)stream>>>(
        (const float4*)props, (const int*)counts, (const float*)color, (const float*)final_t,
        (const float*)g_color, (const float*)g_t, K, grid_w, (float4*)dprops);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
