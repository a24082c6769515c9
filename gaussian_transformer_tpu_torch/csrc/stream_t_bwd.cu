// Transposed-layout stream compositor backward for Hopper (sm_90a).
//
// Replaces the TPU kernel attic/stream_t.py:222 (_bwd_kernel_t, launched by
// _bwd_rule_t :421). Same function: replay each 16x16 tile's depth-ordered
// run of the stream, stored as planes props_t [16, I_pad], front to back and
// emit the gradient planes dprops_t [16, I_pad]:
//   x, y, conic a, b, c, rgb (sum_p w gC), opacity, then 7 zero planes,
// with the rows no pixel reaches (after every pixel of the tile has
// terminated, past the run's real rows, and the trash chunks) zero. Per
// pixel, with T the transmittance before the row, w = alpha T, and S the
// running (inclusive) sum of w <rgb, gC>, the suffix identity with the
// forward's color as C_total gives
//   g_alpha = <rgb, gC> T + (S - <gC, C_total> - gT T_final) / max(1 - alpha, 1e-6)
//   g_alpha = 0 where alpha_raw > 0.99 (the cap) or the row is skipped
//   g_power = g_alpha alpha
// and the row's 9 gradients are sums over the tile's pixels of the
// reference's per-pixel terms (attic/stream_t.py:317-337), with dx = x - px
// and dy = y - py in ABSOLUTE screen coordinates:
//   g_power (-(a dx) - b dy), g_power (-(c dy) - b dx), -0.5 g_power dx^2,
//   -g_power dx dy, -0.5 g_power dy^2, w gC (3), g_power / max(opacity, 1e-12).
//
// Design. K6's replay and reduction (table_bwd.cu) on planes: one CTA of 256
// threads per tile, one thread per pixel, the walk through
// stream_common.cuh's replay_step, so every pixel stops at exactly the row
// where K7 stopped it. The rows go in batches of B = 32 in three phases:
//   walk: K7's 8x4-pixel warps (stream_common.cuh fwd_pixel), whose skips
//     are more often uniform; each pixel stores its (g_power, w) per row in
//     its own slot of shared memory (pixel order, as K6's; the two pixel
//     rows of a half-warp share banks, a 2-way conflict that costs less
//     than swizzling the reduce's reads), each warp its ballot of
//     contributing lanes; a pair whose power is below the row's
//     exp-free floor (stream_common.cuh skip_floor, formed once per row at
//     staging) skips before replay_step: the floor's proof makes only skips
//     earlier, so T, alpha, g_power and w keep their bits;
//   reduce: (row, 32-pixel segment) jobs, 8 per row on adjacent lanes, each
//     adding its segment's per-pixel terms in pixel order, in K6's
//     operations and order (so K8's planes equal K6's rows bit for bit on
//     the same rows), skipping a segment (two pixel rows of the tile, the
//     halves of two warps' blocks) no pixel of which contributes; three
//     xor-shuffle levels add the 8 partials, and one lane a row puts its 9
//     sums in shared memory;
//   store: consecutive lanes write consecutive rows of one plane, so each of
//     the batch's 16 planes goes out as one contiguous run of B floats.
// Staging reads the batch's 9 used planes coalesced (32 rows of one plane a
// warp) into K6's row form. The per-pixel terms stay per pixel (not K2's
// moments): absolute coordinates lose digits in the moment form. Block t
// walks only its run's real rows [row_start[t], row_end[t]) and then zeroes
// every row from its exit or its real end to the run's padded end (the next
// run's start); block n_tiles zeroes the trash chunks. Every element of
// dprops_t is written exactly once, and no atomics are needed (a row
// belongs to one tile). 74,880 B of dynamic and 1,152 B of static shared
// memory a block, three blocks an SM.
//
// Bound. Per walked (row, pixel) pair K7's ~14 fp32 operations and one
// shared store (most pairs skip before the expf); per contributing pair ~27
// more (the T update, the g_alpha division); the reduce phase ~27 per (row,
// pixel) of a live segment (dx, dy, the five geometric terms, 9 sums); 36
// bytes read per real row, 64 written per row of the stream. So it is bound
// by operations.

#include <cuda_runtime.h>

#include "stream_common.cuh"

namespace {

using namespace stream_common;

constexpr int kSums = 9;  // the gradient planes 0-8 (opacity's from sum g_power)

// The walk-phase store of thread tid (pixel q = fwd_pixel(tid)) at row k:
// its (g_power, w) in q's slot, and lane 0 its warp's ballot.
__device__ __forceinline__ void replay_store_8x4(const ReplaySmem& s, int k, int tid, int q, bool live,
                                                 float gp, float w) {
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if ((tid & 31) == 0) s.bal[k * kWarps + (tid >> 5)] = ballot;
  s.gw[k * kPadRow + pad_pixel(q)] = make_float2(gp, w);
}

// Whether a pixel of segment seg (pixel rows 2 seg and 2 seg + 1) contributes
// to row k: the segment is lanes 16 (seg & 1) + [0, 16) of warps 2 (seg >> 1)
// (its left half) and 2 (seg >> 1) + 1 (its right half).
__device__ __forceinline__ bool segment_live_8x4(const ReplaySmem& s, int k, int seg) {
  const unsigned* bal = s.bal + k * kWarps + 2 * (seg >> 1);
  return ((bal[0] | bal[1]) & ((seg & 1) ? 0xffff0000u : 0x0000ffffu)) != 0u;
}

// Rows [base, base + n) of the planes into rows (K6's row form, 16 floats a
// row), plane j of row k by thread j * 32 + k (a warp reads 32 consecutive
// floats of one plane); slot 9 of a row holds its skip floor, formed by the
// lane that read its opacity.
__device__ __forceinline__ void stage_plane_rows(float4* rows, const float* __restrict__ props_t,
                                                 long long ld, long long base, int n, int tid) {
  float* dst = reinterpret_cast<float*>(rows);
  for (int i = tid; i < kUsedPlanes * kReplayRows; i += kPixels) {
    const int j = i / kReplayRows, k = i % kReplayRows;
    if (k < n) {
      const float v = __ldg(props_t + j * ld + base + k);
      dst[k * kRowF + j] = v;
      if (j == kUsedPlanes - 1) dst[k * kRowF + kUsedPlanes] = skip_floor(v);
    }
  }
}

__global__ void __launch_bounds__(kPixels, 3) stream_t_bwd_kernel(
    const float* __restrict__ props_t, const int* __restrict__ row_start,
    const int* __restrict__ row_end, const float* __restrict__ color,
    const float* __restrict__ final_t, const float* __restrict__ g_color,
    const float* __restrict__ g_t, long long ld, int grid_w, int n_tiles,
    float* __restrict__ dprops_t) {
  extern __shared__ float4 smem[];
  __shared__ float sums[kSums][kReplayRows];  // the batch's gradient planes 0-8
  const ReplaySmem sm = replay_smem(smem);
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int job_row = p / kSegments;  // the reduce phase's job: row of the batch,
  const int seg = p % kSegments;      // and pixel segment
  const int q = fwd_pixel(p);         // the walk's pixel
  const long long r0 = row_start[t];
  const long long r_real = row_end[t];                          // past the run's last real row
  const long long r_pad = t < n_tiles ? row_start[t + 1] : ld;  // the run's padded end

  long long written = r0;  // rows [r0, written) hold gradients
  if (t < n_tiles) {
    const float ox = (float)((t % grid_w) * kTile);
    const float oy = (float)((t / grid_w) * kTile);
    const float px = ox + (float)(q % kTile);  // absolute pixel centre (exact)
    const float py = oy + (float)(q / kTile);

    // The tile's residuals and cotangents at this pixel.
    const size_t o3 = (size_t)t * 3 * kPixels + q;
    const size_t o1 = (size_t)t * kPixels + q;
    const float gc0 = g_color[o3], gc1 = g_color[o3 + kPixels], gc2 = g_color[o3 + 2 * kPixels];
    const float gdot_total = gc0 * color[o3] + gc1 * color[o3 + kPixels] + gc2 * color[o3 + 2 * kPixels];
    const float gt_final = g_t[o1] * final_t[o1];
    sm.gc[pad_pixel(q)] = make_float4(gc0, gc1, gc2, 0.0f);

    float T = 1.0f, S = 0.0f;
    int done = 0;
    for (long long base = r0; base < r_real; base += kReplayRows) {
      const int n = (int)min((long long)kReplayRows, r_real - base);
      stage_plane_rows(sm.rows, props_t, ld, base, n, p);
      __syncthreads();  // the batch's rows (and gC) are staged
      for (int k = 0; k < n; ++k) {
        float gp = 0.0f, w = 0.0f;
        bool live = false;
        if (!done) {
          const float4 v0 = sm.rows[k * kRowV];      // x, y, a, b
          const float4 v1 = sm.rows[k * kRowV + 1];  // c, r, g, b
          const float4 v2 = sm.rows[k * kRowV + 2];  // opacity, P_row
          const float power = splat_power(v0.x, v0.y, v0.z, v0.w, v1.x, px, py);
          if (!(power < v2.y))
            live = replay_step(power, v2.x, v1, gc0, gc1, gc2, gdot_total, gt_final, T, S, done, gp, w);
        }
        replay_store_8x4(sm, k, p, q, live, gp, w);
      }
      __syncthreads();  // the batch's (g_power, w) are stored
      float m[kSums];
#pragma unroll
      for (int j = 0; j < kSums; ++j) m[j] = 0.0f;
      if (job_row < n && segment_live_8x4(sm, job_row, seg)) {
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
      if (job_row < n && seg == 0) {
#pragma unroll
        for (int j = 0; j < kSums - 1; ++j) sums[j][job_row] = m[j];
        sums[kSums - 1][job_row] = m[kSums - 1] / fmaxf(sm.rows[job_row * kRowV + 2].x, 1e-12f);
      }
      const int n_done = __syncthreads_count(done);  // also: the sums are stored, the batch consumed
      for (int i = p; i < kRowF * kReplayRows; i += kPixels) {
        const int j = i / kReplayRows, k = i % kReplayRows;
        if (k < n) dprops_t[j * ld + base + k] = j < kSums ? sums[j][k] : 0.0f;
      }
      written = base + n;
      if (n_done == kPixels) break;
    }
  }
  // Rows from the exit or the real end to the padded end, and the trash chunks.
  for (long long i = written + p; i < r_pad; i += kPixels) {
#pragma unroll
    for (int j = 0; j < kRowF; ++j) dprops_t[j * ld + i] = 0.0f;
  }
}

bool smem_opted_in = false;

}  // namespace

extern "C" int stream_t_bwd(const void* props_t, const void* row_start, const void* row_end,
                            const void* color, const void* final_t, const void* g_color,
                            const void* g_t, long long ld, int grid_w, int n_tiles, void* dprops_t,
                            void* stream) {
  const cudaError_t err = replay_smem_opt_in(stream_t_bwd_kernel, smem_opted_in);
  if (err != cudaSuccess) return (int)err;
  // n_tiles + 1 blocks: block n_tiles zeroes the trash chunks.
  stream_t_bwd_kernel<<<n_tiles + 1, kPixels, kReplaySmemBytes, (cudaStream_t)stream>>>(
      (const float*)props_t, (const int*)row_start, (const int*)row_end, (const float*)color,
      (const float*)final_t, (const float*)g_color, (const float*)g_t, ld, grid_w, n_tiles,
      (float*)dprops_t);
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
