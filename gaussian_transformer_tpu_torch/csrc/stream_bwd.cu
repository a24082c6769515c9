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
// alpha and transmittance functions of stream_common.cuh (replay_step), so
// every pixel stops at exactly the row where K1 stopped it. The TPU kernel
// carried its state across sequential grid steps; here a tile is one block,
// so nothing is carried between blocks and no atomics are needed (a row
// belongs to one tile). The rows go in batches of B = 32 in two phases:
//   walk: each pixel steps through the batch's rows and stores its
//     (g_power, w) per row in shared memory (0 where it does not contribute;
//     w is nonzero and g_power 0 at the cap), each warp its ballot of
//     contributing lanes;
//   reduce: the 256 threads take (row, 32-pixel segment) jobs, 8 per row on
//     adjacent lanes; a job adds its segment's 9 terms in pixel order (the
//     six moments with the tile-local px, py of the pixel index, each
//     16-pixel row's sums of g_power, g_power px and g_power px^2 taken
//     before its py is folded in; and w gC with gC staged once per block),
//     skipping a segment no pixel of which contributes; three xor-shuffle
//     levels add the 8 partials and 4 lanes write the row's 4 float4.
// So a row costs 27/4 warp shuffles. The segments are padded
// (stream_common.cuh), so neither phase has bank conflicts. 73 KB of dynamic
// shared memory a block (opted in once by the entry point), three blocks an
// SM; the reduce loop is unrolled 4 times (a full unroll hoists its loads
// past the register budget and spills). Rows after the block has
// terminated, padding rows and the trash chunks (block n_tiles) get zeros.
//
// Bound. Per walked (row, pixel) pair K1's ~14 fp32 operations and one expf
// plus one shared store; per contributing pair ~27 more (the T update, the
// g_alpha division); the reduce phase ~15 per (row, pixel) of a live
// segment. The row's 36 useful bytes are shared by 256 pixels, so it is
// bound by operations, and the walk, which K1 also pays, is the largest
// share of them.

// precision="bf16" (stream_bwd_bf16) replaces the same TPU kernel in its
// local_coords mode (stream.py:840): it replays the bf16 tile-local rows
// that the forward read and saved (stream.py:812-819), each widened to
// float32 as it is staged (stream_common.cuh load_bf16_row), with the tile
// origin 0; the replay, the reduction and the float32 gradient rows are the
// float32 path's. The gradient of the tile-local mean is that of the screen
// mean (the shift is a translation). Its rows are 32 bytes instead of 64;
// like the float32 replay it is bound by operations.

#include <cuda_runtime.h>

#include "stream_common.cuh"

namespace {

using namespace stream_common;

// kBf16: the rows are bf16 [I_pad, 16], tile-local (precision="bf16"),
// widened to float32 as they are staged; else float32 rows in screen
// coordinates, shifted by the tile's origin where they are read.
template <bool kBf16>
__global__ void __launch_bounds__(kPixels, 3) stream_bwd_kernel(
    const void* __restrict__ props_v, const float* __restrict__ tiledata,
    const int* __restrict__ chunk_start, const int* __restrict__ chunk_end, int chunk,
    int grid_w, int n_tiles, float4* __restrict__ dprops) {
  extern __shared__ float4 smem[];
  const ReplaySmem sm = replay_smem(smem);
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int job_row = p / kSegments;  // the reduce phase's job: row of the batch,
  const int seg = p % kSegments;      // and pixel segment
  const long long r0 = (long long)chunk_start[t] * chunk;
  const long long r1 = (long long)chunk_end[t] * chunk;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  long long base = r0;
  if (t < n_tiles) {
    const float px = (float)(p % kTile);
    const float py = (float)(p / kTile);
    const float ox = kBf16 ? 0.0f : (float)((t % grid_w) * kTile);
    const float oy = kBf16 ? 0.0f : (float)((t / grid_w) * kTile);
    // The tile's residual/cotangent rows: C_total 0:3, T_final 3, gC 4:7, gT 7.
    const float* td = tiledata + (size_t)t * 8 * kPixels + p;
    const float gc0 = td[4 * kPixels], gc1 = td[5 * kPixels], gc2 = td[6 * kPixels];
    const float gdot_total = gc0 * td[0] + gc1 * td[kPixels] + gc2 * td[2 * kPixels];
    const float gt_final = td[7 * kPixels] * td[3 * kPixels];
    sm.gc[pad_pixel(p)] = make_float4(gc0, gc1, gc2, 0.0f);

    float T = 1.0f, S = 0.0f;
    int done = 0;
    for (; base < r1; base += kReplayRows) {
      const int n = (int)min((long long)kReplayRows, r1 - base);
      if constexpr (kBf16) {
        const uint4* src = static_cast<const uint4*>(props_v) + base * kRowBf16V;
        if (p < n) {
          float4 v0, v1;
          float opac;
          load_bf16_row(src + p * kRowBf16V, v0, v1, opac);
          sm.rows[p * kRowV] = v0;
          sm.rows[p * kRowV + 1] = v1;
          sm.rows[p * kRowV + 2] = make_float4(opac, 0.0f, 0.0f, 0.0f);
        }
      } else {
        const float4* src = static_cast<const float4*>(props_v) + base * kRowV;
        for (int i = p; i < n * kRowV; i += kPixels) sm.rows[i] = src[i];
      }
      __syncthreads();  // the batch's rows (and gC) are staged
      for (int k = 0; k < n; ++k) {
        float gp = 0.0f, w = 0.0f;
        bool live = false;
        if (!done) {
          const float4 v0 = sm.rows[k * kRowV];      // x, y, a, b
          const float4 v1 = sm.rows[k * kRowV + 1];  // c, r, g, b
          const float opac = sm.rows[k * kRowV + 2].x;
          const float power =
              splat_power(__fsub_rn(v0.x, ox), __fsub_rn(v0.y, oy), v0.z, v0.w, v1.x, px, py);
          live = replay_step(power, opac, v1, gc0, gc1, gc2, gdot_total, gt_final, T, S, done, gp, w);
        }
        replay_store(sm, k, p, live, gp, w);
      }
      __syncthreads();  // the batch's (g_power, w) are stored
      float m[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) m[j] = 0.0f;
      if (job_row < n && segment_bits(sm, job_row, seg) != 0u) {
        const float2* gw = sm.gw + job_row * kPadRow + seg * kSegStride;
        const float4* gc = sm.gc + seg * kSegStride;
        // The segment's pixel rows in order; each row's sums of g_power,
        // g_power px and g_power px^2 first, then its py folded in.
        for (int r = 0; r < kSegPixels / kTile; ++r) {
          float a0 = 0.0f, ax = 0.0f, axx = 0.0f;
#pragma unroll 4
          for (int x = 0; x < kTile; ++x) {
            const float2 v = gw[r * kTile + x];
            const float4 c = gc[r * kTile + x];
            const float fx = (float)x;
            a0 += v.x;
            ax += v.x * fx;
            axx += v.x * (fx * fx);
            m[6] += v.y * c.x;
            m[7] += v.y * c.y;
            m[8] += v.y * c.z;
          }
          const float fy = (float)(seg * (kSegPixels / kTile) + r);
          m[0] += a0;
          m[1] += ax;
          m[2] += fy * a0;
          m[3] += axx;
          m[4] += (fy * fy) * a0;
          m[5] += fy * ax;
        }
      }
      sum_segments(m);
      if (job_row < n && seg < kRowV) {
        const float4 v0 = sm.rows[job_row * kRowV];
        const float4 v1 = sm.rows[job_row * kRowV + 1];
        const float opac = sm.rows[job_row * kRowV + 2].x;
        const float x = v0.x - ox, y = v0.y - oy;
        const float a = v0.z, b = v0.w, c = v1.x;
        const float s_dx = x * m[0] - m[1];  // sum_p g_power dx
        const float s_dy = y * m[0] - m[2];
        float4 o = zero4;
        if (seg == 0) {
          o = make_float4(-(a * s_dx + b * s_dy), -(c * s_dy + b * s_dx),
                          -0.5f * (x * x * m[0] - 2.0f * x * m[1] + m[3]),
                          -(x * y * m[0] - x * m[2] - y * m[1] + m[5]));
        } else if (seg == 1) {
          o = make_float4(-0.5f * (y * y * m[0] - 2.0f * y * m[2] + m[4]), m[6], m[7], m[8]);
        } else if (seg == 2) {
          o.x = m[0] / fmaxf(opac, 1e-12f);
        }
        dprops[(base + job_row) * kRowV + seg] = o;
      }
      if (__syncthreads_count(done) == kPixels) {  // also: the batch is consumed
        base += kReplayRows;
        break;
      }
    }
  }
  // Rows past the termination of every pixel, and the trash chunks.
  for (long long i = base * kRowV + p; i < r1 * kRowV; i += kPixels) dprops[i] = zero4;
}

template <bool kBf16>
int launch(const void* props, const void* tiledata, const void* chunk_start, const void* chunk_end,
           int chunk, int grid_w, int n_tiles, void* dprops, void* stream) {
  static bool smem_opted_in = false;
  const cudaError_t err = replay_smem_opt_in(stream_bwd_kernel<kBf16>, smem_opted_in);
  if (err != cudaSuccess) return (int)err;
  // n_tiles + 1 blocks: block n_tiles zeroes the trash chunks.
  stream_bwd_kernel<kBf16><<<n_tiles + 1, kPixels, kReplaySmemBytes, (cudaStream_t)stream>>>(
      props, (const float*)tiledata, (const int*)chunk_start, (const int*)chunk_end, chunk, grid_w,
      n_tiles, (float4*)dprops);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stream_bwd(const void* props, const void* tiledata, const void* chunk_start,
                          const void* chunk_end, int chunk, int grid_w, int n_tiles,
                          void* dprops, void* stream) {
  return launch<false>(props, tiledata, chunk_start, chunk_end, chunk, grid_w, n_tiles, dprops, stream);
}

// precision="bf16": the same replay on the bf16 tile-local rows the forward
// read (the autograd node saves them), float32 gradient rows out.
extern "C" int stream_bwd_bf16(const void* props, const void* tiledata, const void* chunk_start,
                               const void* chunk_end, int chunk, int grid_w, int n_tiles,
                               void* dprops, void* stream) {
  return launch<true>(props, tiledata, chunk_start, chunk_end, chunk, grid_w, n_tiles, dprops, stream);
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
