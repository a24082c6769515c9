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
// Design. The third entry point of stream_common.cuh forward_walk, beside
// K1 and K5: one CTA of 256 threads per tile, 8x4-pixel warps, batches of
// 256 rows in shared memory, the exp-free skip test before expf, and a
// block-wide exit once every pixel has terminated. Block t walks only its
// run's real rows [row_start[t], row_end[t]) (the wrapper's
// stream.real_row_ranges from the tile counts, as K1's), never the sentinel
// rows of the run's chunk padding. The frame is K5's (origin 0, absolute
// pixel centres), and so are the rows' staged slots: only the stager
// differs (stream_common.cuh PlaneStager: thread k reads row k's 9 used
// planes, each plane a coalesced 1 KB run across the block, 36 bytes a row
// where K1 stages all 64). So on the same rows K7's outputs equal K5's bit
// for bit, in every tile. The TPU kernel put instances on lanes and scanned
// T along them; here each thread walks its pixel's rows sequentially.
//
// Bound. As K1: per walked (row, pixel) pair ~14 fp32 operations plus one
// expf (most pairs skip before the expf), ~6 more where the row
// contributes, on 36 bytes per row shared by 256 pixels, so it is bound by
// operations. The early exit keeps the pair count down.
//
// The per-pair arithmetic is stream_common.cuh's, shared with the backward
// (stream_t_bwd.cu), which replays this walk bit for bit.

#include <cuda_runtime.h>

#include "stream_common.cuh"

namespace {

using namespace stream_common;

__global__ void __launch_bounds__(kPixels) stream_t_fwd_kernel(
    const float* __restrict__ props_t, const int* __restrict__ row_start,
    const int* __restrict__ row_end, long long ld, int grid_w, float* __restrict__ color,
    float* __restrict__ final_t) {
  __shared__ FwdBatch buf;
  const int t = blockIdx.x;
  const int p = fwd_pixel(threadIdx.x);
  const int r0 = row_start[t];
  forward_walk<PlaneStager>(buf, PlaneRows{props_t + r0, ld}, row_end[t] - r0, 0.0f, 0.0f, p,
                            (float)((t % grid_w) * kTile + p % kTile),
                            (float)((t / grid_w) * kTile + p / kTile), color + (size_t)t * 3 * kPixels,
                            final_t + (size_t)t * kPixels);
}

}  // namespace

extern "C" int stream_t_fwd(const void* props_t, const void* row_start, const void* row_end,
                            long long ld, int grid_w, int n_tiles, void* color, void* final_t,
                            void* stream) {
  if (n_tiles > 0) {
    stream_t_fwd_kernel<<<n_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (const float*)props_t, (const int*)row_start, (const int*)row_end, ld, grid_w,
        (float*)color, (float*)final_t);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
