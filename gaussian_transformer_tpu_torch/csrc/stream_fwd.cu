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
// Design. One CTA of 256 threads per tile. The TPU kernel walked the whole
// stream in order on one core and carried the transmittance across grid
// steps, flushing per-tile accumulators by DMA; here tiles are independent
// blocks, and block t walks only its run's real rows [row_start[t],
// row_end[t]) (the wrapper's stream.real_row_ranges: a run starts on a chunk
// and pads only at its tail, so its first tile_counts[t] rows are the real
// ones; row_end never passes the run's padded end). The walk itself is
// stream_common.cuh forward_walk with the row stager, shared with K5 and K7
// (table_fwd.cu, stream_t_fwd.cu): 8x4-pixel warps, rows staged 256 at a
// time in shared memory, a skip test before the expf, and a block-wide exit
// once every pixel has terminated. Means are
// shifted into the tile-local frame once per row at staging (dx = (x -
// tile_origin) - px_local, as the TPU kernel evaluates it).
//
// Bound. Per walked (row, pixel) pair ~14 fp32 operations plus one expf
// (most pairs skip before the expf), on 36 useful bytes per row shared by
// 256 pixels, so it is bound by operations (fp32 outside the tensor cores),
// not by memory. The early exit is what keeps the pair count down.
//
// The per-pair arithmetic is stream_common.cuh's, shared with the backward
// (stream_bwd.cu), which replays this walk bit for bit.
//
// precision="bf16" (stream_fwd_bf16) replaces the same TPU kernel in its
// local_coords mode (stream.py:783, rows from _kernel_props :751): the rows
// arrive as bf16, already in the tile's frame, and Bf16RowStager widens them
// to float32 at staging; the walk and its accumulators are the float32
// path's. It halves the row bytes (32 instead of 64), but the kernel is
// bound by operations, so the bytes are not what limits it.
//
// Property row layout (16 floats, or 16 bf16): x, y, conic a, b, c, r, g, b,
// opacity, pad.

#include <cuda_runtime.h>

#include "stream_common.cuh"

namespace {

using namespace stream_common;

// One block per tile; Stager is the row layout: RowStager (float32 rows,
// means shifted by the tile's origin at staging) or Bf16RowStager (bf16
// tile-local rows, origin 0).
template <typename Stager>
__global__ void __launch_bounds__(kPixels) stream_fwd_kernel(
    typename Stager::Src __restrict__ props, const int* __restrict__ row_start,
    const int* __restrict__ row_end, int grid_w, float* __restrict__ color,
    float* __restrict__ final_t) {
  __shared__ FwdBatch buf;
  const int t = blockIdx.x;
  const int p = fwd_pixel(threadIdx.x);
  const int r0 = row_start[t];
  const float ox = Stager::kTileLocal ? 0.0f : (float)((t % grid_w) * kTile);
  const float oy = Stager::kTileLocal ? 0.0f : (float)((t / grid_w) * kTile);
  forward_walk<Stager>(buf, props + (size_t)r0 * Stager::kRowVecs, row_end[t] - r0, ox, oy, p,
                       (float)(p % kTile), (float)(p / kTile), color + (size_t)t * 3 * kPixels,
                       final_t + (size_t)t * kPixels);
}

template <typename Stager>
int launch(const void* props, const void* row_start, const void* row_end, int grid_w, int n_tiles,
           void* color, void* final_t, void* stream) {
  if (n_tiles > 0) {
    stream_fwd_kernel<Stager><<<n_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (typename Stager::Src)props, (const int*)row_start, (const int*)row_end, grid_w, (float*)color,
        (float*)final_t);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stream_fwd(const void* props, const void* row_start, const void* row_end, int grid_w,
                          int n_tiles, void* color, void* final_t, void* stream) {
  return launch<RowStager>(props, row_start, row_end, grid_w, n_tiles, color, final_t, stream);
}

// precision="bf16": the same walk on bf16 tile-local rows [I_pad, 16] (32
// bytes a row, 16-byte aligned).
extern "C" int stream_fwd_bf16(const void* props, const void* row_start, const void* row_end,
                               int grid_w, int n_tiles, void* color, void* final_t, void* stream) {
  return launch<Bf16RowStager>(props, row_start, row_end, grid_w, n_tiles, color, final_t, stream);
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
