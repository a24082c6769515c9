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
// sentinel and never contribute. (Stopping at counts[t] itself gained 1-2%,
// below what a step must gain to stay.) Outputs the pre-background color
// [T, 3, 256] and final transmittance [T, 256] (the background blend stays
// in PyTorch).
//
// Design. K1's (stream_fwd.cu): one CTA of 256 threads per tile, and the
// walk is the same stream_common.cuh forward_walk (8x4-pixel warps, rows
// staged 256 at a time in shared memory, a skip test before the expf, a
// block-wide exit once every pixel has terminated). The TPU kernel
// ran 8 tiles per program to amortize grid steps and walked 32-row chunks
// with Hillis-Steele scans across them; here a tile is a block and each
// thread walks its pixel's rows sequentially. The means in the table and the
// pixel centers are ABSOLUTE screen coordinates, as the reference evaluates
// them (the walk's frame origin is 0).
//
// Bound. As K1: per walked (row, pixel) pair ~14 fp32 operations plus one
// expf (most pairs skip before the expf), ~6 more where the row contributes,
// on 36 useful bytes per row shared by 256 pixels, so it is bound by
// operations. The table pads every tile to K rows; only the walked rows are
// read.
//
// The per-pair arithmetic is stream_common.cuh's, shared with the backward
// (table_bwd.cu), which replays this walk bit for bit.

#include <cuda_runtime.h>

#include "stream_common.cuh"

namespace {

using namespace stream_common;

__global__ void __launch_bounds__(kPixels) table_fwd_kernel(
    const float4* __restrict__ props, const int* __restrict__ counts, int K, int grid_w,
    float* __restrict__ color, float* __restrict__ final_t) {
  __shared__ FwdBatch buf;
  const int t = blockIdx.x;
  const int p = fwd_pixel(threadIdx.x);
  forward_walk<RowStager>(buf, props + (size_t)t * K * kRowV, walked_rows(counts[t], K), 0.0f, 0.0f, p,
                          (float)((t % grid_w) * kTile + p % kTile),
                          (float)((t / grid_w) * kTile + p / kTile), color + (size_t)t * 3 * kPixels,
                          final_t + (size_t)t * kPixels);
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
