// Shared per-(row, pixel) arithmetic of the compositor kernels.
//
// A forward (stream_fwd.cu, table_fwd.cu) and its backward (stream_bwd.cu,
// table_bwd.cu) must agree bit for bit on every alpha and on the
// transmittance walk: the backward recomputes T, and a pixel whose T crosses
// 1e-4 one contribution earlier in one kernel than in the other would get a
// gradient for a contribution the image never had. So the kernels evaluate
// these inline functions, written with explicitly rounded operations
// (__fmul_rn and friends are never fused into FMAs), in the reference's
// operation order.
#pragma once

#include <cuda_runtime.h>

namespace stream_common {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per block, one per pixel
constexpr int kRowF = 16;               // floats per property row
constexpr int kRowV = kRowF / 4;        // float4 per property row

// The constants as the reference forms them: a double rounded to float.
constexpr float kAlphaCap = (float)0.99;
constexpr float kMinAlpha = (float)(1.0 / 255.0);
constexpr float kMinT = (float)1e-4;

// -0.5 * (a dx^2 + c dy^2) - b dx dy with dx = x - px, dy = y - py, where
// x, y is the splat's mean and px, py the pixel's integer center in the same
// frame: tile-local in the stream kernels, absolute screen coordinates in
// the table kernels (each as its reference evaluates them).
__device__ __forceinline__ float splat_power(float x, float y, float a, float b, float c,
                                             float px, float py) {
  const float dx = __fsub_rn(x, px);
  const float dy = __fsub_rn(y, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx), __fmul_rn(__fmul_rn(c, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(b, dx), dy));
}

// opacity * exp(min(power, 0)), before the 0.99 cap.
__device__ __forceinline__ float splat_alpha_raw(float opac, float power) {
  return __fmul_rn(opac, expf(fminf(power, 0.0f)));
}

// The upstream skip rule: no contribution where power > 0 or alpha < 1/255.
__device__ __forceinline__ bool splat_skipped(float power, float alpha) {
  return power > 0.0f || alpha < kMinAlpha;
}

// Transmittance after a contribution of alpha; the pixel stops BEFORE the
// contribution that would take it below 1e-4.
__device__ __forceinline__ float next_t(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// Rows of a table tile the walk reads: its count rounded up to the
// reference's 32-row chunk, at most K.
constexpr int kChunk = 32;
__device__ __forceinline__ int walked_rows(int count, int K) {
  return min((max(count, 0) + kChunk - 1) / kChunk * kChunk, K);
}

// The transposed stream layout (stream_t_fwd.cu, stream_t_bwd.cu): plane j
// of row r at props_t[j * ld + r]. The walk reads planes 0-8 (x, y, conic
// a, b, c, r, g, b, opacity); a staged row keeps them 12 floats apart in
// shared memory (three float4, the last holding opacity), so the walk reads
// it as the row-layout kernels read theirs.
constexpr int kUsedPlanes = 9;
constexpr int kPlaneRowF = 12;
constexpr int kPlaneRowV = kPlaneRowF / 4;

// Row r's 9 used planes into dst[0..8]; a warp's threads on consecutive rows
// read each plane coalesced.
__device__ __forceinline__ void stage_planes(const float* __restrict__ props_t, long long ld,
                                             long long r, float* dst) {
#pragma unroll
  for (int j = 0; j < kUsedPlanes; ++j) dst[j] = __ldg(props_t + j * ld + r);
}

}  // namespace stream_common
