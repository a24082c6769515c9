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

#include <cuda_bf16.h>
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

// Rows of a table tile the walks read (K5, K6 and the plain versions): its
// count rounded up to the reference's 32-row chunk, at most K.
constexpr int kChunk = 32;
__device__ __forceinline__ int walked_rows(int count, int K) {
  return min((max(count, 0) + kChunk - 1) / kChunk * kChunk, K);
}

// ---- The forward walk (K1 stream_fwd.cu, K5 table_fwd.cu, K7 stream_t_fwd.cu) ----
//
// One walk, three entry points: a block of 256 threads composites one 16x16
// tile over n contiguous rows, front to back. K1 passes its tile's real
// stream rows in the tile-local frame (origin = the tile's corner, pixel
// centers 0..15); K5 its table slab's walked_rows in screen coordinates
// (origin 0, absolute pixel centers); K7 its tile's real rows of the
// transposed stream (planes), in K5's frame. The zero sentinel rows past a
// tile's real count never contribute and never stop a pixel (alpha 0 <
// 1/255), so where K1 and K7 end their runs changes no output bit. The
// layout is a compile-time choice, the stager (RowStager, PlaneStager);
// everything after staging is one code path.
//
// Pixel map. Warp w, lane l takes the pixel at column (w & 1) * 8 + (l & 7),
// row (w >> 1) * 4 + (l >> 3): a warp covers an 8x4 block, whose shorter
// perimeter leaves more of its steps uniform (all lanes skip, or none) than
// a 16x2 strip. Outputs stay indexed by pixel.
//
// Staging. Batches of 256 rows in shared memory: each row's (x, y, a, b)
// and (c, r, g, b) float4, and its head (x - ox, y - oy, P_row, opacity),
// so the frame shift and the skip floor are computed once per row. Rows:
// the threads copy the float4 and thread k writes row k's head. Planes:
// thread k reads row k's 9 used planes (one coalesced 1 KB run per plane
// across the block) and writes all three slots of row k; the origin is 0
// and fl(x - 0) = x, so its head holds x and y as read. Two barriers a
// batch (staged; consumed, which __syncthreads_count also uses to stop the
// block once every pixel has terminated). 12 KB of shared memory a block.
//
// Exp-free skip. The walk first forms power (splat_power, unchanged) and
// skips the pair when power < P_row, before expf; a warp whose live lanes
// all skip takes that branch together. P_row = fl(logf(fl(1/255 / opacity))
// - m), m = kSkipMargin = 1e-3, is formed once per row at staging (1/255
// stands for kMinAlpha, the float). Claim: power < P_row implies the exact
// test skips, i.e. power > 0 or fl(opacity * expf(min(power, 0))) < 1/255
// (then so is the capped alpha, 0.99 > 1/255). Proof, for 0 < opacity <=
// 1e30 (CUDA's error bounds: __fdiv_rn and __fsub_rn correctly rounded, logf
// 1 ulp, expf 2 ulp):
//   q = fl(1/255 / opacity) = (1/255 / opacity)(1 + d), |d| <= 2^-24, and q
//     is a normal float or +inf (1/255 / 1e30 > 2^-126);
//   if q = +inf, P_row = +inf and opacity < 1/255 / FLT_MAX, so any alpha is
//     below 1/255; otherwise |ln q| < 89, logf(q) = ln q + e, |e| <= 2^-17,
//     and P_row <= logf(q) - m + 2^-18;
//   so power < P_row gives opacity e^power < (1/255) exp(2^-24 + 2^-17 +
//     2^-18 - m); with power <= 0 (else the exact test skips), expf(power)
//     <= e^power (1 + 2^-22) where the result is normal, and the product
//     rounds up by at most (1 + 2^-24): alpha < (1/255) exp(2.4e-5 - m) <
//     1/255. Where expf(power) is subnormal (power < -87.3), opacity * expf
//     <= 1e30 * 2^-126 < 1/255.
// Other opacities: 0 (either sign) gives P_row = +inf, every pair with a
// number for power skips, as the exact test does (alpha = 0); negative,
// NaN or above 1e30 gives P_row = -inf, the exact path. power = NaN fails
// the comparison (the exact path); power = -inf skips, as expf(-inf) = 0
// does. Only skips move earlier, so every output bit stays as it was.

constexpr int kFwdBatch = kPixels;  // rows per staged batch: one head per thread
constexpr float kSkipMargin = 1e-3f;
constexpr float kSkipMaxOpacity = 1e30f;

struct FwdBatch {
  float4 raw[kFwdBatch * 2];  // per row: (x, y, a, b), (c, r, g, b)
  float4 head[kFwdBatch];     // per row: (x - ox, y - oy, P_row, opacity)
};

// The pixel (index y * 16 + x in the tile) of thread tid.
__device__ __forceinline__ int fwd_pixel(int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  return ((warp >> 1) * 4 + (lane >> 3)) * kTile + (warp & 1) * 8 + (lane & 7);
}

// P_row: a pair whose power is below it skips (see the proof above).
__device__ __forceinline__ float skip_floor(float opac) {
  if (opac > 0.0f && opac <= kSkipMaxOpacity)
    return __fsub_rn(logf(__fdiv_rn(kMinAlpha, opac)), kSkipMargin);
  return __uint_as_float(opac == 0.0f ? 0x7f800000u : 0xff800000u);  // +inf : -inf
}

// Stages rows [0, n) of src into b.
__device__ __forceinline__ void stage_batch(FwdBatch& b, const float4* __restrict__ src, int n,
                                            int tid, float ox, float oy) {
  for (int i = tid; i < 2 * n; i += kPixels) b.raw[i] = src[(i >> 1) * kRowV + (i & 1)];
  if (tid < n) {
    const float2 xy = __ldg(reinterpret_cast<const float2*>(src + tid * kRowV));
    const float opac = __ldg(reinterpret_cast<const float*>(src + tid * kRowV + 2));
    b.head[tid] = make_float4(__fsub_rn(xy.x, ox), __fsub_rn(xy.y, oy), skip_floor(opac), opac);
  }
}

// One pixel's walk over the n rows of a staged batch.
__device__ __forceinline__ void walk_batch(const FwdBatch& b, int n, float px, float py, float& T,
                                           float& c0, float& c1, float& c2, int& done) {
  for (int k = 0; k < n; ++k) {
    const float4 h = b.head[k];          // x - ox, y - oy, P_row, opacity
    const float4 v0 = b.raw[2 * k];      // x, y, a, b
    const float4 v1 = b.raw[2 * k + 1];  // c, r, g, b
    const float power = splat_power(h.x, h.y, v0.z, v0.w, v1.x, px, py);
    if (power < h.z) continue;
    const float alpha = fminf(kAlphaCap, splat_alpha_raw(h.w, power));
    if (splat_skipped(power, alpha)) continue;
    const float test_t = next_t(T, alpha);
    if (test_t < kMinT) {
      done = 1;
      return;
    }
    const float w = alpha * T;
    c0 += v1.y * w;
    c1 += v1.z * w;
    c2 += v1.w * w;
    T = test_t;
  }
}

// A stager puts rows [base, base + n) of its source into a batch. The walk
// takes it as a template type with the source, origin and pixel as plain
// parameters: so K1 and K5 compile to the machine code they had before K7
// shared the walk (a stager object renumbered their registers). The row
// layout's (K1, K5): rows of 16 floats from src, means shifted by (ox, oy).
// kRowVecs is a row's stride in Src elements; kTileLocal says the rows'
// means are already in the tile's frame (the caller passes origin 0).
struct RowStager {
  using Src = const float4*;
  static constexpr int kRowVecs = kRowV;
  static constexpr bool kTileLocal = false;
  static __device__ __forceinline__ void stage(FwdBatch& b, const float4* __restrict__ src, int base, int n,
                                               int tid, float ox, float oy) {
    stage_batch(b, src + (size_t)base * kRowV, n, tid, ox, oy);
  }
};

// The bf16 row layout (K1 and K2 at precision="bf16"): a row is the 16
// columns as bf16, 32 bytes, two uint4, with means already tile-local (the
// wrapper shifted them in float32 before rounding, stream.py kernel_props).
// A row is widened to float32 exactly (__bfloat162float) at staging, so
// everything after staging is the float32 code path.
constexpr int kRowBf16V = 2;  // uint4 per bf16 row

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
}

// Row r of a bf16 stream as float32: v0 = (x, y, a, b), v1 = (c, r, g, b),
// and the opacity (column 8). Two 16-byte loads.
__device__ __forceinline__ void load_bf16_row(const uint4* __restrict__ row, float4& v0, float4& v1,
                                              float& opac) {
  const uint4 lo = __ldg(row), hi = __ldg(row + 1);
  v0 = make_float4(bf16_lo(lo.x), bf16_hi(lo.x), bf16_lo(lo.y), bf16_hi(lo.y));
  v1 = make_float4(bf16_lo(lo.z), bf16_hi(lo.z), bf16_lo(lo.w), bf16_hi(lo.w));
  opac = bf16_lo(hi.x);
}

// The bf16 layout's stager (K1 at precision="bf16"): thread k widens row k
// and writes its raw slots and its head. The origin is 0 and fl(x - 0) = x,
// so the head holds x and y as widened; zero rows (sentinels, shifted to
// x = -ox with opacity 0) get the skip floor +inf, as in the float32 walk.
struct Bf16RowStager {
  using Src = const uint4*;
  static constexpr int kRowVecs = kRowBf16V;
  static constexpr bool kTileLocal = true;
  static __device__ __forceinline__ void stage(FwdBatch& b, const uint4* __restrict__ src, int base, int n,
                                               int tid, float, float) {
    if (tid < n) {
      float4 v0, v1;
      float opac;
      load_bf16_row(src + (size_t)(base + tid) * kRowBf16V, v0, v1, opac);
      b.raw[2 * tid] = v0;
      b.raw[2 * tid + 1] = v1;
      b.head[tid] = make_float4(v0.x, v0.y, skip_floor(opac), opac);
    }
  }
};

// The forward walk of one tile: rows [0, n_rows) of src as Stager stages
// them, means shifted by (ox, oy), this thread's pixel p at (px, py) in
// that frame. Writes the pre-background color planes color[0 / 256 / 512 +
// p] and final_t[p].
template <typename Stager>
__device__ __forceinline__ void forward_walk(FwdBatch& buf, typename Stager::Src src, int n_rows,
                                             float ox, float oy, int p, float px, float py,
                                             float* __restrict__ color, float* __restrict__ final_t) {
  const int tid = threadIdx.x;
  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int done = 0;
  for (int base = 0; base < n_rows; base += kFwdBatch) {
    const int n = min(kFwdBatch, n_rows - base);
    Stager::stage(buf, src, base, n, tid, ox, oy);  // the last batch is consumed
    __syncthreads();
    if (!done) walk_batch(buf, n, px, py, T, c0, c1, c2, done);
    if (__syncthreads_count(done) == kPixels) break;
  }
  color[p] = c0;
  color[kPixels + p] = c1;
  color[2 * kPixels + p] = c2;
  final_t[p] = T;
}

// The transposed stream layout (stream_t_fwd.cu, stream_t_bwd.cu): plane j
// of row r at props_t[j * ld + r]. The walks read planes 0-8 (x, y, conic
// a, b, c, r, g, b, opacity).
constexpr int kUsedPlanes = 9;

// The transposed layout's stager (K7): thread k reads row k's 9 used planes
// (plane j at rows[j * ld]). Its frame is the screen's: the origin is 0 and
// fl(x - 0) = x, so the head takes x and y as read.
struct PlaneRows {
  const float* rows;  // plane 0 at the walk's first row
  long long ld;       // the plane stride
};
struct PlaneStager {
  using Src = PlaneRows;
  static __device__ __forceinline__ void stage(FwdBatch& b, PlaneRows planes, int base, int n, int tid,
                                               float, float) {
    if (tid < n) {
      const float* src = planes.rows + base + tid;
      const long long ld = planes.ld;
      float v[kUsedPlanes];
#pragma unroll
      for (int j = 0; j < kUsedPlanes; ++j) v[j] = __ldg(src + j * ld);
      b.raw[2 * tid] = make_float4(v[0], v[1], v[2], v[3]);
      b.raw[2 * tid + 1] = make_float4(v[4], v[5], v[6], v[7]);
      b.head[tid] = make_float4(v[0], v[1], skip_floor(v[8]), v[8]);
    }
  }
};

// ---- The backward replay (stream_bwd.cu, table_bwd.cu, stream_t_bwd.cu) ----

// One (row, pixel) step of a backward's replay, given the row's power in the
// forward's frame: the forward's alpha and T walk, then, with w = alpha T and
// S the running (inclusive) sum of w <rgb, gC>, the suffix identity
//   g_alpha = <rgb, gC> T + (S - <gC, C_total> - gT T_final) / max(1 - alpha, 1e-6)
// and gp = g_alpha alpha, which stays as the caller set it (0) at the 0.99
// cap. Returns whether the row contributes to the pixel (then w is set and T
// updated); sets done where the pixel stops at this row. v1 is the row's
// (c, r, g, b).
__device__ __forceinline__ bool replay_step(float power, float opac, float4 v1, float gc0, float gc1,
                                            float gc2, float gdot_total, float gt_final, float& T,
                                            float& S, int& done, float& gp, float& w) {
  const float alpha_raw = splat_alpha_raw(opac, power);
  const float alpha = fminf(kAlphaCap, alpha_raw);
  if (splat_skipped(power, alpha)) return false;
  const float test_t = next_t(T, alpha);
  if (test_t < kMinT) {
    done = 1;
    return false;
  }
  w = alpha * T;
  const float rdg = v1.y * gc0 + v1.z * gc1 + v1.w * gc2;
  S += w * rdg;
  if (!(alpha_raw > kAlphaCap)) {
    const float g_alpha = rdg * T + ((S - gdot_total) - gt_final) / fmaxf(1.0f - alpha, 1e-6f);
    gp = g_alpha * alpha;
  }
  T = test_t;
  return true;
}

// The reference's 9 per-pixel gradient terms of a (row, pixel) pair in the
// table and transposed backwards (pallas_composite.py:319-351,
// attic/stream_t.py:317-337), with dx = x - px and dy = y - py in absolute
// screen coordinates: x, y, conic a, b, c, rgb, then g_power (the opacity's,
// before the division by the opacity). Absolute coordinates lose digits in
// K2's moment form, so these are summed per pixel.
__device__ __forceinline__ void pixel_grad_terms(float gp, float w, float gc0, float gc1, float gc2,
                                                 float dx, float dy, float a, float b, float c,
                                                 float t[9]) {
  t[0] = gp * (-(a * dx) - b * dy);
  t[1] = gp * (-(c * dy) - b * dx);
  t[2] = gp * (-0.5f * dx * dx);
  t[3] = gp * (-(dx * dy));
  t[4] = gp * (-0.5f * dy * dy);
  t[5] = w * gc0;
  t[6] = w * gc1;
  t[7] = w * gc2;
  t[8] = gp;
}

// The per-batch reduction of K2, K6 and K8. The walk phase takes B = 32 rows;
// each thread (pixel) stores its (g_power, w) for every row of the batch,
// and lane 0 of each warp the warp's ballot of "contributes". Then the
// block's 256 threads take (row, segment) jobs: 32 rows x 8 segments of 32
// pixels (one warp's), the 8 jobs of a row on adjacent lanes. A job sums its
// segment's pixel terms in a fixed order (none if the segment's ballot is 0),
// and 8-wide xor shuffles add the row's partials (a + b == b + a, so every
// lane gets the same bits). Each segment is padded by one slot, so the 32
// lanes of a reduce warp read 32 banks (float2: 16 lanes per half-warp,
// float4: 8 per quarter) and the walk's consecutive pixels stay consecutive.
constexpr int kReplayRows = 32;                         // B, rows per batch
constexpr int kWarps = kPixels / 32;
constexpr int kSegments = kPixels / kReplayRows;        // reduce jobs per row
constexpr int kSegPixels = kPixels / kSegments;         // pixels per job (= B)
constexpr int kSegStride = kSegPixels + 1;              // padded
constexpr int kPadRow = kSegments * kSegStride;         // padded pixels per row
static_assert(kSegPixels == 32, "a segment is one warp's pixels, its ballot one word");

__device__ __forceinline__ int pad_pixel(int q) { return q + q / kSegPixels; }

struct ReplaySmem {
  float4* rows;   // [B * kRowV] the batch's property rows
  float4* gc;     // [kPadRow] gC per pixel (w unused)
  float2* gw;     // [B * kPadRow] (g_power, w) per (row, pixel)
  unsigned* bal;  // [B * kWarps] ballot of contributing pixels per (row, warp)
};

constexpr int kReplaySmemBytes =
    (int)(sizeof(float4) * (kReplayRows * kRowV + kPadRow) + sizeof(float2) * kReplayRows * kPadRow +
          sizeof(unsigned) * kReplayRows * kWarps);

__device__ __forceinline__ ReplaySmem replay_smem(float4* base) {
  ReplaySmem s;
  s.rows = base;
  s.gc = s.rows + kReplayRows * kRowV;
  s.gw = reinterpret_cast<float2*>(s.gc + kPadRow);
  s.bal = reinterpret_cast<unsigned*>(s.gw + kReplayRows * kPadRow);
  return s;
}

// The walk-phase store of pixel p's (g_power, w) at row k of the batch, and
// its warp's ballot. Every lane of every warp calls it for every row.
__device__ __forceinline__ void replay_store(const ReplaySmem& s, int k, int p, bool live, float gp,
                                             float w) {
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if ((p & 31) == 0) s.bal[k * kWarps + (p >> 5)] = ballot;
  s.gw[k * kPadRow + pad_pixel(p)] = make_float2(gp, w);
}

// The contributing pixels of segment seg of row k, as bits.
__device__ __forceinline__ unsigned segment_bits(const ReplaySmem& s, int k, int seg) {
  return s.bal[k * kWarps + seg];
}

// Adds the partials of a row's kSegments adjacent lanes; every lane ends
// with the row's sums.
template <int N>
__device__ __forceinline__ void sum_segments(float (&m)[N]) {
#pragma unroll
  for (int off = 1; off < kSegments; off <<= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) m[j] += __shfl_xor_sync(0xffffffffu, m[j], off);
  }
}

// Lets the kernel take kReplaySmemBytes of dynamic shared memory (above the
// 48 KB static limit) with the largest shared-memory carveout, so that three
// blocks fit on an SM. Once per process.
template <typename Kernel>
inline cudaError_t replay_smem_opt_in(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kReplaySmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

}  // namespace stream_common
