// Projection forward (K10) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's projection
// (gaussian_transformer_tpu/render/project.py project_gaussians, with the
// scene's activations in render/__init__.py project_view) is XLA-fused
// elementwise code. The port ran it as ~380 PyTorch elementwise launches
// over the scene's [C] columns, each shorter than its own launch, so the
// card sat idle while the host issued them. K10 is the same function in one
// pass over the scene's stored leaves: per Gaussian, the activations (exp
// scale, normalised quaternion, sigmoid opacity times alive), the mean's
// projection and near cull, the EWA 2D covariance with its 0.3 dilation,
// the conic, the radius, the 1/255 binning extents, SH -> RGB (or the
// override colour) and the binning's include mask.
//
// Same bits. Every step is the plain chain's (render/project.py), in its
// order and with its rounding: one IEEE operation per PyTorch op
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so nothing contracts
// into an FMA), Python constants rounded to float32 as PyTorch rounds a
// scalar, PyTorch's CUDA forms of sigmoid (1 / (1 + expf(-x))), clamp
// (NaN passes), minimum (NaN wins) and vector_norm over 4 entries (squares
// summed pairwise as (q0^2 + q2^2) + (q1^2 + q3^2), the order of its
// four-lane warp reduction, found on the card against torch 2.11), expf /
// logf / sqrtf / ceilf as PyTorch calls them, and float -> int32
// conversion by truncation.
//
// Bound. Bytes: it reads 237 B a Gaussian at SH degree 3 (xyz 12, scaling
// 12, rotation 16, opacity 4, alive 1, features_dc 12, features_rest 180)
// and writes 57 B (means2d 8, depths 4, conics 12, radii 4, rgbs 12,
// opacities 4, radii_bin 4, rect_bin 8, include 1): 294 MB at 1M Gaussians,
// 0.088 ms at 3.35 TB/s, against ~400 fp32 operations a Gaussian.
//
// Design. One thread per Gaussian, 128 a block. The 180-byte
// features_rest rows are the bulk of the bytes; a thread reading its own
// row would have each warp load touch 32 rows 180 B apart, so the block
// first copies its 128 rows (one contiguous 23,040-byte span) into shared
// memory with 16-byte loads, neighbouring threads on neighbouring
// addresses, and each thread then reads its row there (a stride of 45
// words, odd, so no bank conflicts). The small leaves are read directly.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRest = 15;                 // features_rest rows (SH degree 3)
constexpr int kMaxRestFloats = 3 * kMaxRest;

// The plain chain's constants (utils/sh.py), rounded to float32 as PyTorch
// rounds a Python float multiplied into a float32 tensor.
constexpr float C0 = (float)0.28209479177387814;
constexpr float C1 = (float)0.4886025119029199;
constexpr float C2_0 = (float)1.0925484305920792;
constexpr float C2_1 = (float)-1.0925484305920792;
constexpr float C2_2 = (float)0.31539156525252005;
constexpr float C2_3 = (float)-1.0925484305920792;
constexpr float C2_4 = (float)0.5462742152960396;
constexpr float C3_0 = (float)-0.5900435899266435;
constexpr float C3_1 = (float)2.890611442640554;
constexpr float C3_2 = (float)-0.4570457994644658;
constexpr float C3_3 = (float)0.3731763325901154;
constexpr float C3_4 = (float)-0.4570457994644658;
constexpr float C3_5 = (float)1.445305721320277;
constexpr float C3_6 = (float)-0.5900435899266435;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(v, min=lo): NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

// torch.clamp(v, lo, hi).
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.minimum: a NaN operand wins.
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// px * M[0, j] + py * M[1, j] + pz * M[2, j] + M[3, j] of a row-major 4x4.
__device__ __forceinline__ float affine(const float* M, int j, float px, float py, float pz) {
  return add(add(add(mul(px, M[j]), mul(py, M[4 + j])), mul(pz, M[8 + j])), M[12 + j]);
}

// ((ndc + 1) * size - 1) * 0.5
__device__ __forceinline__ float ndc_to_pixel(float ndc, float size) {
  return mul(sub(mul(add(ndc, 1.0f), size), 1.0f), 0.5f);
}

struct Args {
  const float* xyz;            // [C, 3]
  const float* scaling;        // [C, 3] log scales
  const float* rotation;       // [C, 4] unnormalised wxyz
  const float* opacity;        // [C] logits
  const uint8_t* alive;        // [C] bool
  const float* features_dc;    // [C, 3]
  const float* features_rest;  // [C, R, 3]
  const float* override_color; // [C, 3] or null
  const float* wv;             // [4, 4] world_view_transform
  const float* fp;             // [4, 4] full_proj_transform
  const float* cc;             // [3] camera_center
  int n, rest, degree;
  float width, height, smod, fx, fy, limx, limy;
  float* means2d;              // [C, 2]
  float* depths;               // [C]
  float* conics;               // [C, 3]
  int* radii;                  // [C]
  float* rgbs;                 // [C, 3]
  float* opac;                 // [C]
  int* radii_bin;              // [C]
  int* rect_bin;               // [C, 2]
  uint8_t* include;            // [C] bool
};

// One colour channel of the plain chain's SH evaluation (eval_sh's order;
// degree 1 is project_gaussians' own branch, the same expression).
__device__ __forceinline__ float sh_channel(const float* rest, float dc, int ch, int degree, float x,
                                            float y, float z) {
  float r = mul(C0, dc);
  if (degree > 0) {
    r = sub(add(sub(r, mul(mul(C1, y), rest[0 * 3 + ch])), mul(mul(C1, z), rest[1 * 3 + ch])),
            mul(mul(C1, x), rest[2 * 3 + ch]));
    if (degree > 1) {
      const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
      const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
      r = add(r, mul(mul(C2_0, xy), rest[3 * 3 + ch]));
      r = add(r, mul(mul(C2_1, yz), rest[4 * 3 + ch]));
      r = add(r, mul(mul(C2_2, sub(sub(mul(2.0f, zz), xx), yy)), rest[5 * 3 + ch]));
      r = add(r, mul(mul(C2_3, xz), rest[6 * 3 + ch]));
      r = add(r, mul(mul(C2_4, sub(xx, yy)), rest[7 * 3 + ch]));
      if (degree > 2) {
        r = add(r, mul(mul(mul(C3_0, y), sub(mul(3.0f, xx), yy)), rest[8 * 3 + ch]));
        r = add(r, mul(mul(mul(C3_1, xy), z), rest[9 * 3 + ch]));
        r = add(r, mul(mul(mul(C3_2, y), sub(sub(mul(4.0f, zz), xx), yy)), rest[10 * 3 + ch]));
        r = add(r, mul(mul(mul(C3_3, z), sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy))),
                       rest[11 * 3 + ch]));
        r = add(r, mul(mul(mul(C3_4, x), sub(sub(mul(4.0f, zz), xx), yy)), rest[12 * 3 + ch]));
        r = add(r, mul(mul(mul(C3_5, z), sub(xx, yy)), rest[13 * 3 + ch]));
        r = add(r, mul(mul(mul(C3_6, x), sub(xx, mul(3.0f, yy))), rest[14 * 3 + ch]));
      }
    }
  }
  return clamp_min(add(r, 0.5f), 0.0f);
}

__global__ void __launch_bounds__(kThreads) project_fwd_kernel(Args a) {
  __shared__ __align__(16) float rest_s[kThreads * kMaxRestFloats];
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
  const int row = 3 * a.rest;
  const bool sh = a.override_color == nullptr && a.degree > 0;

  // Stage the block's features_rest rows: one contiguous span.
  if (sh) {
    const int n_here = min(kThreads, a.n - i0);
    const int total = n_here * row;
    const float* src = a.features_rest + (size_t)i0 * row;
    int start = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* dst4 = reinterpret_cast<float4*>(rest_s);
      for (int k = threadIdx.x; k < total / 4; k += kThreads) dst4[k] = __ldg(src4 + k);
      start = total / 4 * 4;
    }
    for (int k = start + threadIdx.x; k < total; k += kThreads) rest_s[k] = __ldg(src + k);
    __syncthreads();
  }
  if (i >= a.n) return;

  // The scene's activations (GaussianScene.get_*).
  const float px = a.xyz[3 * i], py = a.xyz[3 * i + 1], pz = a.xyz[3 * i + 2];
  const float sc0 = expf(a.scaling[3 * i]), sc1 = expf(a.scaling[3 * i + 1]), sc2 = expf(a.scaling[3 * i + 2]);
  const float q0 = a.rotation[4 * i], q1 = a.rotation[4 * i + 1], q2 = a.rotation[4 * i + 2],
              q3 = a.rotation[4 * i + 3];
  const float qn = clamp_min(sqrtf(add(add(mul(q0, q0), mul(q2, q2)), add(mul(q1, q1), mul(q3, q3)))), 1e-12f);
  const float r = dv(q0, qn), x = dv(q1, qn), y = dv(q2, qn), z = dv(q3, qn);
  const float opacity = mul(dv(1.0f, add(1.0f, expf(-a.opacity[i]))), a.alive[i] ? 1.0f : 0.0f);

  // Mean: view space, clip space, pixels.
  const float view_x = affine(a.wv, 0, px, py, pz);
  const float view_y = affine(a.wv, 1, px, py, pz);
  const float depth = affine(a.wv, 2, px, py, pz);
  const float hom_x = affine(a.fp, 0, px, py, pz);
  const float hom_y = affine(a.fp, 1, px, py, pz);
  const float hom_w = affine(a.fp, 3, px, py, pz);
  const float p_w = dv(1.0f, add(hom_w, 1e-7f));
  const bool in_front = depth > 0.2f;
  const float mean_x = ndc_to_pixel(mul(hom_x, p_w), a.width);
  const float mean_y = ndc_to_pixel(mul(hom_y, p_w), a.height);

  // World covariance (_cov3d_cols).
  const float s0 = mul(a.smod, sc0), s1 = mul(a.smod, sc1), s2 = mul(a.smod, sc2);
  const float R00 = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  const float R01 = mul(2.0f, sub(mul(x, y), mul(r, z)));
  const float R02 = mul(2.0f, add(mul(x, z), mul(r, y)));
  const float R10 = mul(2.0f, add(mul(x, y), mul(r, z)));
  const float R11 = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  const float R12 = mul(2.0f, sub(mul(y, z), mul(r, x)));
  const float R20 = mul(2.0f, sub(mul(x, z), mul(r, y)));
  const float R21 = mul(2.0f, add(mul(y, z), mul(r, x)));
  const float R22 = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
  const float M00 = mul(R00, s0), M01 = mul(R01, s1), M02 = mul(R02, s2);
  const float M10 = mul(R10, s0), M11 = mul(R11, s1), M12 = mul(R12, s2);
  const float M20 = mul(R20, s0), M21 = mul(R21, s1), M22 = mul(R22, s2);
  const float Sxx = add(add(mul(M00, M00), mul(M01, M01)), mul(M02, M02));
  const float Sxy = add(add(mul(M00, M10), mul(M01, M11)), mul(M02, M12));
  const float Sxz = add(add(mul(M00, M20), mul(M01, M21)), mul(M02, M22));
  const float Syy = add(add(mul(M10, M10), mul(M11, M11)), mul(M12, M12));
  const float Syz = add(add(mul(M10, M20), mul(M11, M21)), mul(M12, M22));
  const float Szz = add(add(mul(M20, M20), mul(M21, M21)), mul(M22, M22));

  // EWA 2D covariance (compute_cov2d_cols); W[r][c] = wv[c][r].
  const float tz = in_front ? depth : 1.0f;
  const float txtz = clamp(dv(view_x, tz), -a.limx, a.limx);
  const float tytz = clamp(dv(view_y, tz), -a.limy, a.limy);
  const float tx = mul(txtz, tz), ty = mul(tytz, tz);
  const float inv_z = dv(1.0f, tz);
  const float inv_z2 = mul(inv_z, inv_z);
  const float j00 = mul(a.fx, inv_z);
  const float j02 = mul(mul(-a.fx, tx), inv_z2);
  const float j11 = mul(a.fy, inv_z);
  const float j12 = mul(mul(-a.fy, ty), inv_z2);
  const float* Wv = a.wv;
  const float T00 = add(mul(j00, Wv[0]), mul(j02, Wv[2]));
  const float T01 = add(mul(j00, Wv[4]), mul(j02, Wv[6]));
  const float T02 = add(mul(j00, Wv[8]), mul(j02, Wv[10]));
  const float T10 = add(mul(j11, Wv[1]), mul(j12, Wv[2]));
  const float T11 = add(mul(j11, Wv[5]), mul(j12, Wv[6]));
  const float T12 = add(mul(j11, Wv[9]), mul(j12, Wv[10]));
  const float U00 = add(add(mul(T00, Sxx), mul(T01, Sxy)), mul(T02, Sxz));
  const float U01 = add(add(mul(T00, Sxy), mul(T01, Syy)), mul(T02, Syz));
  const float U02 = add(add(mul(T00, Sxz), mul(T01, Syz)), mul(T02, Szz));
  const float U10 = add(add(mul(T10, Sxx), mul(T11, Sxy)), mul(T12, Sxz));
  const float U11 = add(add(mul(T10, Sxy), mul(T11, Syy)), mul(T12, Syz));
  const float U12 = add(add(mul(T10, Sxz), mul(T11, Syz)), mul(T12, Szz));
  const float cov_xx = add(add(add(mul(U00, T00), mul(U01, T01)), mul(U02, T02)), 0.3f);
  const float cov_xy = add(add(mul(U00, T10), mul(U01, T11)), mul(U02, T12));
  const float cov_yy = add(add(add(mul(U10, T10), mul(U11, T11)), mul(U12, T12)), 0.3f);

  // Conic, radius, binning extents.
  const float det = sub(mul(cov_xx, cov_yy), mul(cov_xy, cov_xy));
  const bool valid_det = det != 0.0f;
  const float det_inv = dv(1.0f, valid_det ? det : 1.0f);
  const float mid = mul(0.5f, add(cov_xx, cov_yy));
  const float lambda1 = add(mid, sqrtf(clamp_min(sub(mul(mid, mid), det), 0.1f)));
  const float sqrt_l1 = sqrtf(clamp_min(lambda1, 0.0f));
  const float radius_f = ceilf(mul(3.0f, sqrt_l1));
  const bool visible = in_front && valid_det;
  const int radius = visible ? (int)radius_f : 0;
  const float ln_term = logf(clamp_min(mul(255.0f, opacity), 1.0f));
  const float r_eff = add(ceilf(mul(sqrtf(mul(2.0f, ln_term)), sqrt_l1)), 1.0f);
  const int radius_bin = min(radius, visible ? (int)r_eff : 0);
  const float rb = (float)radius_bin;
  const float rx_eff = minimum(rb, add(ceilf(sqrtf(mul(mul(2.0f, ln_term), clamp_min(cov_xx, 0.0f)))), 1.0f));
  const float ry_eff = minimum(rb, add(ceilf(sqrtf(mul(mul(2.0f, ln_term), clamp_min(cov_yy, 0.0f)))), 1.0f));
  const float opac = visible ? opacity : 0.0f;

  // Colour: the override, or SH at the view direction.
  float rgb[3];
  if (a.override_color != nullptr) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = a.override_color[3 * i + ch];
  } else {
    float dx = sub(px, a.cc[0]), dy = sub(py, a.cc[1]), dz = sub(pz, a.cc[2]);
    const float inv_n = dv(1.0f, clamp_min(sqrtf(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz))), 1e-12f));
    dx = mul(dx, inv_n);
    dy = mul(dy, inv_n);
    dz = mul(dz, inv_n);
    const float* rest = rest_s + threadIdx.x * row;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      rgb[ch] = sh_channel(rest, a.features_dc[3 * i + ch], ch, a.degree, dx, dy, dz);
    }
  }

  a.means2d[2 * i] = mean_x;
  a.means2d[2 * i + 1] = mean_y;
  a.depths[i] = depth;
  a.conics[3 * i] = mul(cov_yy, det_inv);
  a.conics[3 * i + 1] = mul(-cov_xy, det_inv);
  a.conics[3 * i + 2] = mul(cov_xx, det_inv);
  a.radii[i] = radius;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) a.rgbs[3 * i + ch] = rgb[ch];
  a.opac[i] = opac;
  a.radii_bin[i] = radius_bin;
  a.rect_bin[2 * i] = visible ? (int)rx_eff : 0;
  a.rect_bin[2 * i + 1] = visible ? (int)ry_eff : 0;
  a.include[i] = (radius > 0) && (opac >= (float)(1.0 / 255.0));
}

}  // namespace

extern "C" int project_fwd(const void* xyz, const void* scaling, const void* rotation, const void* opacity,
                           const void* alive, const void* features_dc, const void* features_rest,
                           const void* override_color, const void* wv, const void* fp, const void* cc, int n,
                           int rest, int degree, int width, int height, float smod, float fx, float fy,
                           float limx, float limy, void* means2d, void* depths, void* conics, void* radii,
                           void* rgbs, void* opac, void* radii_bin, void* rect_bin, void* include,
                           void* stream) {
  if (rest > kMaxRest || degree < 0 || degree > 3) return (int)cudaErrorInvalidValue;
  Args a;
  a.xyz = (const float*)xyz;
  a.scaling = (const float*)scaling;
  a.rotation = (const float*)rotation;
  a.opacity = (const float*)opacity;
  a.alive = (const uint8_t*)alive;
  a.features_dc = (const float*)features_dc;
  a.features_rest = (const float*)features_rest;
  a.override_color = (const float*)override_color;
  a.wv = (const float*)wv;
  a.fp = (const float*)fp;
  a.cc = (const float*)cc;
  a.n = n;
  a.rest = rest;
  a.degree = degree;
  a.width = (float)width;
  a.height = (float)height;
  a.smod = smod;
  a.fx = fx;
  a.fy = fy;
  a.limx = limx;
  a.limy = limy;
  a.means2d = (float*)means2d;
  a.depths = (float*)depths;
  a.conics = (float*)conics;
  a.radii = (int*)radii;
  a.rgbs = (float*)rgbs;
  a.opac = (float*)opac;
  a.radii_bin = (int*)radii_bin;
  a.rect_bin = (int*)rect_bin;
  a.include = (uint8_t*)include;
  if (n > 0) {
    project_fwd_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
