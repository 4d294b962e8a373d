// Stages A-C's per-splat work in one pass (ops/splat.py:splat_columns):
// one thread a splat evaluates its SH colour (stage A, ops/sh.py),
// projects it (stage B, ops/projection.py:project_splats), bins it (the
// per-splat half of stage C, ops/binning.py: splat_tile_rects,
// splat_row_packs, pack_columns) and writes the columns that K2
// (csrc/interleave.cu) takes, with the splat's exact candidate count.
//
// It replaces no Pallas kernel.  The JAX package writes stages A-C as
// plain jnp, which XLA fuses into a few passes on the TPU; eager PyTorch
// runs every one of their ~1,100 operations as a pass of its own over
// [N] rows.  The reference does the same work in two kernels
// (evaluateSphericalHarmonicsKernel, evaluateSplatClipDataKernel,
// GaussianRender.cu:158-348).
//
// Bound on this card: bytes.  A splat reads 224 B at SH degree 3 (means
// 12, scales 12, packed rotation 4, opacity 4, 3 x 16 coefficients 192)
// and writes 52 B (12 f32 columns and an int32 count; the alpha column is
// the scene's opacities, which K2 reads where they are): 276 B, 0.24 ms
// for 2.96 M splats at 3.35 TB/s.  The arithmetic (a 3x3 covariance, a 2x2
// eigen-solve, eight strip chords) is far below the card's f32 rate.  Every
// input is planar, a row of N values a component, so a warp reads 128
// contiguous bytes of each row.  The colour comes first, so that its 48
// loads are in flight while the thread projects and bins: 7% faster than
// the colour last, skipped for splats that own no slot (which saves
// nothing where nearly every splat owns one), and 128-thread blocks are 1%
// faster than 256 (PERF.md section 6).
//
// Every column but rgb equals the plain path's on the card bit for bit
// (one ulp of clip data can move a tile edge), so this file builds with
// --fmad=false (utils/cuda_build.py) and follows the plain path operation
// by operation: the same order, IEEE division and square root, torch's
// NaN-propagating maximum, minimum and clamp (not fmaxf alone), each
// Python float constant rounded to f32 where the plain path's tensor
// meets it (the host passes the config's constants so rounded), and a
// tensor divided by a Python float as PyTorch divides on the card: times
// the f32 reciprocal.  The rgb column may differ by one level a channel:
// cuBLAS sums the plain path's SH contraction in its own order.
//
// The config decides the code, never the scene: the SH degree is a template
// parameter (it sizes the basis and unrolls the contraction), and the
// opacity truncation and the centred runs are branches every thread takes
// alike.  The projection, the strip run and the colour are functions of
// their own: written as one body, the kernel took nvcc 65 s to build
// (cudafe++ 22.6 s, cicc 37.5 s), where so split all eight csrc/ sources
// build in 13.4 s together (PERF.md section 6).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPackRows = 8;
constexpr int kMaxPackW = 63;

// Opacity-aware truncation of the extents (config.opacity_aware_extents),
// by falloff.
constexpr int kTruncNone = 0, kTruncGaussian = 1, kTruncEpanechnikov = 2;

// A Python float literal as the plain path's f32 tensor op rounds it.
__host__ __device__ constexpr float f32(double x) { return static_cast<float>(x); }

constexpr float kStripEps = f32(1e-5);  // ops/binning.py:STRIP_EPS

// torch.maximum / torch.minimum: NaN when either operand is NaN.
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp with scalar bounds: NaN stays NaN.
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tclamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// utils/quantize.py:decode_quat_components on the card:
// ((packed >> shift) & 0xFF).to(float32) / 255.0 * 2.0 - 1.0.
__device__ __forceinline__ float quat_component(int packed, int shift) {
  constexpr float inv255 = 1.0f / 255.0f;
  return static_cast<float>((packed >> shift) & 0xFF) * inv255 * 2.0f - 1.0f;
}

// ops/geometry.py:pack_rgb_u32 as the f32 column pack_columns makes of it.
__device__ __forceinline__ float pack_rgb(float3 rgb) {
  const long long r = static_cast<long long>(tclamp(rgb.x, 0.0f, 1.0f) * 255.0f);
  const long long g = static_cast<long long>(tclamp(rgb.y, 0.0f, 1.0f) * 255.0f);
  const long long b = static_cast<long long>(tclamp(rgb.z, 0.0f, 1.0f) * 255.0f);
  return static_cast<float>(static_cast<int>((r << 16) | (g << 8) | b));
}

// ops/sh.py:sh_basis_components for unit direction (x, y, z), the first
// (kDegree + 1)^2 values, each with the plain path's operation order.
template <int kDegree>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* out) {
  out[0] = f32(0.28209479177387814);
  if constexpr (kDegree >= 1) {
    const float c1 = f32(0.4886025119029199);
    out[1] = c1 * y;
    out[2] = c1 * z;
    out[3] = c1 * x;
  }
  if constexpr (kDegree >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    out[4] = f32(1.0925484305920792) * xy;
    out[5] = f32(1.0925484305920792) * yz;
    out[6] = f32(0.31539156525252005) * (3.0f * zz - 1.0f);
    out[7] = f32(1.0925484305920792) * xz;
    out[8] = f32(0.5462742152960396) * (xx - yy);
    if constexpr (kDegree >= 3) {
      out[9] = f32(0.5900435899266435) * y * (3.0f * xx - yy);
      out[10] = f32(2.890611442640554) * xy * z;
      out[11] = f32(0.4570457994644658) * y * (5.0f * zz - 1.0f);
      out[12] = f32(0.3731763325901154) * z * (5.0f * zz - 3.0f);
      out[13] = f32(0.4570457994644658) * x * (5.0f * zz - 1.0f);
      out[14] = f32(1.445305721320277) * z * (xx - yy);
      out[15] = f32(0.5900435899266435) * x * (xx - 3.0f * yy);
    }
    if constexpr (kDegree >= 4) {
      out[16] = f32(2.5033429417967046) * xy * (xx - yy);
      out[17] = f32(1.7701307697799304) * yz * (3.0f * xx - yy);
      out[18] = f32(0.9461746957575601) * xy * (7.0f * zz - 1.0f);
      out[19] = f32(0.6690465435572892) * yz * (7.0f * zz - 3.0f);
      out[20] = f32(0.10578554691520431) * (35.0f * zz * zz - 30.0f * zz + 3.0f);
      out[21] = f32(0.6690465435572892) * xz * (7.0f * zz - 3.0f);
      out[22] = f32(0.47308734787878004) * (xx - yy) * (7.0f * zz - 1.0f);
      out[23] = f32(1.7701307697799304) * xz * (xx - 3.0f * yy);
      out[24] = f32(0.6258357354491761) * (xx * xx - 6.0f * xx * yy + yy * yy);
    }
  }
}

// ops/binning.py:splat_row_packs for rect row r (as a float): the run
// (w_r, dx_r) of tiles the ellipse's chords cover on that strip, 0 where
// the row is not ``open`` (past the rect's height, or the rect too wide to
// pack).
__device__ __forceinline__ float2 strip_run(float r, float y0f, float tch, float y_span,
                                            bool centered, float cx, float cy, float ry,
                                            float kstar, float p_inv_ry, float inv_ry2,
                                            float slope, float sx, float x0f, float x1f,
                                            bool open) {
  const float ya = (y0f + r) * tch - 1.0f;
  const float yb = ya + y_span;
  const float da = ya - cy;
  const float db = yb - cy;
  const float ka = tmin(tmax(da, -ry), ry);
  const float kb = tmin(tmax(db, -ry), ry);
  const float khi = tmin(tmax(kstar, ka), kb);
  const float klo = tmin(tmax(-kstar, ka), kb);
  const float s_hi = p_inv_ry * sqrtf(tclamp_min(1.0f - khi * khi * inv_ry2, 0.0f));
  const float s_lo = p_inv_ry * sqrtf(tclamp_min(1.0f - klo * klo * inv_ry2, 0.0f));
  const float xhi = cx + khi * slope + s_hi;
  const float xlo = cx + klo * slope - s_lo;
  const bool live = da <= ry + kStripEps && db >= -(ry + kStripEps) && open;
  float xl_t, xh_t;
  if (centered) {
    xl_t = tmin(tmax(ceilf((xlo - kStripEps + 1.0f) * sx - f32(15.0 / 16.0)), x0f), x1f);
    xh_t = tmin(tmax(floorf((xhi + kStripEps + 1.0f) * sx) + 1.0f, x0f), x1f);
  } else {
    xl_t = tmin(tmax(floorf((xlo - kStripEps + 1.0f) * sx), x0f), x1f);
    xh_t = tmin(tmax(ceilf((xhi + kStripEps + 1.0f) * sx), x0f), x1f);
  }
  const float w_r = live ? tclamp_min(xh_t - xl_t, 0.0f) : 0.0f;
  return make_float2(w_r, w_r > 0.0f ? xl_t - x0f : 0.0f);
}

struct Args {
  const float* means;      // [3, n]
  const float* scales;     // [3, n]
  const int* quats;        // [n] packed u32 bit patterns
  const float* opacities;  // [n]
  const float* colors;     // [3, n] baked colours (degree 0)
  const float* sh;         // [3, sh_k, n] (degree > 0)
  long long sh_k;
  // The camera in render.camera_views' layout: view [4, 4] row-major at 0,
  // position at 16, fov cotangents at 19, depth scale and bias at 21.  Read
  // on the device, so a graph replays with the camera refilled in place.
  const float* camera;
  long long n;
  // Config constants as the plain path's f32 ops round them.
  float bump_x, bump_y;    // (1/pi)(2/W)^2, (1/pi)(2/H)^2
  float eps;               // config.epsilon
  float sigma;             // config.sigma_factor
  float tch;               // 2 * tile_size / screen_h: a tile row in clip units
  float y_span;            // the strip's height: tch, or (15/16) tch centred
  float depth_scale;       // 2^bits - 1 of the quantised depth
  int trunc;               // kTrunc*: the extents' truncation by opacity
  bool centered;           // config.center_sampled_runs
  int tiles_x, tiles_y;
  // The tile-row band: *row_lo_ptr when given (a 0-d device tensor), else row_lo.
  int row_lo, row_hi;
  const int* row_lo_ptr;
  const int* row_hi_ptr;
  float* out;              // [12, n]
  int* counts;             // [n]
};

// One splat's ops/projection.py:SplatClipData.
struct Clip {
  float cx, cy, z, cos_t, sin_t, e0, e1, con_a, con_b, con_c;
};

// ops/projection.py:project_splats for splat i of opacity op.
__device__ __forceinline__ Clip project(const Args& a, long long i, float op) {
  const long long n = a.n;
  const float* __restrict__ v = a.camera;
  const float mx = a.means[i], my = a.means[n + i], mz = a.means[2 * n + i];
  const float sc0 = a.scales[i], sc1 = a.scales[n + i], sc2 = a.scales[2 * n + i];
  const int packed = a.quats[i];
  const float sx2 = sc0 * sc0, sy2 = sc1 * sc1, sz2 = sc2 * sc2;

  const float qx = quat_component(packed, 24), qy = quat_component(packed, 16);
  const float qz = quat_component(packed, 8), qw = quat_component(packed, 0);
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float r00 = 1.0f - 2.0f * (yy + zz);
  const float r01 = 2.0f * (xy - wz);
  const float r02 = 2.0f * (xz + wy);
  const float r10 = 2.0f * (xy + wz);
  const float r11 = 1.0f - 2.0f * (xx + zz);
  const float r12 = 2.0f * (yz - wx);
  const float r20 = 2.0f * (xz - wy);
  const float r21 = 2.0f * (yz + wx);
  const float r22 = 1.0f - 2.0f * (xx + yy);

  const float a00 = r00 * r00 * sx2 + r01 * r01 * sy2 + r02 * r02 * sz2;
  const float a11 = r10 * r10 * sx2 + r11 * r11 * sy2 + r12 * r12 * sz2;
  const float a22 = r20 * r20 * sx2 + r21 * r21 * sy2 + r22 * r22 * sz2;
  const float a01 = r00 * r10 * sx2 + r01 * r11 * sy2 + r02 * r12 * sz2;
  const float a02 = r00 * r20 * sx2 + r01 * r21 * sy2 + r02 * r22 * sz2;
  const float a12 = r10 * r20 * sx2 + r11 * r21 * sy2 + r12 * r22 * sz2;

  const float vx = v[0] * mx + v[1] * my + v[2] * mz + v[3];
  const float vy = v[4] * mx + v[5] * my + v[6] * mz + v[7];
  const float vz = v[8] * mx + v[9] * my + v[10] * mz + v[11];

  const float fc0 = v[19], fc1 = v[20];
  const float z_rcp = 1.0f / vz;
  const float z_rcp_sqr = z_rcp * z_rcp;
  const float scale_x = -fc0 * z_rcp;
  const float scale_y = -fc1 * z_rcp;
  const float shear_x = fc0 * vx * z_rcp_sqr;
  const float shear_y = fc1 * vy * z_rcp_sqr;

  const float x0 = scale_x * v[0] + shear_x * v[8];
  const float x1 = scale_x * v[1] + shear_x * v[9];
  const float x2 = scale_x * v[2] + shear_x * v[10];
  const float y0 = scale_y * v[4] + shear_y * v[8];
  const float y1 = scale_y * v[5] + shear_y * v[9];
  const float y2 = scale_y * v[6] + shear_y * v[10];

  float cov_a = a00 * x0 * x0 + a11 * x1 * x1 + a22 * x2 * x2
                + 2.0f * (a01 * x0 * x1 + a02 * x0 * x2 + a12 * x1 * x2);
  float cov_c = a00 * y0 * y0 + a11 * y1 * y1 + a22 * y2 * y2
                + 2.0f * (a01 * y0 * y1 + a02 * y0 * y2 + a12 * y1 * y2);
  const float cov_b = a00 * x0 * y0 + a11 * x1 * y1 + a22 * x2 * y2
                      + a01 * (x0 * y1 + x1 * y0)
                      + a02 * (x0 * y2 + x2 * y0)
                      + a12 * (x1 * y2 + x2 * y1);
  cov_a = cov_a + a.bump_x;
  cov_c = cov_c + a.bump_y;

  const float clip_x = scale_x * vx;
  const float clip_y = scale_y * vy;
  const float clip_z = v[21] * vz + v[22];

  const float det = cov_a * cov_c - cov_b * cov_b;
  const float mid = 0.5f * (cov_a + cov_c);
  const float radius = sqrtf(tmax(mid * mid - det, a.eps));
  const float lambda0 = mid + radius;
  const float lambda1 = tmax(mid - radius, 0.0f);

  float ev_x = cov_b, ev_y = lambda0 - cov_a;
  float ev_norm = sqrtf(ev_x * ev_x + ev_y * ev_y);
  if (ev_norm < f32(1e-20)) {
    ev_x = 1.0f;
    ev_y = 0.0f;
    ev_norm = 1.0f;
  }
  const float cos_t = ev_x / ev_norm;
  const float sin_t = ev_y / ev_norm;

  float ext0 = sqrtf(lambda0) * a.sigma;
  float ext1 = sqrtf(lambda1) * a.sigma;
  if (a.trunc != kTruncNone) {
    const float a255 = 255.0f * op;
    float trunc;
    if (a.trunc == kTruncGaussian) {
      const float dxc = 2.0f * logf(tmax(a255, f32(1e-12)));
      trunc = sqrtf(tmin(tmax(dxc, 0.0f), 9.0f)) * f32(1.0 / 3.0);
    } else {
      trunc = sqrtf(tmin(tmax(1.0f - 1.0f / tmax(a255, f32(1e-12)), 0.0f), 1.0f));
    }
    ext0 = ext0 * trunc;
    ext1 = ext1 * trunc;
  }

  const float inv_det = 1.0f / tmax(det, a.eps);
  const float con_a = cov_c * inv_det;
  const float con_b = -cov_b * inv_det;
  const float con_c = cov_a * inv_det;

  const bool inside = clip_x >= -1.0f && clip_x <= 1.0f && clip_y >= -1.0f && clip_y <= 1.0f
                      && clip_z >= -1.0f && clip_z <= 1.0f;
  const bool visible = inside && lambda1 >= 0.0f && op > 0.0f;
  const float visf = visible ? 1.0f : 0.0f;
  return {visible ? clip_x : -128.0f, visible ? clip_y : -128.0f, clip_z, cos_t, sin_t,
          ext0 * visf, ext1 * visf, con_a, con_b, con_c};
}

// Stage A for splat i: ops/sh.py:evaluate_sh_colors clamped to [0, 1], or
// the baked colours at degree 0 (ops/splat.py:splat_colors).  The contraction
// sums in its own order, so it may differ from cuBLAS's by one rounding.
template <int kDegree>
__device__ __forceinline__ float3 colour(const Args& a, long long i) {
  const long long n = a.n;
  if constexpr (kDegree == 0) {
    return make_float3(a.colors[i], a.colors[n + i], a.colors[2 * n + i]);
  } else {
    constexpr int kCoeffs = (kDegree + 1) * (kDegree + 1);
    const float* __restrict__ v = a.camera;
    const float dx = v[16] - a.means[i], dy = v[17] - a.means[n + i];
    const float dz = v[18] - a.means[2 * n + i];
    const float inv = 1.0f / tmax(sqrtf(dx * dx + dy * dy + dz * dz), f32(1e-20));
    float basis[kCoeffs];
    sh_basis<kDegree>(dx * inv, dy * inv, dz * inv, basis);
    float acc[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* coeffs = a.sh + ch * a.sh_k * n + i;
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kCoeffs; ++k) sum = fmaf(basis[k], coeffs[k * n], sum);
      acc[ch] = tmin(tmax(sum + 0.5f, 0.0f), 1.0f);
    }
    return make_float3(acc[0], acc[1], acc[2]);
  }
}

template <int kDegree>
__global__ void __launch_bounds__(kThreads) splat_columns_kernel(const Args a) {
  const long long n = a.n;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;

  // ---- stage A, first, so that its loads are in flight during B and C ----
  const float rgb = pack_rgb(colour<kDegree>(a, i));

  // ---- stage B ----
  const Clip c = project(a, i, a.opacities[i]);
  const float cx = c.cx, cy = c.cy, ct = c.cos_t, st = c.sin_t, e0 = c.e0, e1 = c.e1;

  // ---- stage C: splat_tile_rects ----
  const int row_lo = a.row_lo_ptr != nullptr ? *a.row_lo_ptr : a.row_lo;
  const int row_hi = a.row_hi_ptr != nullptr ? *a.row_hi_ptr : a.row_hi;
  const float sx = 0.5f * static_cast<float>(a.tiles_x);
  const float sy = 0.5f * static_cast<float>(a.tiles_y);
  const float hx = fabsf(ct * e0) + fabsf(st * e1);
  const float hy = fabsf(st * e0) + fabsf(ct * e1);
  const int rx0 = clampi(static_cast<int>(floorf((cx - hx + 1.0f) * sx)), 0, a.tiles_x);
  const int ry0 = clampi(static_cast<int>(floorf((cy - hy + 1.0f) * sy)), row_lo, row_hi);
  const int rx1 = clampi(static_cast<int>(ceilf((cx + hx + 1.0f) * sx)), 0, a.tiles_x);
  const int ry1 = clampi(static_cast<int>(ceilf((cy + hy + 1.0f) * sy)), row_lo, row_hi);
  const int w = rx1 - rx0;
  const int h = ry1 - ry0;

  // ---- stage C: splat_row_packs ----
  const float am = e0 * st;
  const float bm = e1 * ct;
  const float m = ct * st * (e0 * e0 - e1 * e1);
  const float ry2 = am * am + bm * bm;
  const float ry = sqrtf(ry2);
  const float rx = sqrtf(e0 * e0 * ct * ct + e1 * e1 * st * st);
  const float kstar = m / tclamp_min(rx, f32(1e-30));
  const float inv_ry2 = 1.0f / tclamp_min(ry2, f32(1e-30));
  const float p_inv_ry = (e0 * e1) / tclamp_min(ry, f32(1e-30));
  const float slope = m * inv_ry2;

  const float x0f = static_cast<float>(rx0);
  const float y0f = static_cast<float>(ry0);
  const float wf = static_cast<float>(w);
  const float x1f = x0f + wf;
  const float hf = static_cast<float>(h);
  const bool packable = w <= kMaxPackW;

  float count_f = 0.0f;
  float packs[kMaxPackRows / 2];
  float pack = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxPackRows; ++r) {
    const float2 run = strip_run(static_cast<float>(r), y0f, a.tch, a.y_span, a.centered, cx, cy,
                                 ry, kstar, p_inv_ry, inv_ry2, slope, sx, x0f, x1f,
                                 static_cast<float>(r) < hf && packable);
    const float w_r = run.x, dx_r = run.y;
    count_f = count_f + w_r;
    if (r % 2 == 0) {
      pack = (dx_r * 64.0f + w_r) * 4096.0f;
    } else {
      packs[r / 2] = pack + dx_r * 64.0f + w_r;
    }
  }
  const float overflow_rows =
      packable ? tclamp_min(hf - static_cast<float>(kMaxPackRows), 0.0f) : hf;
  count_f = count_f + overflow_rows * wf;
  const int count = static_cast<int>(tclamp_min(count_f, 0.0f));

  // ---- stage C: pack_columns ----
  const float z01 = tclamp((c.z + 1.0f) * 0.5f, 0.0f, 1.0f);
  float* out = a.out + i;
  out[0] = (x0f * 256.0f + y0f) * 256.0f + wf;
  out[n] = static_cast<float>(static_cast<long long>(z01 * a.depth_scale));
  out[2 * n] = cx;
  out[3 * n] = cy;
  out[4 * n] = c.con_a;
  out[5 * n] = c.con_b;
  out[6 * n] = c.con_c;
  out[7 * n] = rgb;
#pragma unroll
  for (int p = 0; p < kMaxPackRows / 2; ++p) out[(8 + p) * n] = packs[p];
  a.counts[i] = count;
}

template <int kDegree>
void launch(const Args& a, cudaStream_t stream) {
  splat_columns_kernel<kDegree><<<gsr::blocks_for(a.n, kThreads), kThreads, 0, stream>>>(a);
}

}  // namespace

// degree: the SH degree to evaluate, 0 for the baked colours; trunc: 0 none,
// 1 Gaussian, 2 Epanechnikov; centered: config.center_sampled_runs.
GSR_EXPORT int gsr_splat_columns(const void* means, const void* scales, const void* quats,
                                 const void* opacities, const void* colors, const void* sh,
                                 long long sh_k, int degree, int trunc, int centered,
                                 const void* camera, long long n, float bump_x, float bump_y,
                                 float eps, float sigma, float tch, float y_span,
                                 float depth_scale, int tiles_x, int tiles_y, int row_lo,
                                 int row_hi, const void* row_lo_ptr, const void* row_hi_ptr,
                                 void* out, void* counts, void* stream) {
  if (n < 0 || degree < 0 || degree > 4 || trunc < kTruncNone || trunc > kTruncEpanechnikov
      || (degree > 0 && sh_k < (degree + 1) * (degree + 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  Args a;
  a.means = static_cast<const float*>(means);
  a.scales = static_cast<const float*>(scales);
  a.quats = static_cast<const int*>(quats);
  a.opacities = static_cast<const float*>(opacities);
  a.colors = static_cast<const float*>(colors);
  a.sh = static_cast<const float*>(sh);
  a.sh_k = sh_k;
  a.camera = static_cast<const float*>(camera);
  a.n = n;
  a.bump_x = bump_x;
  a.bump_y = bump_y;
  a.eps = eps;
  a.sigma = sigma;
  a.tch = tch;
  a.y_span = y_span;
  a.depth_scale = depth_scale;
  a.trunc = trunc;
  a.centered = centered != 0;
  a.tiles_x = tiles_x;
  a.tiles_y = tiles_y;
  a.row_lo = row_lo;
  a.row_hi = row_hi;
  a.row_lo_ptr = static_cast<const int*>(row_lo_ptr);
  a.row_hi_ptr = static_cast<const int*>(row_hi_ptr);
  a.out = static_cast<float*>(out);
  a.counts = static_cast<int*>(counts);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: launch<0>(a, s); break;
    case 1: launch<1>(a, s); break;
    case 2: launch<2>(a, s); break;
    case 3: launch<3>(a, s); break;
    default: launch<4>(a, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
