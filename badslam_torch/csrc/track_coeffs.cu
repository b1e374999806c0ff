// H1: the tracker's Gauss-Newton step, base-frame pixels against the tracked frame.
//
// This replaces no TPU kernel. In the JAX package the same functions are
// badslam_tpu/tracking/pairwise.py accumulate_pose_coeffs and
// compute_cost_and_count, which XLA fuses; in the port they were a chain of
// plain PyTorch operations (now badslam_torch/tracking/pairwise.py
// accumulate_pose_coeffs_plain, compute_cost_and_count_plain and
// _gn_step_plain, the CPU path): per Gauss-Newton step about 400 small
// kernels, each over one [H, W] plane (association, the depth and descriptor
// residuals, three bilinear samples through K2, weights, Jacobians), three
// cuBLAS products for H and b, the unrolled 6x6 Cholesky and the SE3 update,
// and about 200 per cost evaluation of the duels. Its CUDA original is
// AccumulatePoseEstimationCoeffsFromImagesCUDA.
//
// What it computes, for each base pixel: the association of _image_residuals
// (unprojection at the pixel centre, transform into the tracked frame,
// corner-convention projection, bounds test, nearest depth and normal at the
// pixel, stereo sigma, Tukey gate, facing test, normal compatibility), the
// depth residual with its Tukey weight, the two descriptor residuals with
// their plane-predicted neighbour projections and three clamp-to-edge
// bilinear samples with gradients (interp.bilinear_and_gradient), or the
// gradient-magnitude residual, each with its Huber weight. The residual
// types are template flags. Three modes:
//   * coefficients: the Jacobian-residual rows summed into the upper
//     triangle of H (21), b (6) and the number of valid pixels;
//   * cost: the robust cost (depth and photometric apart) and the count
//     compute_cost_and_count gives, for one or two poses (grid y);
//   * the step: a one-block kernel sums the coefficient partials in a fixed
//     order, applies the count > 6 guard, geometry/linalg.solve_psd's
//     unrolled Cholesky with its 1e-30 pivot clamp, the finiteness guard,
//     se3.exp(-damping x), se3.mul and the scale-N convergence test, and
//     writes q, t and the converged flag (and, inside a CUDA-graph WHILE
//     body, the loop's iteration count and condition); a one-block kernel
//     likewise turns the cost partials into (cost, count) or into the
//     duel's choice between two poses.
// The arithmetic is the plain version's, operation by operation, and the
// library is built with -fmad=false, so every per-pixel value and gate is
// the one the plain chain computes on the card; only the order of the final
// sums differs (they use explicit fused multiply-adds).
//
// What bounds it on an H100: launches, then bytes. A step at 640x480 reads
// the base level's four planes once (4.9 MB) and gathers about as much from
// the tracked level, which stays in the 50 MB L2: ~3 us at 3.35 TB/s, for a
// few hundred flops a pixel. The plain chain took ~1.3 ms a step, nearly
// all of it the ~400 kernel nodes' launch gaps, and as long at 40x30. The
// design keeps a step to two kernel nodes:
//   * one thread per base pixel, 256 threads a block, grid-strided over the
//     tiles (pixel tile * 256 + thread + k * tiles * 256), so the reads of a
//     warp are coalesced along rows; the tile count follows from the
//     level's pixel count alone, so one launch shape serves every level and
//     the ragged ones (739x458 down to 46x28);
//   * each thread keeps its sums in registers; a block reduces them by warp
//     shuffles, then through shared memory, into one partial row of a
//     [tiles, sums] buffer the caller allocates;
//   * the one-block kernel reduces the partials one warp per sum, lane l
//     over tiles l, l + 32, ..., then the warp's shuffle tree.
// No sum uses atomics, so the same inputs give the same bits on every
// launch: the convergence test decides iteration counts on these sums.
// Everything is float32 (no TF32, no lower precision). Nothing is allocated
// or synchronized, so the launches capture into CUDA graphs (the steady
// frame's and the closure attempt's WHILE bodies). Each launcher returns
// cudaGetLastError() for the caller to check.
// The code H1, H2 and H3 share (pose and per-sample arithmetic, the block
// and partial reductions) is in gn_sums.cuh.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gn_sums.cuh"

namespace {

constexpr int kMaxTiles = 256;
constexpr int kCostSums = 3;           // depth cost, photometric cost, count
constexpr int kConstants = 18;

// Host-side scalars, in the order of kernels._track_constants' table: each
// the float32 that the plain version's PyTorch operation uses.
struct Constants {
  float fx, fy, cx, cy;                // camera of the level (pixel corners)
  float fx_inv, fy_inv, cx_inv, cy_inv;
  float inv_baseline_fx;               // 1 / baseline_fx, as x / scalar on the card
  float uncertainty_factor;            // DEPTH_UNCERTAINTY_EMPIRICAL_FACTOR
  float tukey_param, inv_tukey_param;  // threshold_factor * DEPTH_TUKEY_PARAM
  float tukey_cost;                    // tukey_param^2 / 6
  float depth_weight;                  // DEPTH_RESIDUAL_WEIGHT
  float cos_normal_threshold;          // COS_NORMAL_COMPATIBILITY_THRESHOLD
  float descriptor_weight;             // threshold_factor * DESCRIPTOR_RESIDUAL_WEIGHT
  float huber_param;                   // DESCRIPTOR_HUBER_PARAM
  float huber_half;                    // 0.5 * DESCRIPTOR_HUBER_PARAM
};

struct Planes {
  const float* base_depth;  // [H, W] each
  const float* base_nx;
  const float* base_ny;
  const float* base_intensity;
  const float* depth;  // the tracked frame's, [H, W] each
  const float* nx;
  const float* ny;
  const float* intensity;
  int height;
  int width;
};

// frame_T_base as a rotation matrix and a translation.
struct Pose {
  float r[9];
  float t[3];
};

// ---- The per-pixel arithmetic (each line the plain version's operations).

// se3.quat_mul.
__device__ __forceinline__ void quat_mul(const float* a, const float* b, float* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// se3.quat_normalize: q / |q|.
__device__ __forceinline__ void quat_normalize(float* q) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// se3.inverse of base_T_frame, then se3.quat_to_matrix: frame_T_base.
__device__ __forceinline__ Pose frame_T_base(const float* __restrict__ q_in,
                                             const float* __restrict__ t_in) {
  const float q[4] = {__ldg(q_in), __ldg(q_in + 1), __ldg(q_in + 2), __ldg(q_in + 3)};
  const float t[3] = {__ldg(t_in), __ldg(t_in + 1), __ldg(t_in + 2)};
  Pose p;
  inverse_matrix(q, t, p.r, p.t);
  return p;
}

// _transform_planes: ((r0 x + r1 y) + r2 z) + t per output component.
__device__ __forceinline__ void transform(const Pose& p, float x, float y, float z,
                                          float* out) {
  out[0] = p.r[0] * x + p.r[1] * y + p.r[2] * z + p.t[0];
  out[1] = p.r[3] * x + p.r[4] * y + p.r[5] * z + p.t[1];
  out[2] = p.r[6] * x + p.r[7] * y + p.r[8] * z + p.t[2];
}

__device__ __forceinline__ void rotate(const Pose& p, float x, float y, float z,
                                       float* out) {
  out[0] = p.r[0] * x + p.r[1] * y + p.r[2] * z;
  out[1] = p.r[3] * x + p.r[4] * y + p.r[5] * z;
  out[2] = p.r[6] * x + p.r[7] * y + p.r[8] * z;
}

// robust.weighted_descriptor_residual: the Huber cost.
__device__ __forceinline__ float descriptor_cost(const Constants& k, float r) {
  const float abs_r = fabsf(r);
  const float huber =
      abs_r < k.huber_param ? (0.5f * r) * r : k.huber_param * (abs_r - k.huber_half);
  return k.descriptor_weight * huber;
}

// robust.depth_residual_weight and weighted_depth_residual: Tukey's.
__device__ __forceinline__ float depth_weight(const Constants& k, float r) {
  const float quot = r * k.inv_tukey_param;
  const float term = 1.0f - quot * quot;
  return k.depth_weight * (fabsf(r) < k.tukey_param ? term * term : 0.0f);
}

__device__ __forceinline__ float depth_cost(const Constants& k, float r) {
  const float quot = r * k.inv_tukey_param;
  const float term = 1.0f - quot * quot;
  const float inside = k.tukey_cost * (1.0f - term * term * term);
  return k.depth_weight * (fabsf(r) < k.tukey_param ? inside : k.tukey_cost);
}

// One base pixel: adds its terms to acc and returns whether it is valid.
// With kJacobians acc holds H's upper triangle and b (27 sums); without it
// acc holds the depth cost and the photometric cost.
template <bool kDepth, bool kDescriptor, bool kGradmag, bool kJacobians>
__device__ __forceinline__ bool accumulate_pixel(const Planes& in, const Constants& k,
                                                 const Pose& p, int x, int y, float* acc) {
  const int height = in.height, width = in.width;
  const int at = y * width + x;
  const float d_b = __ldg(in.base_depth + at);
  if (!(d_b > 0.0f)) return false;

  // Unproject the base pixel (pixel-centre convention), into the tracked frame.
  const float xs = static_cast<float>(x), ys = static_cast<float>(y);
  const float nxs = k.fx_inv * xs + k.cx_inv;
  const float nys = k.fy_inv * ys + k.cy_inv;
  float l[3];
  transform(p, d_b * nxs, d_b * nys, d_b, l);
  const float lx = l[0], ly = l[1], lz = l[2];
  if (!(lz > 0.0f)) return false;

  // Project (corner convention), floor to pixel indices, bounds test.
  const float pxy_x = k.fx * lx / lz + k.cx;
  const float pxy_y = k.fy * ly / lz + k.cy;
  const float pxf = floorf(pxy_x), pyf = floorf(pxy_y);
  if (!(pxy_x >= 0.0f && pxy_y >= 0.0f && pxf < static_cast<float>(width) &&
        pyf < static_cast<float>(height) && pxf >= 0.0f && pyf >= 0.0f)) {
    return false;
  }
  const int ix = static_cast<int>(pxf), iy = static_cast<int>(pyf);
  const int tat = iy * width + ix;
  const float d_t = __ldg(in.depth + tat);
  if (!(d_t > 0.0f)) return false;

  // The base normal rotated into the tracked frame; the association test.
  const float b_nx = __ldg(in.base_nx + at), b_ny = __ldg(in.base_ny + at);
  const float nbz = -sqrtf(clamp_min(1.0f - b_nx * b_nx - b_ny * b_ny, 0.0f));
  float nl[3];
  rotate(p, b_nx, b_ny, nbz, nl);
  const float un_x = k.fx_inv * static_cast<float>(ix) + k.cx_inv;
  const float un_y = k.fy_inv * static_cast<float>(iy) + k.cy_inv;
  const float stddev =
      ((k.uncertainty_factor * fabsf(nl[0] * un_x + nl[1] * un_y + nl[2])) * (d_t * d_t)) *
      k.inv_baseline_fx;
  if (!(fabsf(lz - d_t) <= k.tukey_param * stddev)) return false;
  // The surfel faces the camera; its normal is compatible with the measurement.
  if (!(lx * nl[0] + ly * nl[1] + lz * nl[2] <= 0.0f)) return false;
  const float t_nx = __ldg(in.nx + tat), t_ny = __ldg(in.ny + tat);
  const float t_nz = -sqrtf(clamp_min(1.0f - t_nx * t_nx - t_ny * t_ny, 0.0f));
  if (!(nl[0] * t_nx + nl[1] * t_ny + nl[2] * t_nz >= k.cos_normal_threshold)) return false;

  float r1 = 0.0f, r2 = 0.0f;
  Sample c, s1, s2;
  if constexpr (kDescriptor) {
    // Descriptors need the right and lower neighbours.
    if (!(x < width - 1 && y < height - 1)) return false;
    const float i_c = __ldg(in.base_intensity + at);
    const float desc1 = 180.0f * (__ldg(in.base_intensity + at + 1) - i_c);
    const float desc2 = 180.0f * (__ldg(in.base_intensity + at + width) - i_c);
    // The plane through the base point with the base normal predicts the
    // depths of the +x / +y neighbour pixels.
    const float plane_d = (nxs * d_b) * b_nx + (nys * d_b) * b_ny + d_b * nbz;
    const float nxs_r = k.fx_inv * (xs + 1.0f) + k.cx_inv;
    const float nys_d = k.fy_inv * (ys + 1.0f) + k.cy_inv;
    const float denom1 = nxs_r * b_nx + nys * b_ny + nbz;
    const float denom2 = nxs * b_nx + nys_d * b_ny + nbz;
    if (!(fabsf(denom1) > 1e-12f && fabsf(denom2) > 1e-12f)) return false;
    const float t1_depth = plane_d / denom1;
    const float t2_depth = plane_d / denom2;
    float t1[3], t2[3];
    transform(p, t1_depth * nxs_r, t1_depth * nys, t1_depth, t1);
    transform(p, t2_depth * nxs, t2_depth * nys_d, t2_depth, t2);
    if (!(t1[2] > 0.0f && t2[2] > 0.0f)) return false;
    const float t1_px = k.fx * t1[0] / t1[2] + k.cx;
    const float t1_py = k.fy * t1[1] / t1[2] + k.cy;
    const float t2_px = k.fx * t2[0] / t2[2] + k.cx;
    const float t2_py = k.fy * t2[1] / t2[2] + k.cy;
    if (!(t1_px >= 0.0f && t1_py >= 0.0f && floorf(t1_px) < static_cast<float>(width) &&
          floorf(t1_py) < static_cast<float>(height) && t2_px >= 0.0f && t2_py >= 0.0f &&
          floorf(t2_px) < static_cast<float>(width) &&
          floorf(t2_py) < static_cast<float>(height))) {
      return false;
    }
    c = bilinear_and_gradient(in.intensity, height, width, pxy_x, pxy_y);
    s1 = bilinear_and_gradient(in.intensity, height, width, t1_px, t1_py);
    s2 = bilinear_and_gradient(in.intensity, height, width, t2_px, t2_py);
    r1 = 180.0f * (s1.value - c.value) - desc1;
    r2 = 180.0f * (s2.value - c.value) - desc2;
  }

  if constexpr (kDepth) {
    const float inv_stddev = 1.0f / clamp_min(stddev, 1e-30f);
    // The tracked pixel unprojected with the measured depth.
    const float ux = d_t * un_x, uy = d_t * un_y, uz = d_t;
    const float r =
        inv_stddev * (nl[0] * (ux - lx) + nl[1] * (uy - ly) + nl[2] * (uz - lz));
    if constexpr (kJacobians) {
      const float jac[6] = {inv_stddev * nl[0],
                            inv_stddev * nl[1],
                            inv_stddev * nl[2],
                            inv_stddev * (-nl[1] * uz + nl[2] * uy),
                            inv_stddev * (nl[0] * uz - nl[2] * ux),
                            inv_stddev * (-nl[0] * uy + nl[1] * ux)};
      accumulate(acc, jac, r, depth_weight(k, r));
    } else {
      acc[0] += depth_cost(k, r);
    }
  }

  if constexpr (kDescriptor) {
    if constexpr (kJacobians) {
      const float inv_z = 1.0f / lz;
      float jac[6];
      photometric_jacobian((180.0f * (s1.dx - c.dx)) * k.fx, (180.0f * (s1.dy - c.dy)) * k.fy,
                           lx, ly, lz, inv_z, jac);
      accumulate(acc, jac, r1, huber_weight(r1, k.huber_param, k.descriptor_weight));
      photometric_jacobian((180.0f * (s2.dx - c.dx)) * k.fx, (180.0f * (s2.dy - c.dy)) * k.fy,
                           lx, ly, lz, inv_z, jac);
      accumulate(acc, jac, r2, huber_weight(r2, k.huber_param, k.descriptor_weight));
    } else {
      acc[1] += descriptor_cost(k, r1) + descriptor_cost(k, r2);
    }
  }

  if constexpr (kGradmag) {
    // Pyramids of gradient magnitudes carry them in `intensity`.
    const Sample g = bilinear_and_gradient(in.intensity, height, width, pxy_x, pxy_y);
    const float r = 255.0f * g.value - 255.0f * __ldg(in.base_intensity + at);
    if constexpr (kJacobians) {
      float jac[6];
      photometric_jacobian((255.0f * g.dx) * k.fx, (255.0f * g.dy) * k.fy, lx, ly, lz,
                           1.0f / lz, jac);
      accumulate(acc, jac, r, huber_weight(r, k.huber_param, k.descriptor_weight));
    } else {
      acc[1] += descriptor_cost(k, r);
    }
  }
  return true;
}

// ---- The kernels.

// Coefficient mode: partial [tiles, 28].
template <bool kDepth, bool kDescriptor, bool kGradmag>
__global__ void __launch_bounds__(kThreads)
    track_coeffs_kernel(Planes in, Constants k, const float* __restrict__ q,
                        const float* __restrict__ t, float* __restrict__ partial) {
  const Pose p = frame_T_base(q, t);
  float acc[kSums - 1];
#pragma unroll
  for (int j = 0; j < kSums - 1; ++j) acc[j] = 0.0f;
  unsigned int count = 0;
  const int n = in.height * in.width;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int y = i / in.width;
    count += accumulate_pixel<kDepth, kDescriptor, kGradmag, true>(in, k, p, i - y * in.width,
                                                                   y, acc);
  }
  reduce_block<kSums>(acc, count, partial + static_cast<long long>(blockIdx.x) * kSums);
}

// Cost mode: the pose of blockIdx.y (q0/t0, or q1/t1), partial [poses, tiles, 3].
template <bool kDepth, bool kDescriptor, bool kGradmag>
__global__ void __launch_bounds__(kThreads)
    track_cost_kernel(Planes in, Constants k, const float* __restrict__ q0,
                      const float* __restrict__ t0, const float* __restrict__ q1,
                      const float* __restrict__ t1, float* __restrict__ partial) {
  const Pose p = blockIdx.y == 0 ? frame_T_base(q0, t0) : frame_T_base(q1, t1);
  // compute_cost_and_count's count: the valid pixels once with depth
  // residuals, else once per photometric residual type.
  constexpr unsigned int kCount = kDepth ? 1u : (kDescriptor ? 1u : 0u) + (kGradmag ? 1u : 0u);
  float acc[2] = {0.0f, 0.0f};
  unsigned int count = 0;
  const int n = in.height * in.width;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int y = i / in.width;
    if (accumulate_pixel<kDepth, kDescriptor, kGradmag, false>(in, k, p, i - y * in.width, y,
                                                               acc)) {
      count += kCount;
    }
  }
  reduce_block<kCostSums>(
      acc, count,
      partial + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kCostSums);
}

// H, b and the count: symmetric H [6, 6], b [6], count int64.
__global__ void track_coeffs_finish(const float* __restrict__ partial, int tiles,
                                    float* __restrict__ h, float* __restrict__ b,
                                    long long* __restrict__ count) {
  finish_coeffs(partial, tiles, h, b, count);
}

// One Gauss-Newton step (pairwise._gn_step_plain) from the summed
// coefficients (H's upper triangle, b) and the valid count n at
// base_T_frame (q_in, t_in): writes (q_out, t_out), which may be the same
// buffers, and returns the convergence test's verdict.
__device__ __forceinline__ bool gn_update(const float* sums, unsigned long long n,
                                          float neg_damping, float converge_below,
                                          const float* q_in, const float* t_in, float* q_out,
                                          float* t_out) {
  // H (symmetric from its upper triangle) and b; with no residuals, the
  // identity keeps the pose.
  float H[6][6], b[6];
  const bool ok = n > 6;
  int k = 0;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = r; c < 6; ++c) {
      H[r][c] = H[c][r] = ok ? sums[k] : (r == c ? 1.0f : 0.0f);
      ++k;
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = sums[kHSums + j];

  // geometry/linalg.solve_psd: Cholesky with pivots clamped to >= 1e-30.
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int m = 0; m < j; ++m) s = s - L[j][m] * L[j][m];
    L[j][j] = sqrtf(clamp_min(s, 1e-30f));
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = H[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) v = v - L[i][m] * L[j][m];
      L[i][j] = v / L[j][j];
    }
  }
  float yv[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int m = 0; m < i; ++m) s = s - L[i][m] * yv[m];
    yv[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = yv[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) s = s - L[m][i] * x[m];
    x[i] = s / L[i][i];
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(x[i]);
  if (!(ok && finite)) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = 0.0f;
  }

  // se3.exp(-damping x) = (q_e, t_e).
  float v[3], w[3];
  for (int i = 0; i < 3; ++i) {
    v[i] = neg_damping * x[i];
    w[i] = neg_damping * x[i + 3];
  }
  const float theta_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(theta_sq);
  const float half = 0.5f * theta;
  const bool small = theta_sq < 1e-8f;
  const float sinc_half =
      small ? 0.5f - theta_sq * (1.0f / 48.0f) : sinf(half) / (small ? 1.0f : theta);
  float q_e[4] = {cosf(half), sinc_half * w[0], sinc_half * w[1], sinc_half * w[2]};
  quat_normalize(q_e);
  const float safe_theta_sq = small ? 1.0f : theta_sq;
  const float safe_theta = small ? 1.0f : theta;
  const float a = small ? 0.5f - theta_sq * (1.0f / 24.0f)
                        : (1.0f - cosf(theta)) / safe_theta_sq;
  const float bb = small ? (1.0f / 6.0f) - theta_sq * (1.0f / 120.0f)
                         : (theta - sinf(theta)) / (safe_theta_sq * safe_theta);
  float wxv[3], wxwxv[3], t_e[3];
  cross(w, v, wxv);
  cross(w, wxv, wxwxv);
  for (int i = 0; i < 3; ++i) t_e[i] = v[i] + a * wxv[i] + bb * wxwxv[i];

  // se3.mul((q, t), (q_e, t_e)).
  const float q[4] = {q_in[0], q_in[1], q_in[2], q_in[3]};
  const float t[3] = {t_in[0], t_in[1], t_in[2]};
  float q_new[4], rot[3];
  quat_mul(q, q_e, q_new);
  quat_normalize(q_new);
  quat_rotate(q, t_e, rot);
  for (int i = 0; i < 4; ++i) q_out[i] = q_new[i];
  for (int i = 0; i < 3; ++i) t_out[i] = rot[i] + t[i];

  // The scale-N convergence test on the (guarded) step.
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) sq = sq + x[i] * x[i];
  return sq < converge_below;
}

// The step on the partials, by one thread after the block's reduction; with
// `iterations` also the WHILE body's loop state.
__global__ void track_step_finish(const float* __restrict__ partial, int tiles,
                                  float neg_damping, float converge_below,
                                  const float* q_in, const float* t_in, float* q_out,
                                  float* t_out, bool* converged, long long* iterations,
                                  bool* flag, long long bound) {
  __shared__ float sums[kSums];
  __shared__ unsigned long long n;
  reduce_partials(partial, tiles, kSums, threadIdx.y, sums, &n);
  __syncthreads();
  if (threadIdx.x != 0 || threadIdx.y != 0) return;
  const bool done =
      gn_update(sums, n, neg_damping, converge_below, q_in, t_in, q_out, t_out);
  *converged = done;
  if (iterations != nullptr) {
    // The WHILE body's loop state: one more iteration, and the condition.
    const long long it = *iterations + 1;
    *iterations = it;
    *flag = !done && it < bound;
  }
}

// The cost of one pose (cost float32, count int64), or the duel's choice
// between two (q_out, t_out).
__global__ void track_cost_finish(const float* __restrict__ partial, int tiles, int poses,
                                  float* cost, long long* count, const float* q0,
                                  const float* t0, const float* q1, const float* t1,
                                  float* q_out, float* t_out) {
  __shared__ float sums[2][kCostSums];
  __shared__ unsigned long long n[2];
  // Each warp reduces one entry of one pose.
  const int pose = threadIdx.y / kCostSums;
  reduce_partials(partial + static_cast<long long>(pose) * tiles * kCostSums, tiles, kCostSums,
                  threadIdx.y % kCostSums, sums[pose], &n[pose]);
  __syncthreads();
  if (threadIdx.x != 0 || threadIdx.y != 0) return;
  // cost = 0 + depth cost + photometric cost, as the plain version adds them.
  const float cost0 = (0.0f + sums[0][0]) + sums[0][1];
  if (poses == 1) {
    *cost = cost0;
    *count = static_cast<long long>(n[0]);
    return;
  }
  const float cost1 = (0.0f + sums[1][0]) + sums[1][1];
  const long long c0 = static_cast<long long>(n[0]), c1 = static_cast<long long>(n[1]);
  const bool pick0 = (c0 > 2 * c1) || (!(c1 > 2 * c0) && (cost0 < cost1));
  const float* q = pick0 ? q0 : q1;
  const float* t = pick0 ? t0 : t1;
  const float qv[4] = {q[0], q[1], q[2], q[3]};
  const float tv[3] = {t[0], t[1], t[2]};
  for (int i = 0; i < 4; ++i) q_out[i] = qv[i];
  for (int i = 0; i < 3; ++i) t_out[i] = tv[i];
}

int tiles_for(int n) {
  const int t = (n + kThreads - 1) / kThreads;
  return t < 1 ? 1 : (t > kMaxTiles ? kMaxTiles : t);
}

Planes planes_of(const float* base_depth, const float* base_nx, const float* base_ny,
                 const float* base_intensity, const float* depth, const float* nx,
                 const float* ny, const float* intensity, int height, int width) {
  return Planes{base_depth, base_nx, base_ny, base_intensity, depth, nx, ny, intensity,
                height, width};
}

Constants constants_of(const float* table) {
  static_assert(sizeof(Constants) == kConstants * sizeof(float), "constant table");
  Constants k;
  float* dst = reinterpret_cast<float*>(&k);
  for (int j = 0; j < kConstants; ++j) dst[j] = table[j];
  return k;
}

template <bool kDepth, bool kDescriptor, bool kGradmag>
void launch_coeffs(int tiles, cudaStream_t s, const Planes& in, const Constants& k,
                   const float* q, const float* t, float* partial) {
  track_coeffs_kernel<kDepth, kDescriptor, kGradmag><<<tiles, kThreads, 0, s>>>(in, k, q, t,
                                                                                partial);
}

template <bool kDepth, bool kDescriptor, bool kGradmag>
void launch_cost(int tiles, int poses, cudaStream_t s, const Planes& in, const Constants& k,
                 const float* q0, const float* t0, const float* q1, const float* t1,
                 float* partial) {
  track_cost_kernel<kDepth, kDescriptor, kGradmag>
      <<<dim3(tiles, poses), kThreads, 0, s>>>(in, k, q0, t0, q1, t1, partial);
}

// The residual flags (bit 0 depth, 1 descriptor, 2 gradient magnitude) as
// template arguments.
#define BADSLAM_TRACK_DISPATCH(flags, fn, ...)                 \
  switch ((flags) & 7) {                                       \
    case 0: fn<false, false, false>(__VA_ARGS__); break;       \
    case 1: fn<true, false, false>(__VA_ARGS__); break;        \
    case 2: fn<false, true, false>(__VA_ARGS__); break;        \
    case 3: fn<true, true, false>(__VA_ARGS__); break;         \
    case 4: fn<false, false, true>(__VA_ARGS__); break;        \
    case 5: fn<true, false, true>(__VA_ARGS__); break;         \
    case 6: fn<false, true, true>(__VA_ARGS__); break;         \
    default: fn<true, true, true>(__VA_ARGS__); break;         \
  }

}  // namespace

// The number of pixel tiles (blocks) for an [height, width] level: the
// coefficient partials are [tiles, 28] floats, the cost partials [poses,
// tiles, 3].
extern "C" int badslam_track_tiles(int height, int width) { return tiles_for(height * width); }

// H [6, 6], b [6] and the valid count (int64) at base_T_frame (q, t).
extern "C" int badslam_track_coeffs(const float* base_depth, const float* base_nx,
                                    const float* base_ny, const float* base_intensity,
                                    const float* depth, const float* nx, const float* ny,
                                    const float* intensity, int height, int width,
                                    const float* constants, int flags, const float* q,
                                    const float* t, float* partial, float* h, float* b,
                                    long long* count, void* stream) {
  const Planes in = planes_of(base_depth, base_nx, base_ny, base_intensity, depth, nx, ny,
                              intensity, height, width);
  const Constants k = constants_of(constants);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_for(height * width);
  BADSLAM_TRACK_DISPATCH(flags, launch_coeffs, tiles, s, in, k, q, t, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  track_coeffs_finish<<<1, dim3(32, kSums), 0, s>>>(partial, tiles, h, b, count);
  return static_cast<int>(cudaGetLastError());
}

// One Gauss-Newton step from base_T_frame (q, t): writes (q_out, t_out) and
// converged (which may alias q, t); with `iterations` (an int64 counter) also
// adds one to it and writes flag = !converged && iterations < bound.
extern "C" int badslam_track_step(const float* base_depth, const float* base_nx,
                                  const float* base_ny, const float* base_intensity,
                                  const float* depth, const float* nx, const float* ny,
                                  const float* intensity, int height, int width,
                                  const float* constants, int flags, const float* q,
                                  const float* t, float* partial, float neg_damping,
                                  float converge_below, float* q_out, float* t_out,
                                  bool* converged, long long* iterations, bool* flag,
                                  long long bound, void* stream) {
  const Planes in = planes_of(base_depth, base_nx, base_ny, base_intensity, depth, nx, ny,
                              intensity, height, width);
  const Constants k = constants_of(constants);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_for(height * width);
  BADSLAM_TRACK_DISPATCH(flags, launch_coeffs, tiles, s, in, k, q, t, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  track_step_finish<<<1, dim3(32, kSums), 0, s>>>(partial, tiles, neg_damping, converge_below,
                                                 q, t, q_out, t_out, converged, iterations,
                                                 flag, bound);
  return static_cast<int>(cudaGetLastError());
}

// The robust cost and count at (q0, t0), or with (q1, t1) the duel's choice
// of the two written to (q_out, t_out).
extern "C" int badslam_track_cost(const float* base_depth, const float* base_nx,
                                  const float* base_ny, const float* base_intensity,
                                  const float* depth, const float* nx, const float* ny,
                                  const float* intensity, int height, int width,
                                  const float* constants, int flags, const float* q0,
                                  const float* t0, const float* q1, const float* t1,
                                  float* partial, float* cost, long long* count, float* q_out,
                                  float* t_out, void* stream) {
  const Planes in = planes_of(base_depth, base_nx, base_ny, base_intensity, depth, nx, ny,
                              intensity, height, width);
  const Constants k = constants_of(constants);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_for(height * width);
  const int poses = q1 == nullptr ? 1 : 2;
  BADSLAM_TRACK_DISPATCH(flags, launch_cost, tiles, poses, s, in, k, q0, t0, q1, t1, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  track_cost_finish<<<1, dim3(32, kCostSums * poses), 0, s>>>(partial, tiles, poses, cost,
                                                             count, q0, t0, q1, t1, q_out,
                                                             t_out);
  return static_cast<int>(cudaGetLastError());
}
