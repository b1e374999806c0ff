// Device code shared by BA's hand-written kernels over surfel rows, H2
// (pose_coeffs.cu, the pose pass) and H3 (geometry_coeffs.cu, the geometry
// pass): one surfel row against one keyframe, as
// badslam_torch/mapping/association.py computes it for every row at once.
//
//   * associate: associate_surfels_with_frame's gates (projection in the
//     pixel-corner convention, bounds, nearest depth and normal at the
//     clamped pixel, stereo sigma, depth gap against the Tukey parameter,
//     facing, normal compatibility) with what the passes read of it;
//   * tangent_points, project_and_sample: tangent_projections' two points on
//     the surfel's border and, in one frame, their projections and the three
//     bilinear samples of the intensity (with gradients) that the
//     descriptor residuals take.
//
// Each function repeats the plain version's PyTorch operations one rounding
// at a time, so an includer is built with -fmad=false (ops/kernels.py
// SOURCE_FLAGS). The build's digest covers this header (kernels._digest).

#pragma once

#include "gn_sums.cuh"

namespace {

constexpr int kConstants = 15;

// Host-side scalars, in the order of kernels._surfel_constants' table: each
// the float32 that the plain version's PyTorch operation uses.
struct Constants {
  float fx, fy, cx, cy;             // camera (pixel-corner convention)
  float fx_inv, fy_inv, cx_inv, cy_inv;
  float inv_baseline_fx;            // 1 / baseline_fx, as x / scalar on the card
  float uncertainty_factor;         // DEPTH_UNCERTAINTY_EMPIRICAL_FACTOR
  float tukey_param, inv_tukey_param;
  float cos_normal_threshold;       // COS_NORMAL_COMPATIBILITY_THRESHOLD
  float descriptor_weight;          // DESCRIPTOR_RESIDUAL_WEIGHT
  float huber_param;
};

// The table as the launchers pass it to a kernel (host code).
inline Constants load_constants(const float* table) {
  static_assert(sizeof(Constants) == kConstants * sizeof(float), "constant table");
  Constants k;
  float* dst = reinterpret_cast<float*>(&k);
  for (int j = 0; j < kConstants; ++j) dst[j] = table[j];
  return k;
}

// rotate3: ((r0 x + r1 y) + r2 z) per output component.
__device__ __forceinline__ void rotate(const float* r, float x, float y, float z,
                                       float* out) {
  out[0] = r[0] * x + r[1] * y + r[2] * z;
  out[1] = r[3] * x + r[4] * y + r[5] * z;
  out[2] = r[6] * x + r[7] * y + r[8] * z;
}

// What the passes read of an association: the surfel and its normal in the
// frame, its projection, the pixel's measurements and the stereo sigma.
struct Association {
  float lx, ly, lz;     // surfel position in frame coordinates
  float nl[3];          // surfel normal in frame coordinates
  float pxy_x, pxy_y;   // corner-convention projection
  float un_x, un_y;     // the pixel's unprojected direction
  float d;              // measured depth at the pixel
  float m_nx, m_ny, m_nz;  // measured normal at the pixel (frame)
  float stddev;         // propagated depth-residual sigma
};

// The surfel at p (global) with normal n against one frame (frame_T_global
// as rot [9], trans [3]; the frame's planes depth, f_nx, f_ny [height,
// width]): whether it is associated with the pixel it projects to, and
// then `a`.
__device__ __forceinline__ bool associate(const Constants& k, const float* rot,
                                          const float* trans,
                                          const float* __restrict__ depth,
                                          const float* __restrict__ f_nx,
                                          const float* __restrict__ f_ny, int height,
                                          int width, const float* p, const float* n,
                                          Association& a) {
  float l[3];
  rotate(rot, p[0], p[1], p[2], l);
  a.lx = l[0] + trans[0];
  a.ly = l[1] + trans[1];
  a.lz = l[2] + trans[2];
  if (!(a.lz > 0.0f)) return false;
  a.pxy_x = k.fx * a.lx / a.lz + k.cx;
  a.pxy_y = k.fy * a.ly / a.lz + k.cy;
  const float pxf = floorf(a.pxy_x), pyf = floorf(a.pxy_y);
  if (!(a.pxy_x >= 0.0f && a.pxy_y >= 0.0f && pxf < static_cast<float>(width) &&
        pyf < static_cast<float>(height) && pxf >= 0.0f && pyf >= 0.0f)) {
    return false;
  }
  const int ix = static_cast<int>(pxf), iy = static_cast<int>(pyf);
  const long long at = static_cast<long long>(iy) * width + ix;
  a.d = __ldg(depth + at);
  if (!(a.d > 0.0f)) return false;

  rotate(rot, n[0], n[1], n[2], a.nl);
  a.un_x = static_cast<float>(ix) * k.fx_inv + k.cx_inv;
  a.un_y = static_cast<float>(iy) * k.fy_inv + k.cy_inv;
  a.stddev = ((fabsf(a.nl[0] * a.un_x + a.nl[1] * a.un_y + a.nl[2]) * k.uncertainty_factor) *
              (a.d * a.d)) *
             k.inv_baseline_fx;
  const float gap = a.d - a.lz;
  if (!(fabsf(gap) <= a.stddev * k.tukey_param)) return false;
  if (!(a.lx * a.nl[0] + a.ly * a.nl[1] + a.lz * a.nl[2] <= 0.0f)) return false;
  a.m_nx = __ldg(f_nx + at);
  a.m_ny = __ldg(f_ny + at);
  a.m_nz = -sqrtf(clamp_min(1.0f - a.m_nx * a.m_nx - a.m_ny * a.m_ny, 0.0f));
  return a.nl[0] * a.m_nx + a.nl[1] * a.m_ny + a.nl[2] * a.m_nz >= k.cos_normal_threshold;
}

// tangent_projections: a tangent vector scaled to twice the surfel radius.
// With kCard the squared length sums as PyTorch's CUDA reduction over the
// last axis does, (x^2 + z^2) + y^2; else in order (H2's).
template <bool kCard = false>
__device__ __forceinline__ void scale_tangent(float* t, float radius2) {
  const float sq = kCard ? t[0] * t[0] + t[2] * t[2] + t[1] * t[1]
                         : t[0] * t[0] + t[1] * t[1] + t[2] * t[2];
  const float s = sqrtf(radius2 / clamp_min(sq, 1e-12f)) * 2.0f;
  t[0] = t[0] * s;
  t[1] = t[1] * s;
  t[2] = t[2] * s;
}

// tangent_projections' two points of a surfel (global): p + t1 and p + t2,
// t1 = n x (ey if |nx| > 0.9 else ex), t2 = n x t1, each scaled to twice
// the radius. They depend on the surfel alone. kCard: as the plain chain
// rounds them on the card (cross's and scale_tangent's); H2 keeps the
// other order, its parent's bits.
template <bool kCard = false>
__device__ __forceinline__ void tangent_points(const float* p, const float* n, float radius2,
                                               float* p1, float* p2) {
  const float ref[3] = {fabsf(n[0]) > 0.9f ? 0.0f : 1.0f, fabsf(n[0]) > 0.9f ? 1.0f : 0.0f,
                        0.0f};
  float t1[3], t2[3];
  cross<kCard>(n, ref, t1);
  scale_tangent<kCard>(t1, radius2);
  cross<kCard>(n, t1, t2);
  scale_tangent<kCard>(t2, radius2);
  for (int j = 0; j < 3; ++j) {
    p1[j] = p[j] + t1[j];
    p2[j] = p[j] + t2[j];
  }
}

// The intensity samples the descriptor residuals take at an association:
// at the surfel's projection and at its two tangent points' projections.
struct DescriptorSamples {
  Sample c, s1, s2;
};

// The tangent points p1, p2 in the frame: whether both lie in front of it,
// and then their samples and the centre's in the frame's intensity plane.
__device__ __forceinline__ bool project_and_sample(const Constants& k, const float* rot,
                                                   const float* trans,
                                                   const float* __restrict__ intensity,
                                                   int height, int width, const Association& a,
                                                   const float* p1, const float* p2,
                                                   DescriptorSamples& s) {
  float f1[3], f2[3];
  rotate(rot, p1[0], p1[1], p1[2], f1);
  rotate(rot, p2[0], p2[1], p2[2], f2);
  const float z1 = f1[2] + trans[2], z2 = f2[2] + trans[2];
  if (!(z1 > 0.0f && z2 > 0.0f)) return false;
  s.c = bilinear_and_gradient(intensity, height, width, a.pxy_x, a.pxy_y);
  s.s1 = bilinear_and_gradient(intensity, height, width, k.fx * (f1[0] + trans[0]) / z1 + k.cx,
                               k.fy * (f1[1] + trans[1]) / z1 + k.cy);
  s.s2 = bilinear_and_gradient(intensity, height, width, k.fx * (f2[0] + trans[0]) / z2 + k.cx,
                               k.fy * (f2[1] + trans[1]) / z2 + k.cy);
  return true;
}

}  // namespace
