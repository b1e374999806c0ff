// Device code shared by the hand-written Gauss-Newton kernels, H1
// (track_coeffs.cu, the tracker's step), H2 (pose_coeffs.cu, BA's pose
// pass) and H3 (geometry_coeffs.cu, BA's geometry pass): the pose and
// per-sample arithmetic they have in common and the two fixed-order
// reductions of H1's and H2's [H | b | count] sums.
//
// Each function repeats the plain PyTorch version's operations one rounding
// at a time, so an includer must be built with -fmad=false
// (ops/kernels.py SOURCE_FLAGS): only the order of the final sums differs
// from the plain chain (accumulate's explicit fused multiply-adds, then the
// block and the partial reductions below). No sum uses atomics, so the same
// inputs give the same bits on every launch. The build's digest covers this
// header (kernels._digest), so an edit rebuilds its includers.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;          // threads a block of the accumulating kernels
constexpr int kWarps = kThreads / 32;
constexpr int kHSums = 21;             // H's upper triangle, row by row
constexpr int kSums = kHSums + 6 + 1;  // then b, then the count

// torch.clamp_min / torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ long long clamp_index(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// torch.linalg.cross(a, b). With kCard as PyTorch's CUDA kernel rounds it,
// each component one fused multiply-add (a1 b2 - a2 b1 as fma(a1, b2,
// -(a2 b1))); else two products and a difference (H1's and H2's order).
template <bool kCard = false>
__device__ __forceinline__ void cross(const float* a, const float* b, float* out) {
  if (kCard) {
    out[0] = __fmaf_rn(a[1], b[2], -(a[2] * b[1]));
    out[1] = __fmaf_rn(a[2], b[0], -(a[0] * b[2]));
    out[2] = __fmaf_rn(a[0], b[1], -(a[1] * b[0]));
  } else {
    out[0] = a[1] * b[2] - a[2] * b[1];
    out[1] = a[2] * b[0] - a[0] * b[2];
    out[2] = a[0] * b[1] - a[1] * b[0];
  }
}

// se3.quat_rotate: v + 2 qv x (qv x v + qw v) (kCard: cross's).
template <bool kCard = false>
__device__ __forceinline__ void quat_rotate(const float* q, const float* v, float* out) {
  const float qv[3] = {q[1], q[2], q[3]};
  float uv[3], w[3], uuv[3];
  cross<kCard>(qv, v, uv);
  for (int i = 0; i < 3; ++i) w[i] = uv[i] + q[0] * v[i];
  cross<kCard>(qv, w, uuv);
  for (int i = 0; i < 3; ++i) out[i] = v[i] + 2.0f * uuv[i];
}

// se3.quat_to_matrix: the row-major [3, 3] rotation of a unit quaternion (wxyz).
__device__ __forceinline__ void quat_to_matrix(const float* q, float* r) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  r[0] = 1.0f - 2.0f * (yy + zz);
  r[1] = 2.0f * (xy - wz);
  r[2] = 2.0f * (xz + wy);
  r[3] = 2.0f * (xy + wz);
  r[4] = 1.0f - 2.0f * (xx + zz);
  r[5] = 2.0f * (yz - wx);
  r[6] = 2.0f * (xz - wy);
  r[7] = 2.0f * (yz + wx);
  r[8] = 1.0f - 2.0f * (xx + yy);
}

// se3.inverse of the pose (q, t), then se3.quat_to_matrix of its rotation:
// the inverse as a rotation matrix r and a translation t_inv (kCard: cross's).
template <bool kCard = false>
__device__ __forceinline__ void inverse_matrix(const float* q, const float* t, float* r,
                                               float* t_inv) {
  const float qi[4] = {q[0], -q[1], -q[2], -q[3]};
  float rot[3];
  quat_rotate<kCard>(qi, t, rot);
  for (int i = 0; i < 3; ++i) t_inv[i] = -rot[i];
  quat_to_matrix(qi, r);
}

struct Sample {
  float value, dx, dy;
};

// interp.bilinear_and_gradient at corner-convention (x, y): quad_texels'
// indices (floor, then a saturating conversion to int64, then the clamp to
// the image, as the card's plain version) and gather_quad's four reads.
__device__ __forceinline__ Sample bilinear_and_gradient(const float* __restrict__ img,
                                                        int height, int width, float x,
                                                        float y) {
  const float fx = clamp_min(x - 0.5f, 0.0f);
  const float fy = clamp_min(y - 0.5f, 0.0f);
  const float ixf = floorf(fx);
  const float iyf = floorf(fy);
  const float tx = clamp(fx - ixf, 0.0f, 1.0f);
  const float ty = clamp(fy - iyf, 0.0f, 1.0f);
  const long long ix = static_cast<long long>(ixf);
  const long long iy = static_cast<long long>(iyf);
  // ix + 1 in int64 as a tensor adds it: wrapping, never undefined.
  const long long ix1 = static_cast<long long>(static_cast<unsigned long long>(ix) + 1ull);
  const long long iy1 = static_cast<long long>(static_cast<unsigned long long>(iy) + 1ull);
  const long long x0 = clamp_index(ix, width - 1), x1 = clamp_index(ix1, width - 1);
  const long long y0 = clamp_index(iy, height - 1), y1 = clamp_index(iy1, height - 1);
  const float tl = __ldg(img + y0 * width + x0);
  const float tr = __ldg(img + y0 * width + x1);
  const float bl = __ldg(img + y1 * width + x0);
  const float br = __ldg(img + y1 * width + x1);
  const float top = tl + tx * (tr - tl);
  const float bottom = bl + tx * (br - bl);
  Sample s;
  s.value = top + ty * (bottom - top);
  s.dx = (br - bl) * ty + (tr - tl) * (1.0f - ty);
  s.dy = (br - tr) * tx + (bl - tl) * (1.0f - tx);
  return s;
}

// Adds one Jacobian-residual row with its weight: H += (J w) J^T (upper
// triangle), b += (J w) r.
__device__ __forceinline__ void accumulate(float* acc, const float* jac, float r, float w) {
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float wa = jac[a] * w;
#pragma unroll
    for (int b = a; b < 6; ++b) {
      acc[k] = __fmaf_rn(wa, jac[b], acc[k]);
      ++k;
    }
    acc[kHSums + a] = __fmaf_rn(wa, r, acc[kHSums + a]);
  }
}

// The photometric Jacobian of an image gradient (gx, gy), scaled to pixels,
// at the point (lx, ly, lz) of the frame, inv_z = 1 / lz (the descriptor
// and gradient-magnitude Jacobians of both plain versions).
__device__ __forceinline__ void photometric_jacobian(float gx, float gy, float lx, float ly,
                                                     float lz, float inv_z, float* jac) {
  const float inv_z_sq = inv_z * inv_z;
  const float z_sq = lz * lz;
  const float xy = lx * ly;
  jac[0] = -gx * inv_z;
  jac[1] = -gy * inv_z;
  jac[2] = (lx * gx + ly * gy) * inv_z_sq;
  jac[3] = ((ly * ly + z_sq) * gy + xy * gx) * inv_z_sq;
  jac[4] = -((lx * lx + z_sq) * gx + xy * gy) * inv_z_sq;
  jac[5] = -(lx * gy - ly * gx) * inv_z;
}

// robust.descriptor_residual_weight: the Huber weight of parameter `param`
// times `weight`, param / |r| taken as reciprocal(|r|) * param (Python's
// scalar / tensor).
__device__ __forceinline__ float huber_weight(float r, float param, float weight) {
  const float abs_r = fabsf(r);
  const float huber = abs_r < param ? 1.0f : (1.0f / clamp_min(abs_r, 1e-30f)) * param;
  return weight * huber;
}

// Reduces each thread's kN - 1 float sums and its count over the block into
// out[0 .. kN - 1] (the count as the bits of an unsigned int): warp shuffles,
// then the warps in order through shared memory.
template <int kN>
__device__ __forceinline__ void reduce_block(const float* acc, unsigned int count,
                                             float* __restrict__ out) {
  __shared__ float warp_sums[kWarps][kN];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < kN - 1; ++j) {
    float v = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sums[warp][j] = v;
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) count += __shfl_down_sync(0xffffffffu, count, o);
  if (lane == 0) warp_sums[warp][kN - 1] = __uint_as_float(count);
  __syncthreads();
  if (threadIdx.x < kN - 1) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    out[threadIdx.x] = s;
  } else if (threadIdx.x == kN - 1) {
    unsigned int s = 0;
    for (int w = 0; w < kWarps; ++w) s += __float_as_uint(warp_sums[w][kN - 1]);
    out[threadIdx.x] = __uint_as_float(s);
  }
}

// The calling warp sums entry j of the partials [tiles, n], lane l over
// tiles l, l + 32, ..., then the warp's shuffle tree (a fixed order), into
// sums[j]; the last entry (j = n - 1) is a count, summed in 64 bits into
// *count.
__device__ __forceinline__ void reduce_partials(const float* __restrict__ partial, int tiles,
                                                int n, int j, float* sums,
                                                unsigned long long* count) {
  const int lane = threadIdx.x;
  if (j < n - 1) {
    float s = 0.0f;
    for (int t = lane; t < tiles; t += 32) s += partial[static_cast<long long>(t) * n + j];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) sums[j] = s;
  } else {
    unsigned long long s = 0;
    for (int t = lane; t < tiles; t += 32) {
      s += __float_as_uint(partial[static_cast<long long>(t) * n + j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) *count = s;
  }
}

// The (row, column) of each of H's upper-triangle sums.
__constant__ unsigned char kPairs[kHSums][2] = {
    {0, 0}, {0, 1}, {0, 2}, {0, 3}, {0, 4}, {0, 5}, {1, 1}, {1, 2}, {1, 3}, {1, 4}, {1, 5},
    {2, 2}, {2, 3}, {2, 4}, {2, 5}, {3, 3}, {3, 4}, {3, 5}, {4, 4}, {4, 5}, {5, 5}};

// One system's symmetric H [6, 6], b [6] and count (int64) from its
// partials [tiles, kSums], by a block of (32, kSums) threads.
__device__ __forceinline__ void finish_coeffs(const float* __restrict__ partial, int tiles,
                                              float* __restrict__ h, float* __restrict__ b,
                                              long long* __restrict__ count) {
  __shared__ float sums[kSums];
  __shared__ unsigned long long n;
  reduce_partials(partial, tiles, kSums, threadIdx.y, sums, &n);
  __syncthreads();
  const int j = threadIdx.y * 32 + threadIdx.x;
  if (j < kHSums) {
    const int r = kPairs[j][0], c = kPairs[j][1];
    h[6 * r + c] = sums[j];
    h[6 * c + r] = sums[j];
  } else if (j < kSums - 1) {
    b[j - kHSums] = sums[j];
  } else if (j == kSums - 1) {
    *count = static_cast<long long>(n);
  }
}

}  // namespace
