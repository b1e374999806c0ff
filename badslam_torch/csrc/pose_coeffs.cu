// H2: keyframe BA's pose Gauss-Newton accumulation, surfels against keyframes.
//
// This replaces no TPU kernel. In the JAX package the same function is
// badslam_tpu/ba/pose_opt.py surfel_pose_coeffs, which XLA fuses; in the
// port it was a chain of plain PyTorch operations (now
// badslam_torch/ba/pose_opt.py surfel_pose_coeffs_plain, the CPU path): per
// Gauss-Newton step of a block of C keyframes about thirty [C, N] float32
// fields (association, tangent projections, three bilinear samples, robust
// weights, 7-column Jacobians) and a cuBLAS product A^T (w A) over the whole
// surfel bucket N, most of whose rows are not live. Its CUDA original is
// AccumulatePoseEstimationCoeffsCUDA (kernel_opt_pose.cu).
//
// What it computes, for each keyframe c of the batch and each surfel row:
// the association of surfel_pose_coeffs_plain (projection, corner
// convention, nearest depth and normal at the clamped pixel, stereo sigma,
// depth gap, facing, normal compatibility), the depth residual with its
// Tukey weight, the two tangent projections and three bilinear samples of
// the intensity with their gradients (clamp-to-edge, as interp.gather_quad),
// the two descriptor residuals with their Huber weights, and the three
// Jacobian-residual rows, summed into the upper triangle of H (21), b (6)
// and the number of associated surfels. No per-surfel field is written.
// The arithmetic is the plain version's, operation by operation, and the
// library is built with -fmad=false, so every per-surfel value and gate is
// the one the plain chain computes on the card; only the order of the final
// sums differs (they use explicit fused multiply-adds).
//
// What bounds it on an H100: bytes. A live row reads ~37 bytes of surfel
// (position, normal, squared radius, descriptor, valid flag) and makes ~15
// gathers from the keyframe's four planes (~4.9 MB at 640x480, held in the
// 50 MB L2), for a few hundred flops; a dead row reads its one valid byte.
// So the least time is the live rows' bytes plus the valid flags over HBM.
// The design keeps to that:
//   * grid (tiles, C), 256 threads a block; a block strides over the rows
//     tile * 256 + thread + k * tiles * 256, so the live rows, which sit
//     mostly at the front of the bucket, spread evenly over the blocks, and
//     the reads of a warp are coalesced;
//   * a row whose valid flag is false costs one byte; a keyframe whose
//     entry of the optional running mask is false writes a zero partial and
//     returns (empty slots and keyframes whose own loop has ended);
//   * each thread keeps its 28 sums in registers; a block reduces them by
//     warp shuffles, then through shared memory, into one partial of 28
//     floats in a [C, tiles, 28] buffer the caller allocates;
//   * a second kernel sums the partials of a keyframe in a fixed order and
//     writes symmetric H [C, 6, 6], b [C, 6] and count [C] (int64).
// The number of tiles depends on N alone, and no sum uses atomics, so the
// same inputs give the same bits on every launch: BA's convergence test
// decides its iteration counts on these sums. Everything is float32 (no
// TF32, no lower precision). Nothing is allocated or synchronized, so the
// launches capture into CUDA graphs (the BA graph's WHILE bodies). Each
// launcher returns cudaGetLastError() for the caller to check.
// The code H1 and H2 share (per-sample arithmetic, the block and partial
// reductions) is in gn_sums.cuh.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gn_sums.cuh"

namespace {

constexpr int kMaxTiles = 512;
constexpr int kConstants = 15;

// Host-side scalars, in the order of kernels.pose_coeffs_cuda's table:
// each is the float32 the plain version's PyTorch operation uses.
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

struct Inputs {
  const float* pos;               // [N, 3] global
  const float* normal;            // [N, 3] global
  const float* radius2;           // [N]
  const float* desc;              // [N, 2]
  const unsigned char* valid;     // [N] bool
  const float* rot;               // [C, 3, 3] frame_T_global rotation
  const float* trans;             // [C, 3]
  const float* depth;             // [C, H, W]
  const float* f_nx;              // [C, H, W]
  const float* f_ny;              // [C, H, W]
  const float* intensity;         // [C, H, W]
  const unsigned char* running;   // [C] bool, or null for all
  long long n;
  int height;
  int width;
};

// ---- The per-row arithmetic (each line the plain version's operations).

// rotate3: ((r0 x + r1 y) + r2 z) per output component.
__device__ __forceinline__ void rotate(const float* r, float x, float y, float z,
                                       float* out) {
  out[0] = r[0] * x + r[1] * y + r[2] * z;
  out[1] = r[3] * x + r[4] * y + r[5] * z;
  out[2] = r[6] * x + r[7] * y + r[8] * z;
}

// tangent_projections: a tangent vector scaled to twice the surfel radius.
__device__ __forceinline__ void scale_tangent(float* t, float radius2) {
  const float s =
      sqrtf(radius2 / clamp_min(t[0] * t[0] + t[1] * t[1] + t[2] * t[2], 1e-12f)) *
      2.0f;
  t[0] = t[0] * s;
  t[1] = t[1] * s;
  t[2] = t[2] * s;
}

// One surfel row against one keyframe: adds its terms to acc and returns
// whether it is associated (counted).
template <bool kDepth, bool kDescriptor>
__device__ __forceinline__ bool accumulate_row(const Inputs& in, const Constants& k,
                                               const float* rot, const float* trans,
                                               long long plane, long long i,
                                               float* acc) {
  const int height = in.height, width = in.width;
  const float px = __ldg(in.pos + 3 * i), py = __ldg(in.pos + 3 * i + 1),
              pz = __ldg(in.pos + 3 * i + 2);
  float l[3];
  rotate(rot, px, py, pz, l);
  const float lx = l[0] + trans[0], ly = l[1] + trans[1], lz = l[2] + trans[2];
  if (!(lz > 0.0f)) return false;
  const float pxy_x = k.fx * lx / lz + k.cx;
  const float pxy_y = k.fy * ly / lz + k.cy;
  const float pxf = floorf(pxy_x), pyf = floorf(pxy_y);
  if (!(pxy_x >= 0.0f && pxy_y >= 0.0f && pxf < static_cast<float>(width) &&
        pyf < static_cast<float>(height) && pxf >= 0.0f && pyf >= 0.0f)) {
    return false;
  }
  const int ix = static_cast<int>(pxf), iy = static_cast<int>(pyf);
  const long long at = plane + static_cast<long long>(iy) * width + ix;
  const float d = __ldg(in.depth + at);
  if (!(d > 0.0f)) return false;

  const float n[3] = {__ldg(in.normal + 3 * i), __ldg(in.normal + 3 * i + 1),
                      __ldg(in.normal + 3 * i + 2)};
  float nl[3];
  rotate(rot, n[0], n[1], n[2], nl);
  const float un_x = static_cast<float>(ix) * k.fx_inv + k.cx_inv;
  const float un_y = static_cast<float>(iy) * k.fy_inv + k.cy_inv;
  const float stddev =
      ((fabsf(nl[0] * un_x + nl[1] * un_y + nl[2]) * k.uncertainty_factor) * (d * d)) *
      k.inv_baseline_fx;
  const float gap = d - lz;
  if (!(fabsf(gap) <= stddev * k.tukey_param)) return false;
  if (!(lx * nl[0] + ly * nl[1] + lz * nl[2] <= 0.0f)) return false;
  const float m_nx = __ldg(in.f_nx + at), m_ny = __ldg(in.f_ny + at);
  const float m_nz = -sqrtf(clamp_min(1.0f - m_nx * m_nx - m_ny * m_ny, 0.0f));
  if (!(nl[0] * m_nx + nl[1] * m_ny + nl[2] * m_nz >= k.cos_normal_threshold)) {
    return false;
  }

  if (kDepth) {
    const float inv_stddev = 1.0f / clamp_min(stddev, 1e-30f);
    const float ux = d * un_x, uy = d * un_y, uz = d;
    const float r =
        inv_stddev * (nl[0] * (ux - lx) + nl[1] * (uy - ly) + nl[2] * (uz - lz));
    const float quot = r * k.inv_tukey_param;
    const float term = 1.0f - quot * quot;
    const float w = fabsf(r) < k.tukey_param ? term * term : 0.0f;
    const float jac[6] = {inv_stddev * nl[0],
                          inv_stddev * nl[1],
                          inv_stddev * nl[2],
                          inv_stddev * (-nl[1] * uz + nl[2] * uy),
                          inv_stddev * (nl[0] * uz - nl[2] * ux),
                          inv_stddev * (-nl[0] * uy + nl[1] * ux)};
    accumulate(acc, jac, r, w);
  }

  if (kDescriptor) {
    const float r2 = __ldg(in.radius2 + i);
    const float ref[3] = {fabsf(n[0]) > 0.9f ? 0.0f : 1.0f,
                          fabsf(n[0]) > 0.9f ? 1.0f : 0.0f, 0.0f};
    float t1[3], t2[3];
    cross(n, ref, t1);
    scale_tangent(t1, r2);
    cross(n, t1, t2);
    scale_tangent(t2, r2);
    float p1[3], p2[3];
    rotate(rot, px + t1[0], py + t1[1], pz + t1[2], p1);
    rotate(rot, px + t2[0], py + t2[1], pz + t2[2], p2);
    const float z1 = p1[2] + trans[2], z2 = p2[2] + trans[2];
    if (z1 > 0.0f && z2 > 0.0f) {
      const float* img = in.intensity + plane;
      const Sample c = bilinear_and_gradient(img, height, width, pxy_x, pxy_y);
      const Sample s1 = bilinear_and_gradient(
          img, height, width, k.fx * (p1[0] + trans[0]) / z1 + k.cx,
          k.fy * (p1[1] + trans[1]) / z1 + k.cy);
      const Sample s2 = bilinear_and_gradient(
          img, height, width, k.fx * (p2[0] + trans[0]) / z2 + k.cx,
          k.fy * (p2[1] + trans[1]) / z2 + k.cy);
      const float r1 = (s1.value - c.value) * 180.0f - __ldg(in.desc + 2 * i);
      const float r2d = (s2.value - c.value) * 180.0f - __ldg(in.desc + 2 * i + 1);
      const float inv_z = 1.0f / lz;
      float jac[6];
      photometric_jacobian(((s1.dx - c.dx) * 180.0f) * k.fx, ((s1.dy - c.dy) * 180.0f) * k.fy,
                           lx, ly, lz, inv_z, jac);
      accumulate(acc, jac, r1, huber_weight(r1, k.huber_param, k.descriptor_weight));
      photometric_jacobian(((s2.dx - c.dx) * 180.0f) * k.fx, ((s2.dy - c.dy) * 180.0f) * k.fy,
                           lx, ly, lz, inv_z, jac);
      accumulate(acc, jac, r2d, huber_weight(r2d, k.huber_param, k.descriptor_weight));
    }
  }
  return true;
}

// ---- The kernels.

template <bool kDepth, bool kDescriptor>
__global__ void __launch_bounds__(kThreads)
    pose_coeffs_kernel(Inputs in, Constants k, float* __restrict__ partial) {
  const int c = blockIdx.y;
  float* out = partial + (static_cast<long long>(c) * gridDim.x + blockIdx.x) * kSums;
  if (in.running != nullptr && !in.running[c]) {
    if (threadIdx.x < kSums) out[threadIdx.x] = 0.0f;
    return;
  }
  float rot[9], trans[3];
#pragma unroll
  for (int j = 0; j < 9; ++j) rot[j] = __ldg(in.rot + 9 * c + j);
#pragma unroll
  for (int j = 0; j < 3; ++j) trans[j] = __ldg(in.trans + 3 * c + j);
  const long long plane = static_cast<long long>(c) * in.height * in.width;

  float acc[kSums - 1];
#pragma unroll
  for (int j = 0; j < kSums - 1; ++j) acc[j] = 0.0f;
  unsigned int count = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < in.n; i += stride) {
    if (!in.valid[i]) continue;
    count += accumulate_row<kDepth, kDescriptor>(in, k, rot, trans, plane, i, acc);
  }

  reduce_block<kSums>(acc, count, out);
}

// One block per keyframe: its H [6, 6], b [6] and count from its partials.
__global__ void pose_coeffs_finish(const float* __restrict__ partial, int tiles,
                                   float* __restrict__ h, float* __restrict__ b,
                                   long long* __restrict__ count) {
  const int c = blockIdx.x;
  finish_coeffs(partial + static_cast<long long>(c) * tiles * kSums, tiles, h + 36 * c,
                b + 6 * c, count + c);
}

int tiles_for(long long n) {
  const long long t = (n + kThreads - 1) / kThreads;
  return static_cast<int>(t < 1 ? 1 : (t > kMaxTiles ? kMaxTiles : t));
}

}  // namespace

// The number of row tiles (blocks per keyframe) for n surfel rows: the
// partial buffer is [C, tiles, 28] floats.
extern "C" int badslam_pose_coeffs_tiles(long long n) { return tiles_for(n); }

extern "C" int badslam_pose_coeffs(
    const float* pos, const float* normal, const float* radius2, const float* desc,
    const unsigned char* valid, long long n, const float* rot, const float* trans,
    const unsigned char* running, int batch, const float* depth, const float* f_nx,
    const float* f_ny, const float* intensity, int height, int width,
    const float* constants, int use_depth, int use_descriptor, float* partial,
    float* h, float* b, long long* count, void* stream) {
  static_assert(sizeof(Constants) == kConstants * sizeof(float), "constant table");
  Inputs in{pos,  normal, radius2, desc,      valid,   rot, trans, depth,
            f_nx, f_ny,   intensity, running, n,       height, width};
  Constants k;
  const float* src = constants;
  float* dst = reinterpret_cast<float*>(&k);
  for (int j = 0; j < kConstants; ++j) dst[j] = src[j];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_for(n);
  const dim3 grid(tiles, batch);
  if (use_depth && use_descriptor) {
    pose_coeffs_kernel<true, true><<<grid, kThreads, 0, s>>>(in, k, partial);
  } else if (use_depth) {
    pose_coeffs_kernel<true, false><<<grid, kThreads, 0, s>>>(in, k, partial);
  } else if (use_descriptor) {
    pose_coeffs_kernel<false, true><<<grid, kThreads, 0, s>>>(in, k, partial);
  } else {
    pose_coeffs_kernel<false, false><<<grid, kThreads, 0, s>>>(in, k, partial);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pose_coeffs_finish<<<batch, dim3(32, kSums), 0, s>>>(partial, tiles, h, b, count);
  return static_cast<int>(cudaGetLastError());
}
