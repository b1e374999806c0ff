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
// The code H1, H2 and H3 share (pose and per-sample arithmetic, the block
// and partial reductions) is in gn_sums.cuh; the per-row association and
// tangent projections that H2 and H3 share are in association.cuh.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "association.cuh"

namespace {

constexpr int kMaxTiles = 512;
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

// One surfel row against one keyframe: adds its terms to acc and returns
// whether it is associated (counted).
template <bool kDepth, bool kDescriptor>
__device__ __forceinline__ bool accumulate_row(const Inputs& in, const Constants& k,
                                               const float* rot, const float* trans,
                                               long long plane, long long i,
                                               float* acc) {
  const int height = in.height, width = in.width;
  const float p[3] = {__ldg(in.pos + 3 * i), __ldg(in.pos + 3 * i + 1),
                      __ldg(in.pos + 3 * i + 2)};
  const float n[3] = {__ldg(in.normal + 3 * i), __ldg(in.normal + 3 * i + 1),
                      __ldg(in.normal + 3 * i + 2)};
  Association a;
  if (!associate(k, rot, trans, in.depth + plane, in.f_nx + plane, in.f_ny + plane, height,
                 width, p, n, a)) {
    return false;
  }
  const float lx = a.lx, ly = a.ly, lz = a.lz;
  const float* nl = a.nl;

  if (kDepth) {
    const float d = a.d;
    const float inv_stddev = 1.0f / clamp_min(a.stddev, 1e-30f);
    const float ux = d * a.un_x, uy = d * a.un_y, uz = d;
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
    float p1[3], p2[3];
    tangent_points(p, n, __ldg(in.radius2 + i), p1, p2);
    DescriptorSamples s;
    if (project_and_sample(k, rot, trans, in.intensity + plane, height, width, a, p1, p2, s)) {
      const float r1 = (s.s1.value - s.c.value) * 180.0f - __ldg(in.desc + 2 * i);
      const float r2d = (s.s2.value - s.c.value) * 180.0f - __ldg(in.desc + 2 * i + 1);
      const float inv_z = 1.0f / lz;
      float jac[6];
      photometric_jacobian(((s.s1.dx - s.c.dx) * 180.0f) * k.fx,
                           ((s.s1.dy - s.c.dy) * 180.0f) * k.fy, lx, ly, lz, inv_z, jac);
      accumulate(acc, jac, r1, huber_weight(r1, k.huber_param, k.descriptor_weight));
      photometric_jacobian(((s.s2.dx - s.c.dx) * 180.0f) * k.fx,
                           ((s.s2.dy - s.c.dy) * 180.0f) * k.fy, lx, ly, lz, inv_z, jac);
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
  Inputs in{pos,  normal, radius2, desc,      valid,   rot, trans, depth,
            f_nx, f_ny,   intensity, running, n,       height, width};
  const Constants k = load_constants(constants);
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
