// H3: keyframe BA's geometry pass, surfel rows against a block of keyframes.
//
// This replaces no TPU kernel. In the JAX package the same functions are
// badslam_tpu/ba/geometry_opt.py's chunks, which XLA fuses; in the port they
// were a chain of plain PyTorch operations (now badslam_torch/ba/
// geometry_opt.py's *_plain functions, the CPU path): per block of C <= 8
// keyframe slots, dozens of float32 [C, N] fields over the whole surfel
// bucket N (association, measured normals, depth residuals, tangent
// projections, three bilinear samples with gradients, robust weights), most
// of whose rows are not live. Its CUDA original is kernel_opt_geometry.cu
// (with UpdateSurfelActivationCUDA, kernel_surfel_activation.cu).
//
// Two kinds of kernel, each an accumulation per block of slots and a
// per-row finish:
//   * activation and normals (_act_normals_chunk, _normals_chunk and their
//     finishes): a row is active iff associated with a slot of the
//     activation mask; the measured normals (rotated to world) of the slots
//     of the normal mask are summed and counted, then averaged and
//     re-normalized. Template flags: whether it writes activation, whether
//     it sums normals (activation alone, both, or normals alone over the
//     active rows for PCG);
//   * positions and descriptors (_pos1d_chunk, _pos3d_chunk, _pos1d_finish,
//     _pos3d_finish): the depth residual with its Tukey weight and, with
//     descriptors, the two descriptor residuals at the tangent points with
//     their Huber weights, summed into each row's 1-D (position along the
//     normal) or 3x3 (position and the two descriptor components) system;
//     the finish solves it (the 3x3 by kernel_opt_geometry.cu:273-340's
//     Cholesky), keeps a finite step, moves the position along the normal
//     and clamps the descriptor.
// The arithmetic is the plain version's, operation by operation, rounded as
// PyTorch rounds it on the card: the library is built with -fmad=false, the
// cross products of the pose inverse and the tangents are one fused
// multiply-add a component (torch.linalg.cross), a sum of three squares runs
// (x^2 + z^2) + y^2 (torch.sum and vector_norm over the last axis), and a
// row's sums over a block's slots run as torch.sum over the slot axis does
// (slot c into accumulator c % 4, then ((a0 + a1) + a2) + a3) before they
// add into its carry. So every output equals the plain chain's on the card
// bit for bit (checked by chip_smoke.py and the cuda tests, PyTorch 2.11
// with CUDA 12.8; another PyTorch could reduce in another order).
//
// What bounds it on an H100: bytes. A live row reads its surfel (24-44
// bytes) and its carry, makes ~3 gathers (association) or ~15 (with the
// descriptors) per slot from the keyframes' planes (4.9 MB a keyframe at
// 640x480, held in the 50 MB L2), for a few hundred flops, and writes its
// carry; a dead row reads its valid byte (and, in the position pass, its
// active byte). The design keeps to that:
//   * one thread per surfel row, 256 threads a block, grid-strided over the
//     tiles (row tile * 256 + thread + k * tiles * 256), so the live rows,
//     which sit mostly at the front of the bucket, spread over the blocks,
//     and the reads of a warp are coalesced;
//   * a live row loops over the block's slots in slot order and keeps the
//     block's sums in registers (4 lanes of each); the slots' poses
//     (frame_T_global as a matrix and, for the normals, global_T_frame's
//     rotation) and mask flags are computed once per block into shared
//     memory;
//   * no cross-thread reduction and no atomics: each row owns its sums, so
//     the same inputs give the same bits on every launch (BA's iteration
//     counts depend on them);
//   * the carry is read and written for live rows only; the finish reads
//     it for live rows only and writes their normal, or their position and
//     descriptor, into outputs the caller has filled with the inputs.
// Everything is float32 (no TF32, no lower precision). Nothing is allocated
// or synchronized, so the launches capture into CUDA graphs (the BA graph).
// Each launcher returns cudaGetLastError() for the caller to check.
// The association and tangent projections are H2's, in association.cuh
// (H2 keeps its parent's order for the cross products and squared lengths).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "association.cuh"

namespace {

constexpr int kMaxTiles = 512;
constexpr int kMaxSlots = 8;   // mapping.keyframes.KEYFRAME_BATCH
constexpr int kPositionSums = 8;  // H00 H01 H02 H11 H22 b0 b1 b2 (H12 is never summed)
// A block's position sums: those, then the depth terms of H00 and b0.
constexpr int kHd = kPositionSums, kBd = kPositionSums + 1, kBlockSums = kPositionSums + 2;
// torch.sum over the slot axis on the card: one thread an output, slot c
// into accumulator c % 4 (starting at 0), then ((a0 + a1) + a2) + a3. A
// slot a row does not hit adds nothing, where the plain chain adds a zero:
// the same bits.
constexpr int kLanes = 4;

template <int kN>
__device__ __forceinline__ float lanes_sum(const float (&acc)[kLanes][kN], int j) {
  return ((acc[0][j] + acc[1][j]) + acc[2][j]) + acc[3][j];
}

struct Rows {
  const float* pos;              // [N, 3] global
  const float* normal;           // [N, 3] global
  const float* radius2;          // [N]
  const float* desc;             // [N, 2]
  const unsigned char* valid;    // [N] bool
  const unsigned char* active;   // [N] bool
  long long n;
};

struct Slots {
  const float* q;                 // [C, 4] global_T_frame rotation (wxyz)
  const float* t;                 // [C, 3]
  const unsigned char* first;     // [C] bool: the activation mask, or null
  const unsigned char* second;    // [C] bool: the normal or position mask, or null for all
  const float* depth;             // [C, H, W]
  const float* f_nx;              // [C, H, W]
  const float* f_ny;              // [C, H, W]
  const float* intensity;         // [C, H, W] (position pass with descriptors)
  int count;
  int height;
  int width;
};

// A slot as the rows read it: frame_T_global, global_T_frame's rotation and
// its two mask flags.
struct SlotPose {
  float rot[9];
  float trans[3];
  float world[9];
  bool first, second;
};

// Threads 0 .. C - 1 fill the block's slot table, then the block syncs.
__device__ __forceinline__ void load_slots(const Slots& s, SlotPose* poses) {
  const int c = threadIdx.x;
  if (c < s.count) {
    const float q[4] = {__ldg(s.q + 4 * c), __ldg(s.q + 4 * c + 1), __ldg(s.q + 4 * c + 2),
                        __ldg(s.q + 4 * c + 3)};
    const float t[3] = {__ldg(s.t + 3 * c), __ldg(s.t + 3 * c + 1), __ldg(s.t + 3 * c + 2)};
    inverse_matrix<true>(q, t, poses[c].rot, poses[c].trans);
    quat_to_matrix(q, poses[c].world);
    poses[c].first = s.first != nullptr && s.first[c];
    poses[c].second = s.second == nullptr || s.second[c];
  }
  __syncthreads();
}

__device__ __forceinline__ void load3(const float* __restrict__ x, long long i, float* out) {
  out[0] = __ldg(x + 3 * i);
  out[1] = __ldg(x + 3 * i + 1);
  out[2] = __ldg(x + 3 * i + 2);
}

// ---- Activation and normals.

// The carry of _act_normals_init: [N] bool, [N, 3] float32, [N] int64.
struct NormalCarry {
  unsigned char* act;
  float* nsum;
  long long* count;
};

// Rows: every valid row with activation, else the valid and active ones
// (the normals over the active surfels). Per slot: associated and in the
// activation mask -> active; associated and in the normal mask -> the
// measured normal, rotated to world, summed and counted.
template <bool kActivation, bool kNormals>
__global__ void __launch_bounds__(kThreads)
    geometry_normals_kernel(Rows rows, Slots s, Constants k, NormalCarry carry) {
  __shared__ SlotPose poses[kMaxSlots];
  load_slots(s, poses);
  const long long plane = static_cast<long long>(s.height) * s.width;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < rows.n;
       i += stride) {
    if (!rows.valid[i] || (!kActivation && !rows.active[i])) continue;
    float p[3], n[3];
    load3(rows.pos, i, p);
    load3(rows.normal, i, n);
    bool any = false;
    float acc[kLanes][3] = {};
    long long hits = 0;
    for (int base = 0; base < s.count; base += kLanes) {
#pragma unroll
      for (int lane = 0; lane < kLanes; ++lane) {
        const int c = base + lane;
        if (c >= s.count) break;
        const SlotPose& f = poses[c];
        if (!kNormals && !f.first) continue;
        Association a;
        if (!associate(k, f.rot, f.trans, s.depth + c * plane, s.f_nx + c * plane,
                       s.f_ny + c * plane, s.height, s.width, p, n, a)) {
          continue;
        }
        any = any || f.first;
        if (kNormals && f.second) {
          float g[3];
          rotate(f.world, a.m_nx, a.m_ny, a.m_nz, g);
          for (int j = 0; j < 3; ++j) acc[lane][j] = acc[lane][j] + g[j];
          ++hits;
        }
      }
    }
    if (kActivation) carry.act[i] = carry.act[i] | any;
    if (kNormals) {
      for (int j = 0; j < 3; ++j) {
        carry.nsum[3 * i + j] = carry.nsum[3 * i + j] + lanes_sum(acc, j);
      }
      carry.count[i] = carry.count[i] + hits;
    }
  }
}

// _renormalized for the live rows: with activation the rows the carry marks
// active, else the valid and active ones; normal_out holds the input normals.
template <bool kActivation>
__global__ void __launch_bounds__(kThreads)
    geometry_normals_finish(Rows rows, NormalCarry carry, float* __restrict__ normal_out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < rows.n;
       i += stride) {
    if (kActivation ? !carry.act[i] : (!rows.valid[i] || !rows.active[i])) continue;
    if (carry.count[i] < 1) continue;
    float sum[3];
    load3(carry.nsum, i, sum);
    // torch.linalg.vector_norm's order on the card: (x^2 + z^2) + y^2.
    const float norm = sqrtf(sum[0] * sum[0] + sum[2] * sum[2] + sum[1] * sum[1]);
    if (!(norm > 1e-12f)) continue;
    const float d = clamp_min(norm, 1e-12f);
    for (int j = 0; j < 3; ++j) normal_out[3 * i + j] = sum[j] / d;
  }
}

// ---- Positions and descriptors.

// The depth residual against the position along the normal: r, and its
// Jacobian -1 / sigma (_depth_residual).
__device__ __forceinline__ float depth_residual(const Association& a, float* jac) {
  const float inv_stddev = 1.0f / clamp_min(a.stddev, 1e-30f);
  *jac = -inv_stddev;
  return inv_stddev * (a.nl[0] * (a.d * a.un_x - a.lx) + a.nl[1] * (a.d * a.un_y - a.ly) +
                       a.nl[2] * (a.d - a.lz));
}

// robust.depth_residual_weight: the Tukey weight.
__device__ __forceinline__ float tukey_weight(const Constants& k, float r) {
  const float quot = r * k.inv_tukey_param;
  const float term = 1.0f - quot * quot;
  return fabsf(r) < k.tukey_param ? term * term : 0.0f;
}

// Rows: the valid and active ones. Without descriptors sums is [2, N] (H, b
// of the 1-D system from depth residuals alone); with them [8, N] (H00 H01
// H02 H11 H22 b0 b1 b2 of the 3x3 system, the depth terms with kDepth).
template <bool kDescriptor, bool kDepth>
__global__ void __launch_bounds__(kThreads)
    geometry_position_kernel(Rows rows, Slots s, Constants k, float* __restrict__ sums) {
  __shared__ SlotPose poses[kMaxSlots];
  load_slots(s, poses);
  const long long n = rows.n;
  const long long plane = static_cast<long long>(s.height) * s.width;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (!rows.valid[i] || !rows.active[i]) continue;
    float p[3], nrm[3];
    load3(rows.pos, i, p);
    load3(rows.normal, i, nrm);
    // The block's sums, each over the slots in torch.sum's lanes: the depth
    // terms (H00, b0) apart from the descriptor terms, as the plain chunk
    // sums and adds them in two steps.
    float acc[kLanes][kBlockSums] = {};
    float p1[3], p2[3], desc0 = 0.0f, desc1 = 0.0f;
    if (kDescriptor) {
      tangent_points<true>(p, nrm, __ldg(rows.radius2 + i), p1, p2);
      desc0 = __ldg(rows.desc + 2 * i);
      desc1 = __ldg(rows.desc + 2 * i + 1);
    }
    for (int base = 0; base < s.count; base += kLanes) {
#pragma unroll
      for (int lane = 0; lane < kLanes; ++lane) {
        const int c = base + lane;
        if (c >= s.count) break;
        const SlotPose& f = poses[c];
        if (!f.second) continue;
        Association a;
        if (!associate(k, f.rot, f.trans, s.depth + c * plane, s.f_nx + c * plane,
                       s.f_ny + c * plane, s.height, s.width, p, nrm, a)) {
          continue;
        }
        float* v = acc[lane];
        if (!kDescriptor || kDepth) {
          float jd;
          const float r = depth_residual(a, &jd);
          const float w = tukey_weight(k, r);
          v[kHd] = v[kHd] + w * jd * jd;
          v[kBd] = v[kBd] + w * r * jd;
        }
        if (!kDescriptor) continue;
        DescriptorSamples t;
        if (!project_and_sample(k, f.rot, f.trans, s.intensity + c * plane, s.height,
                                s.width, a, p1, p2, t)) {
          continue;
        }
        const float r1 = (t.s1.value - t.c.value) * 180.0f - desc0;
        const float r2 = (t.s2.value - t.c.value) * 180.0f - desc1;
        const float w1 = huber_weight(r1, k.huber_param, k.descriptor_weight);
        const float w2 = huber_weight(r2, k.huber_param, k.descriptor_weight);
        // d residual / d (position along the normal), fx and fy folded into
        // the terms (kernel_opt_geometry.cu:188-196); d residual / d
        // descriptor is -1.
        const float gx1 = (t.s1.dx - t.c.dx) * 180.0f, gy1 = (t.s1.dy - t.c.dy) * 180.0f;
        const float gx2 = (t.s2.dx - t.c.dx) * 180.0f, gy2 = (t.s2.dy - t.c.dy) * 180.0f;
        const float term1 = -k.fx * (a.nl[0] * a.lz - a.nl[2] * a.lx);
        const float term2 = -k.fy * (a.nl[1] * a.lz - a.nl[2] * a.ly);
        const float term3 = 1.0f / (a.lz * a.lz);
        const float jp1 = -(gx1 * term1 + gy1 * term2) * term3;
        const float jp2 = -(gx2 * term1 + gy2 * term2) * term3;
        const float jd = -1.0f;
        v[0] = v[0] + (w1 * jp1 * jp1 + w2 * jp2 * jp2);
        v[1] = v[1] + w1 * jp1 * jd;
        v[2] = v[2] + w2 * jp2 * jd;
        v[3] = v[3] + w1 * jd * jd;
        v[4] = v[4] + w2 * jd * jd;
        v[5] = v[5] + (w1 * r1 * jp1 + w2 * r2 * jp2);
        v[6] = v[6] + w1 * r1 * jd;
        v[7] = v[7] + w2 * r2 * jd;
      }
    }
    if (!kDescriptor) {
      sums[i] = sums[i] + lanes_sum(acc, kHd);
      sums[n + i] = sums[n + i] + lanes_sum(acc, kBd);
      continue;
    }
    for (int j = 0; j < kPositionSums; ++j) {
      float v = sums[j * n + i];
      if (kDepth && j == 0) v = v + lanes_sum(acc, kHd);
      if (kDepth && j == 5) v = v + lanes_sum(acc, kBd);
      sums[j * n + i] = v + lanes_sum(acc, j);
    }
  }
}

// _pos1d_finish / _pos3d_finish for the valid and active rows; pos_out and
// desc_out hold the input positions and descriptors.
template <bool kDescriptor>
__global__ void __launch_bounds__(kThreads)
    geometry_position_finish(Rows rows, const float* __restrict__ sums,
                             float* __restrict__ pos_out, float* __restrict__ desc_out) {
  const long long n = rows.n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (!rows.valid[i] || !rows.active[i]) continue;
    float p[3], nrm[3];
    load3(rows.pos, i, p);
    load3(rows.normal, i, nrm);
    if (!kDescriptor) {
      const float h = sums[i];
      if (!(h > 1e-6f)) continue;
      const float step = -sums[n + i] / clamp_min(h, 1e-6f);
      for (int j = 0; j < 3; ++j) pos_out[3 * i + j] = p[j] + step * nrm[j];
      continue;
    }
    // The 3x3 Cholesky solve (kernel_opt_geometry.cu:273-340).
    const float eps = 1e-6f;
    const float H00 = sums[i] + eps, H01 = sums[n + i], H02 = sums[2 * n + i];
    const float H11 = sums[3 * n + i] + eps, H12 = 0.0f, H22 = sums[4 * n + i] + eps;
    const float B0 = sums[5 * n + i], B1 = sums[6 * n + i], B2 = sums[7 * n + i];
    const float L00 = sqrtf(H00);
    const float L01 = H01 / L00;
    const float L11 = sqrtf(clamp_min(H11 - L01 * L01, 1e-12f));
    const float L02 = H02 / L00;
    const float L12 = (H12 - L02 * L01) / L11;
    const float L22 = sqrtf(clamp_min(H22 - L02 * L02 - L12 * L12, 1e-12f));
    const float y0 = B0 / L00;
    const float y1 = (B1 - L01 * y0) / L11;
    const float y2 = (B2 - L02 * y0 - L12 * y1) / L22;
    const float x2 = y2 / L22;
    const float x1 = (y1 - L12 * x2) / L11;
    const float x0 = (y0 - L02 * x2 - L01 * x1) / L00;
    const bool fin = isfinite(x0) && isfinite(x1) && isfinite(x2);
    const float s0 = fin ? x0 : 0.0f, s1 = fin ? x1 : 0.0f, s2 = fin ? x2 : 0.0f;
    for (int j = 0; j < 3; ++j) pos_out[3 * i + j] = p[j] - s0 * nrm[j];
    desc_out[2 * i] = clamp(__ldg(rows.desc + 2 * i) - s1, -180.0f, 180.0f);
    desc_out[2 * i + 1] = clamp(__ldg(rows.desc + 2 * i + 1) - s2, -180.0f, 180.0f);
  }
}

int tiles_for(long long n) {
  const long long t = (n + kThreads - 1) / kThreads;
  return static_cast<int>(t < 1 ? 1 : (t > kMaxTiles ? kMaxTiles : t));
}

}  // namespace

// The slots a launch takes at most.
extern "C" int badslam_geometry_max_slots() { return kMaxSlots; }

// Activation and normals over one block of `slots` keyframes: act_mask
// ([C] bool) given -> activation into act; nsum given -> the normals of the
// slots of normal_mask ([C] bool, null for all) into nsum and count. Without
// act_mask the rows are the valid and active ones.
extern "C" int badslam_geometry_normals(
    const float* pos, const float* normal, const unsigned char* valid,
    const unsigned char* active, long long n, const float* q, const float* t,
    const unsigned char* act_mask, const unsigned char* normal_mask, int slots,
    const float* depth, const float* f_nx, const float* f_ny, int height, int width,
    const float* constants, unsigned char* act, float* nsum, long long* count, void* stream) {
  const Rows rows{pos, normal, nullptr, nullptr, valid, active, n};
  const Slots s{q,       t,       act_mask, normal_mask, depth, f_nx,
                f_ny,    nullptr, slots,    height,      width};
  const Constants k = load_constants(constants);
  const NormalCarry carry{act, nsum, count};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_for(n);
  if (act_mask != nullptr && nsum != nullptr) {
    geometry_normals_kernel<true, true><<<tiles, kThreads, 0, st>>>(rows, s, k, carry);
  } else if (act_mask != nullptr) {
    geometry_normals_kernel<true, false><<<tiles, kThreads, 0, st>>>(rows, s, k, carry);
  } else {
    geometry_normals_kernel<false, true><<<tiles, kThreads, 0, st>>>(rows, s, k, carry);
  }
  return static_cast<int>(cudaGetLastError());
}

// The normals' finish: with activation (act given) over the rows it marks,
// else over the valid and active rows.
extern "C" int badslam_geometry_normals_finish(const unsigned char* valid,
                                               const unsigned char* active,
                                               const unsigned char* act, const float* nsum,
                                               const long long* count, long long n,
                                               float* normal_out, void* stream) {
  const Rows rows{nullptr, nullptr, nullptr, nullptr, valid, active, n};
  const NormalCarry carry{const_cast<unsigned char*>(act), const_cast<float*>(nsum),
                          const_cast<long long*>(count)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_for(n);
  if (act != nullptr) {
    geometry_normals_finish<true><<<tiles, kThreads, 0, st>>>(rows, carry, normal_out);
  } else {
    geometry_normals_finish<false><<<tiles, kThreads, 0, st>>>(rows, carry, normal_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Positions (and descriptors) over one block of `slots` keyframes, those of
// mask ([C] bool, null for all), into sums ([2, N] or [8, N]).
extern "C" int badslam_geometry_position(
    const float* pos, const float* normal, const float* radius2, const float* desc,
    const unsigned char* valid, const unsigned char* active, long long n, const float* q,
    const float* t, const unsigned char* mask, int slots, const float* depth, const float* f_nx,
    const float* f_ny, const float* intensity, int height, int width, const float* constants,
    int use_depth, int use_descriptor, float* sums, void* stream) {
  const Rows rows{pos, normal, radius2, desc, valid, active, n};
  const Slots s{q, t, nullptr, mask, depth, f_nx, f_ny, intensity, slots, height, width};
  const Constants k = load_constants(constants);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_for(n);
  if (!use_descriptor) {
    geometry_position_kernel<false, true><<<tiles, kThreads, 0, st>>>(rows, s, k, sums);
  } else if (use_depth) {
    geometry_position_kernel<true, true><<<tiles, kThreads, 0, st>>>(rows, s, k, sums);
  } else {
    geometry_position_kernel<true, false><<<tiles, kThreads, 0, st>>>(rows, s, k, sums);
  }
  return static_cast<int>(cudaGetLastError());
}

// The positions' finish over the valid and active rows.
extern "C" int badslam_geometry_position_finish(
    const float* pos, const float* normal, const float* desc, const unsigned char* valid,
    const unsigned char* active, long long n, const float* sums, int use_descriptor,
    float* pos_out, float* desc_out, void* stream) {
  const Rows rows{pos, normal, nullptr, desc, valid, active, n};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_for(n);
  if (use_descriptor) {
    geometry_position_finish<true><<<tiles, kThreads, 0, st>>>(rows, sums, pos_out, desc_out);
  } else {
    geometry_position_finish<false><<<tiles, kThreads, 0, st>>>(rows, sums, pos_out, desc_out);
  }
  return static_cast<int>(cudaGetLastError());
}
