// Joint bilateral filter on inverse depth with a max-depth cutoff (K1).
//
// Replaces the Pallas TPU kernel
//   badslam_tpu/ops/pallas_kernels.py:105 bilateral_filter_and_cutoff_pallas
// (body _bilateral_kernel, :54-97). Its plain PyTorch version is
// badslam_torch/ops/preprocess.py::bilateral_filter_and_cutoff; the two are
// held to each other at atol 1e-5.
//
// What it computes, per output pixel (x, y) with center depth d_c:
//   r = int(radius_factor * sigma_xy + 0.5); taps (dx, dy) with
//   dx^2 + dy^2 <= r^2 (29 taps at r = 3);
//   w = exp(-(dx^2+dy^2)/(2 sigma_xy^2) - (1/d_c - 1/d_s)^2/(2 sigma_inv^2)),
//   counted only where d_s > 0 (out-of-image samples are 0, so invalid);
//   out = sum(w) / max(sum(w / d_s), 1e-30) where sum(w) > 0, else 0;
//   out = 0 where d_c <= 0 or d_c > max_depth (center test only).
// A sample of +inf depth (which no loader produces) counts as invalid here:
// its inverse is 0, the invalid mark.
//
// What bounds it on an H100, at 480 x 640:
// * bytes: 4 read and 4 written per pixel, 2.46 MB, 0.73 us at 3.35 TB/s;
//   the 1.2 MB input sits in the 50 MB L2, and each block re-reads only its
//   halo.
// * operations: ~10 per valid tap of a valid center, ~0.74 us at 67 TFLOP/s
//   on chip_smoke.py's random input (the bound it reports).
// * the special-function units: one ex2 per tap, at 16 per SM per clock.
//   The ~6 M exponentials of that input take ~1.5 us at the 1.98 GHz boost
//   clock however the kernel is written; this kernel evaluates every tap of
//   a thread that has any valid center (~8.9 M at VGA, ~2.4 us at 1.755
//   GHz), and dispatches ~7 other instructions per tap on the four schedulers
//   at about the same rate.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py) a VGA call takes ~5.7 us
// inside a CUDA graph: ~3 us of it is the launch, staging and stores (its
// time at radius 0, as long as a gather's), ~2.7 us the taps.
//
// Design, one point per limit:
// 1. No division in the tap loop. The block stages the INVERSE depth into
//    shared memory: 1/d (IEEE, the plain version's value) where d > 0, else
//    0, so inv > 0 is the validity test; one reciprocal per staged sample,
//    ~2.2 per output, instead of 29. The spatial term of a tap is
//    (dx^2+dy^2) * (-log2(e) / (2 sigma_xy^2)), the range term
//    diff^2 * (-log2(e) / (2 sigma_inv^2)): both constants are computed once
//    by the launcher in double and rounded to float, so a tap multiplies
//    and never divides. The one division per output (sum(w) / sum(w/d))
//    stays IEEE.
// 2. A cheaper exponential: w = 2^(spatial + diff^2 * k_value), one FFMA and
//    one ex2.approx.ftz.f32 (MUFU.EX2) per tap. The PTX ISA gives ex2.approx
//    a maximum error of 2 ulp (relative ~2^-22); flushing results below
//    2^-126 to 0 drops weights that cannot move a sum of at least 1 (the
//    center's own weight). The output is a weighted harmonic mean, so a
//    relative weight error e moves it by at most e times the spread of the
//    inverse depths that carry weight (a few sigma_inv, ~0.02 at the
//    defaults) over their mean (>= 1/max_depth): ~1e-7 relative, ~1e-7 m,
//    far inside 1e-5. tests/test_torch_bilateral.py emulates this
//    arithmetic on the CPU with every weight scaled by a random factor in
//    [1 - 2^-21, 1 + 2^-21] and holds it to the plain version at 1e-5.
// 3. No branch per tap. For the main path's radius (r = 3, the defaults
//    sigma_xy 1.5 and radius_factor 2) the taps are unrolled at compile
//    time (template kR = 3): the disk test disappears and each tap's
//    validity is a select (inv > 0 ? w : 0). The center test
//    (0 < d_c <= max_depth, on the raw depth, so the cutoff is exact) is the
//    only early exit, taken when all of a thread's centers fail it. Every
//    other radius the wrapper accepts (0-16) runs the same kernel with the
//    radius at run time (kR = -1); its disk test is the same for all
//    threads, so it does not diverge.
// 4. Several outputs per thread and a grid that fills the card. Each thread
//    computes a column of kRows = 2 outputs. It walks the kRows + 2r sample
//    rows once, keeps the 2r + 1 samples of the current row in registers and
//    adds each to every output whose disk holds it: 56 shared loads for 58
//    taps at r = 3. A block is 32 x 8 threads (warps span a row: coalesced
//    stores, conflict-free shared loads) over a 32 x 16 output tile: 600
//    blocks of 256 threads at VGA. At the ~35 registers ptxas reports, all
//    of them are resident at once on 132 SMs (chip_smoke.py prints the
//    registers and the wave count), and 600 blocks give 5 on the busiest SM
//    against 4.55 on average (91% balance), where 32 x 32 tiles give 76%.
//    Of the shapes tried on the card (1 to 8 rows per thread, 4 to 32
//    threads down) this was the fastest: 4 or 8 rows per thread reuse more
//    samples but leave fewer warps to hide the latency of the staging loads
//    and of MUFU, and the 22 x 10 quads of the r = 3 tile take one pass of
//    256 threads. It is the default tile. One more is built beside it for
//    `--autotune`, which times both per card and image size
//    (badslam_torch/ops/kernels.py autotune_bilateral_tile): one output
//    per thread (32 x 8 outputs), which doubles the blocks and is 13-23%
//    faster on the H100 at 240x320 and below, where 32 x 16 tiles leave
//    SMs idle (chip_smoke.py phase autotune). 4 x 2, 8 x 4, 16 x 2 and
//    4 x 4 (threads down x outputs per thread) were timed there too and
//    were never the fastest at any size. Both tiles sum each output's
//    taps in the same order, so both give the same bits.
//    The tile rows are staged as 16-byte quads: the halo is rounded up to
//    whole quads (4 columns at r = 3), so a row of the tile starts on a
//    quad, and a quad is one 16-byte load where the row is 16-byte aligned
//    (width % 4 == 0, aligned base) and four bounds-checked scalar loads at
//    the ragged edge or on an unaligned row. The centers' raw depths (for
//    the cutoff test) are loaded before the staging, so the loads overlap.
// Taps are summed for each output in the plain version's order (dy outer,
// dx inner). Built without --use_fast_math: the staged reciprocal and the
// final division are IEEE; only the exponential is approximate, by choice.
// The kernel neither allocates nor synchronizes beyond its block; the
// launcher returns cudaGetLastError() for the caller to check.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;               // threads across: one column each
constexpr int kBlockY = 8;                // threads down
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kTileW = kBlockX;           // 32 outputs across
constexpr int kMainRadius = 3;            // the unrolled instance
constexpr double kLog2e = 1.4426950408889634;

// The tiles K1 is built for, as outputs per thread (a column): a tile is
// 32 x (8 x outputs per thread) outputs. Each is built for both radius
// forms. The first is the default, the tile every launch takes unless
// `--autotune` stored the other for the card and image size.
constexpr int kTileRows[] = {2, 1};
constexpr int kNumTiles = sizeof(kTileRows) / sizeof(kTileRows[0]);

// The halo rounded up to whole 16-byte quads of floats.
__host__ __device__ constexpr int quad_halo(int radius) {
  return (radius + 3) / 4 * 4;
}

__host__ __device__ constexpr size_t tile_bytes(int radius, int tile_h) {
  return sizeof(float) * static_cast<size_t>(kTileW + 2 * quad_halo(radius)) *
         static_cast<size_t>(tile_h + 2 * radius);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tap of one output: weight 2^(k_spatial + diff^2 * neg_k_value), or 0
// where the sample is invalid (its staged inverse is 0).
__device__ __forceinline__ void tap(float inv_center, float inv_sample,
                                    float k_spatial, float neg_k_value,
                                    float& weight_sum, float& value_sum) {
  const float diff = inv_center - inv_sample;
  const float w = ex2_approx(fmaf(diff * diff, neg_k_value, k_spatial));
  const float weight = inv_sample > 0.0f ? w : 0.0f;
  weight_sum += weight;
  value_sum = fmaf(weight, inv_sample, value_sum);
}

// kR >= 0: the radius is kR, taps unrolled; kR < 0: the radius is
// `radius_arg`, taps looped. Each thread computes a column of kRows
// outputs.
template <int kR, int kRows>
__global__ void __launch_bounds__(kThreads)
bilateral_filter_and_cutoff_kernel(const float* __restrict__ depth,
                                   float* __restrict__ out, int height,
                                   int width, int radius_arg, float max_depth,
                                   float neg_k_xy, float neg_k_value) {
  constexpr int kTileH = kBlockY * kRows;
  extern __shared__ __align__(16) float tile[];
  const int r = kR >= 0 ? kR : radius_arg;
  const int halo = quad_halo(r);
  const int pitch = kTileW + 2 * halo;  // a multiple of 4
  const int quads = pitch / 4;
  const int tile_rows = kTileH + 2 * r;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;

  // The centers' cutoff test reads the raw depth (so the cutoff is exact),
  // loaded before the staging so that the two loads overlap.
  const int x = x0 + threadIdx.x;
  const int y_first = y0 + threadIdx.y * kRows;
  bool center_ok[kRows];
  bool any_ok = false;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = y_first + j;
    const float d = x < width && y < height
                        ? __ldg(depth + static_cast<size_t>(y) * width + x)
                        : 0.0f;
    center_ok[j] = d > 0.0f && d <= max_depth;
    any_ok = any_ok || center_ok[j];
  }

  // Stage the inverse depth: tile[row * pitch + c] is the sample at
  // (y0 - r + row, x0 - halo + c); 0 where d <= 0 or outside the image.
  const bool aligned = width % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(depth) & 15) == 0;
  for (int i = threadIdx.y * kBlockX + threadIdx.x; i < tile_rows * quads;
       i += kThreads) {
    const int row = i / quads;
    const int gy = y0 - r + row;
    const int gx = x0 - halo + 4 * (i - row * quads);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gy >= 0 && gy < height) {
      const float* src = depth + static_cast<size_t>(gy) * width;
      if (aligned && gx >= 0 && gx + 3 < width) {
        v = __ldg(reinterpret_cast<const float4*>(src + gx));
      } else {
        if (gx >= 0 && gx < width) v.x = __ldg(src + gx);
        if (gx + 1 >= 0 && gx + 1 < width) v.y = __ldg(src + gx + 1);
        if (gx + 2 >= 0 && gx + 2 < width) v.z = __ldg(src + gx + 2);
        if (gx + 3 >= 0 && gx + 3 < width) v.w = __ldg(src + gx + 3);
      }
    }
    v.x = v.x > 0.0f ? 1.0f / v.x : 0.0f;
    v.y = v.y > 0.0f ? 1.0f / v.y : 0.0f;
    v.z = v.z > 0.0f ? 1.0f / v.z : 0.0f;
    v.w = v.w > 0.0f ? 1.0f / v.w : 0.0f;
    *reinterpret_cast<float4*>(tile + i * 4) = v;
  }
  __syncthreads();

  if (x >= width || y_first >= height) return;
  // The centers' inverse depths: the same IEEE values, from the tile.
  float inv_center[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    inv_center[j] =
        tile[(threadIdx.y * kRows + j + r) * pitch + threadIdx.x + halo];
  }
  if (!any_ok) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (y_first + j < height)
        out[static_cast<size_t>(y_first + j) * width + x] = 0.0f;
    }
    return;
  }

  float weight_sum[kRows];
  float value_sum[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    weight_sum[j] = 0.0f;
    value_sum[j] = 0.0f;
  }
  // base[row * pitch + k]: the sample at dy = row - j - r, dx = k - r of
  // output j of this thread.
  const float* base =
      tile + threadIdx.y * kRows * pitch + threadIdx.x + halo - r;
  if constexpr (kR >= 0) {
#pragma unroll
    for (int row = 0; row < kRows + 2 * kR; ++row) {
      float s[2 * kR + 1];
#pragma unroll
      for (int k = 0; k <= 2 * kR; ++k) s[k] = base[row * pitch + k];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int dy = row - j - kR;
        if (dy < -kR || dy > kR) continue;
#pragma unroll
        for (int k = 0; k <= 2 * kR; ++k) {
          const int dist_sq = (k - kR) * (k - kR) + dy * dy;
          if (dist_sq > kR * kR) continue;
          tap(inv_center[j], s[k], static_cast<float>(dist_sq) * neg_k_xy,
              neg_k_value, weight_sum[j], value_sum[j]);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      for (int dy = -r; dy <= r; ++dy) {
        const float* row = base + (j + r + dy) * pitch + r;
        for (int dx = -r; dx <= r; ++dx) {
          const int dist_sq = dx * dx + dy * dy;
          if (dist_sq > r * r) continue;  // the same for every thread
          tap(inv_center[j], row[dx], static_cast<float>(dist_sq) * neg_k_xy,
              neg_k_value, weight_sum[j], value_sum[j]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = y_first + j;
    if (y >= height) continue;
    const float result = weight_sum[j] > 0.0f
                             ? weight_sum[j] / fmaxf(value_sum[j], 1e-30f)
                             : 0.0f;
    out[static_cast<size_t>(y) * width + x] = center_ok[j] ? result : 0.0f;
  }
}

dim3 grid_for(int height, int width, int tile_h) {
  return dim3((width + kTileW - 1) / kTileW, (height + tile_h - 1) / tile_h);
}

struct Launch {
  const float* depth;
  float* out;
  int height, width, radius;
  float max_depth, neg_k_xy, neg_k_value;
  cudaStream_t stream;
};

// Tile kTile of kTileRows at run-time index `tile`: each of the two
// helpers below walks the table at compile time and acts on the instance
// whose index matches; an index outside the table gives
// cudaErrorInvalidValue.
template <int kTile = 0>
cudaError_t launch_tile(int tile, const Launch& a) {
  if constexpr (kTile < kNumTiles) {
    if (tile != kTile) return launch_tile<kTile + 1>(tile, a);
    constexpr int kRows = kTileRows[kTile];
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid = grid_for(a.height, a.width, kBlockY * kRows);
    const size_t smem = tile_bytes(a.radius, kBlockY * kRows);
    if (a.radius == kMainRadius) {
      bilateral_filter_and_cutoff_kernel<kMainRadius, kRows>
          <<<grid, block, smem, a.stream>>>(a.depth, a.out, a.height, a.width,
                                            a.radius, a.max_depth, a.neg_k_xy,
                                            a.neg_k_value);
    } else {
      bilateral_filter_and_cutoff_kernel<-1, kRows>
          <<<grid, block, smem, a.stream>>>(a.depth, a.out, a.height, a.width,
                                            a.radius, a.max_depth, a.neg_k_xy,
                                            a.neg_k_value);
    }
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

// The kernel of tile `tile` at this radius, with its tile's output rows;
// nullptr for an index outside the table.
template <int kTile = 0>
const void* kernel_for(int tile, int radius, int* tile_h) {
  if constexpr (kTile < kNumTiles) {
    if (tile != kTile) return kernel_for<kTile + 1>(tile, radius, tile_h);
    constexpr int kRows = kTileRows[kTile];
    *tile_h = kBlockY * kRows;
    return radius == kMainRadius
               ? reinterpret_cast<const void*>(
                     &bilateral_filter_and_cutoff_kernel<kMainRadius, kRows>)
               : reinterpret_cast<const void*>(
                     &bilateral_filter_and_cutoff_kernel<-1, kRows>);
  } else {
    return nullptr;
  }
}

}  // namespace

// The tile table: writes {threads down, outputs per thread} of each tile
// to out[2 i], out[2 i + 1] (when out is not null) and returns the number
// of tiles. Index 0 is the default.
extern "C" int badslam_bilateral_tiles(int* out) {
  if (out != nullptr) {
    for (int i = 0; i < kNumTiles; ++i) {
      out[2 * i] = kBlockY;
      out[2 * i + 1] = kTileRows[i];
    }
  }
  return kNumTiles;
}
extern "C" int badslam_bilateral_filter_and_cutoff(
    const float* depth, float* out, int height, int width, int radius,
    float max_depth, float denom_xy, float denom_value, int tile,
    void* stream) {
  const Launch a{depth, out, height, width, radius, max_depth,
                 static_cast<float>(-kLog2e / denom_xy),
                 static_cast<float>(-kLog2e / denom_value),
                 static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_tile(tile, a));
}

// How a launch of tile `tile` at this shape and radius fills the card, for
// reports: info[0..8] = grid x, grid y, threads per block, dynamic shared
// bytes per block, registers per thread, local (spill) bytes per thread,
// blocks resident per SM, SMs on the current device, threads an SM holds
// at most. Returns a CUDA error code.
extern "C" int badslam_bilateral_launch_info(int height, int width, int radius,
                                             int tile, int* info) {
  int tile_h = 0;
  const void* fn = kernel_for(tile, radius, &tile_h);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tile_bytes(radius, tile_h);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int blocks_per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, fn,
                                                        kThreads, smem);
  int device = 0;
  int sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int sm_threads = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sm_threads,
                                 cudaDevAttrMaxThreadsPerMultiProcessor, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = grid_for(height, width, tile_h);
  info[0] = static_cast<int>(grid.x);
  info[1] = static_cast<int>(grid.y);
  info[2] = kThreads;
  info[3] = static_cast<int>(smem);
  info[4] = attr.numRegs;
  info[5] = static_cast<int>(attr.localSizeBytes);
  info[6] = blocks_per_sm;
  info[7] = sms;
  info[8] = sm_threads;
  return 0;
}
