// Image gathers at integer pixel indices: K2 (gather) and K3 (gather_onehot).
//
// K2 replaces the Pallas TPU kernel
//   tools/probe_pallas_gather.py:82 pallas_gather_rowblock
// which computes out[y, x] = img.flat[py[y, x] * w + px[y, x]] with the
// whole image in VMEM; in the JAX package the same function is
// badslam_tpu/ops/interp.py:18 gather_nearest (jnp.take). Here it is the
// port's gather_nearest on a CUDA tensor: BA association, surfel creation,
// deletion and normal updates, and the tracker's bilinear taps all reach
// it. Semantics are those of jnp.take's default fill mode: a flat index i in
// [-n, 0) reads i + n, and any index outside [-n, n) gives NaN. It never
// reads out of bounds.
//
// What bounds K2 on an H100: each output reads 8-16 bytes of index (two
// int32 or int64 planes) plus 4 bytes of image and writes 4 bytes, with no
// arithmetic to speak of, so it is bound by memory. The index fields of the
// callers are near-coherent (projections of neighbouring surfels or
// pixels), so the image reads mostly hit L1/L2; __ldg routes them through
// the read-only path. One thread per output, 64-bit index arithmetic. The
// batch axis [B, H, W] x [B, N] serves the per-keyframe gathers of BA in one
// launch per plane. Fusing the 3-4 planes gathered at one index, or the
// tracker's 4-tap bilinear quad, into one pass is later perf work.
//
// K3 replaces the Pallas TPU kernel
//   tools/probe_pallas_gather.py:120 pallas_gather_onehot
// the same gather as a one-hot product over a row window: for the 8-row
// block i = y / 8 it returns img[py, px] where 8i - 4 <= py < 8i + 12 and
// 0 <= px < w (rows outside the image read the zero padding), else 0. It
// is approximate by construction and exists only on the probe path
// (badslam_torch/probe_gather.py). The TPU kernel may round its one-hot
// matrix product through bf16 MXU passes; a one-hot row times a value is
// the value, so this kernel reads the value directly and is exact in f32,
// like the CPU interpret mode it is held to. Unlike the TPU kernel, which
// leaves the rows from (H / 8) * 8 on unwritten, it writes every row by the
// same rule. Bound by memory as K2 (int32 indices only, as the probe's).
//
// Neither kernel allocates or synchronizes; each launcher returns
// cudaGetLastError() for the caller to check. Build without
// --use_fast_math (there is no float math to speed up anyway).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOneHotBlockRows = 8;
constexpr int kOneHotPad = 4;

template <typename Index>
__global__ void gather_kernel(const float* __restrict__ img,
                              const Index* __restrict__ px,
                              const Index* __restrict__ py,
                              float* __restrict__ out, int64_t total,
                              int64_t per_batch, int height, int width) {
  const int64_t size = static_cast<int64_t>(height) * width;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int64_t flat = static_cast<int64_t>(py[i]) * width +
                   static_cast<int64_t>(px[i]);
    if (flat < 0) flat += size;  // jnp.take wraps a negative index once
    const int64_t b = i / per_batch;
    out[i] = (flat >= 0 && flat < size) ? __ldg(img + b * size + flat)
                                        : __int_as_float(0x7fc00000);  // NaN
  }
}

__global__ void gather_onehot_kernel(const float* __restrict__ img,
                                     const int32_t* __restrict__ px,
                                     const int32_t* __restrict__ py,
                                     float* __restrict__ out, int height,
                                     int width) {
  const int64_t total = static_cast<int64_t>(height) * width;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int y = static_cast<int>(i / width);
    const int lo = (y / kOneHotBlockRows) * kOneHotBlockRows - kOneHotPad;
    const int hi = lo + kOneHotBlockRows + 2 * kOneHotPad;
    const int32_t r = py[i];
    const int32_t c = px[i];
    const bool hit = r >= lo && r < hi && r >= 0 && r < height && c >= 0 &&
                     c < width;
    out[i] = hit ? __ldg(img + static_cast<int64_t>(r) * width + c) : 0.0f;
  }
}

int grid_for(int64_t total) {
  // Enough blocks to fill the card several times over; the grid-stride
  // loops cover the rest.
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65536 ? blocks : 65536);
}

template <typename Index>
int launch_gather(const float* img, const Index* px, const Index* py,
                  float* out, int64_t batch, int64_t per_batch, int height,
                  int width, void* stream) {
  const int64_t total = batch * per_batch;
  gather_kernel<Index><<<grid_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      img, px, py, out, total, per_batch, height, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int badslam_gather_i32(const float* img, const int32_t* px,
                                  const int32_t* py, float* out,
                                  int64_t batch, int64_t per_batch,
                                  int height, int width, void* stream) {
  return launch_gather<int32_t>(img, px, py, out, batch, per_batch, height,
                                width, stream);
}

extern "C" int badslam_gather_i64(const float* img, const int64_t* px,
                                  const int64_t* py, float* out,
                                  int64_t batch, int64_t per_batch,
                                  int height, int width, void* stream) {
  return launch_gather<int64_t>(img, px, py, out, batch, per_batch, height,
                                width, stream);
}

extern "C" int badslam_gather_onehot(const float* img, const int32_t* px,
                                     const int32_t* py, float* out,
                                     int height, int width, void* stream) {
  const int64_t total = static_cast<int64_t>(height) * width;
  gather_onehot_kernel<<<grid_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      img, px, py, out, height, width);
  return static_cast<int>(cudaGetLastError());
}
