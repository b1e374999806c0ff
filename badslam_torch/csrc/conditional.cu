// CUDA-graph WHILE nodes, for a loop whose early exit is decided on the card.
//
// This is graph plumbing, not a port of a TPU kernel: the JAX package's
// steady frame (badslam_tpu/frontend.py _steady_frame_fn) is one compiled
// program whose Gauss-Newton early exit is a lax.while_loop
// (badslam_tpu/tracking/pairwise.py:450), so no value comes back to the
// host between a frame's upload and the next frame. The port captures that
// frame as one CUDA graph (badslam_torch/steady.py) in which each pyramid
// level's loop is one WHILE node (ops/conditional.py): its body is one
// Gauss-Newton iteration, which ends by writing the loop's condition ("not
// converged and under max_iterations") from a device flag. So a replay runs
// the same iterations as the host-read loop, with no host read.
//
// Recent PyTorch releases capture IF nodes themselves
// (CUDAGraph.begin_capture_to_if_node); PyTorch 2.11, for one, does not, and
// none captures WHILE nodes, so the port uses the runtime's own calls:
//   badslam_while_begin: on the capturing stream, a one-thread kernel copies
//     the device flag *pred into a new conditional handle, then a WHILE node
//     is added after it and the stream's capture continues after the node;
//     the body stream starts capturing into the node's body graph.
//   badslam_set_condition: on the body stream, the same one-thread kernel
//     sets the handle from *pred again (the body's last node).
//   badslam_while_end: ends the body's capture and returns the body graph.
// The set kernel reads one byte and writes the handle: its cost is the
// launch of a graph node (~1-2 us). Needs CUDA 12.4 or later (conditional
// nodes and cudaStreamBeginCaptureToGraph). Every function returns a
// cudaError_t (0 on success), or -1 when `parent` is not capturing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* num_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps,
                                  nullptr, num_deps);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps,
                                  num_deps);
#endif
}

}  // namespace

extern "C" int badslam_while_begin(void* parent, const void* pred, void* body,
                                   unsigned long long* handle_out) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
  cudaError_t err = capture_info(ps, &status, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  cudaGetLastError();  // clear an earlier call's error before the launch's
  set_condition<<<1, 1, 0, ps>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(ps, &status, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, num_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
#endif
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int badslam_set_condition(void* stream, unsigned long long handle,
                                     const void* pred) {
  cudaGetLastError();
  set_condition<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, static_cast<const bool*>(pred));
  return cudaGetLastError();
}

// Ends the body's capture; *graph_out is the body graph (owned by its node).
extern "C" int badslam_while_end(void* body, void** graph_out) {
  cudaGraph_t graph;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
  *graph_out = graph;
  return err;
}
