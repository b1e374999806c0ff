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
//
// Device stamps (utils/timing.py's StampTable), captured into the graphs:
//   badslam_stamp: a one-thread kernel reads the card's %globaltimer (ns)
//     and, in its begin form, writes it into a row's start; in its end form
//     adds now - start to the row's nanoseconds and one to its runs, and
//     with a ring also records (graph, frame, start, now) at the ring's
//     cursor. So a replay keeps its regions' device time on the card, and
//     the host reads the sums once per run with the launch counters. The
//     stamps of a region with a ring (a whole replay) are kernels of their
//     own names, stamp_replay_begin and stamp_replay_end, so that a trace
//     tells them from the other stamps of the same graph.
//   badslam_clock_pair: the globaltimer and a host clock (clock_gettime)
//     taken together, as a round trip through mapped host memory: a
//     one-thread kernel says it runs and waits; the host reads its clock
//     and lets it go; the kernel reads the globaltimer and writes it back;
//     the host reads its clock again as the value lands. The host time of
//     the reading is the middle of the two host readings, off by at most
//     half the round trip (about a microsecond), whatever the launch costs
//     (a profiler's hooks lengthen it by tens of microseconds). Call it on
//     an idle stream: it waits for the work queued before.

#include <cuda_runtime.h>
#include <stddef.h>
#include <time.h>

namespace {

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Row layout: [0] start of the open region, [1] nanoseconds, [2] runs.
// Ring control: [0] cursor (entries written), [1] the last frame index.
// Ring entry: graph, frame, start, end.
__device__ __forceinline__ void stamp_at(long long* row, int mode, long long* ctl,
                                         long long* ring, int ring_len,
                                         const long long* frame, long long graph) {
  long long now = globaltimer();
  if (mode == 0) {
    row[0] = now;
    return;
  }
  long long start = row[0];
  row[1] += now - start;
  row[2] += 1;
  if (mode == 2) {
    long long f = frame != nullptr ? *frame : ctl[1];
    ctl[1] = f;
    long long* e = ring + 4 * (ctl[0] % ring_len);
    ctl[0] += 1;
    e[0] = graph;
    e[1] = f;
    e[2] = start;
    e[3] = now;
  }
}

__global__ void stamp(long long* row, int mode, long long* ctl, long long* ring,
                      int ring_len, const long long* frame, long long graph) {
  stamp_at(row, mode, ctl, ring, ring_len, frame, graph);
}

__global__ void stamp_replay_begin(long long* row) {
  stamp_at(row, 0, nullptr, nullptr, 0, nullptr, 0);
}

__global__ void stamp_replay_end(long long* row, long long* ctl, long long* ring,
                                 int ring_len, const long long* frame, long long graph) {
  stamp_at(row, 2, ctl, ring, ring_len, frame, graph);
}

// slots[0]: set by the kernel when it runs; slots[1]: set by the host to
// let it go; slots[2]: the globaltimer reading. The kernel waits at most a
// second for the host.
__global__ void clock_round_trip(volatile long long* slots) {
  slots[0] = 1;
  __threadfence_system();
  long long give_up = globaltimer() + 1000000000LL;
  while (slots[1] == 0 && globaltimer() < give_up) {
  }
  slots[2] = globaltimer();
  __threadfence_system();
}

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

// mode 0: begin; 1: end; 2: end with a ring entry (`frame` may be null: the
// ring's last frame index is kept); 3: begin of a region with a ring.
extern "C" int badslam_stamp(void* stream, void* row, int mode, void* ctl,
                             void* ring, int ring_len, const void* frame,
                             long long graph) {
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* r = static_cast<long long*>(row);
  long long* c = static_cast<long long*>(ctl);
  long long* g = static_cast<long long*>(ring);
  const long long* f = static_cast<const long long*>(frame);
  if (mode == 3)
    stamp_replay_begin<<<1, 1, 0, s>>>(r);
  else if (mode == 2)
    stamp_replay_end<<<1, 1, 0, s>>>(r, c, g, ring_len, f, graph);
  else
    stamp<<<1, 1, 0, s>>>(r, mode, c, g, ring_len, f, graph);
  return cudaGetLastError();
}

// One (host ns on clock `clock_id`, globaltimer ns, round trip ns) triple;
// returns -2 when the kernel did not answer within a second.
extern "C" int badslam_clock_pair(void* stream, int clock_id, long long* host_ns,
                                  long long* device_ns, long long* round_trip_ns) {
  static volatile long long* slots = nullptr;
  static long long* device_slots = nullptr;
  cudaError_t err;
  if (slots == nullptr) {
    void* p = nullptr;
    err = cudaHostAlloc(&p, 3 * sizeof(long long), cudaHostAllocMapped);
    if (err != cudaSuccess) return err;
    void* d = nullptr;
    err = cudaHostGetDevicePointer(&d, p, 0);
    if (err != cudaSuccess) return err;
    slots = static_cast<volatile long long*>(p);
    device_slots = static_cast<long long*>(d);
  }
  slots[0] = slots[1] = slots[2] = 0;
  cudaGetLastError();
  clock_round_trip<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(device_slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  struct timespec deadline, now, before, after;
  clock_gettime(CLOCK_MONOTONIC, &deadline);
  deadline.tv_sec += 1;
  for (;;) {
    if (slots[0] != 0) break;
    clock_gettime(CLOCK_MONOTONIC, &now);
    if (now.tv_sec > deadline.tv_sec ||
        (now.tv_sec == deadline.tv_sec && now.tv_nsec > deadline.tv_nsec)) {
      slots[1] = 1;  // a kernel that starts late does not wait
      return -2;
    }
  }
  clock_gettime(static_cast<clockid_t>(clock_id), &before);
  slots[1] = 1;
  long long seen;
  for (;;) {
    seen = slots[2];
    if (seen != 0) break;
  }
  clock_gettime(static_cast<clockid_t>(clock_id), &after);
  long long t0 = static_cast<long long>(before.tv_sec) * 1000000000LL + before.tv_nsec;
  long long t1 = static_cast<long long>(after.tv_sec) * 1000000000LL + after.tv_nsec;
  *host_ns = t0 + (t1 - t0) / 2;
  *device_ns = seen;
  *round_trip_ns = t1 - t0;
  return 0;
}
