"""CUDA-graph WHILE nodes, captured around PyTorch work (``csrc/conditional.cu``).

``WhileNodes`` serves one capture: inside ``with nodes.while_(cond):`` the
block's work goes into the body of a new WHILE node of the graph being
captured on the current stream. At replay the body runs while the device
flag `cond` (a CUDA bool scalar) is true: the card reads it when the node is
reached and again at the end of each run of the body, so the block must
update `cond` in place and make it false within a bounded number of runs.
The body is captured on a stream of its own, and its tensors are allocated
from a memory pool that belongs to the capture, so nothing of a body is
handed out again while the graph lives. Keep the ``WhileNodes`` alive as
long as the graph.

A tensor made inside a body holds a value only when the body ran: copy what
the rest of the graph needs into tensors made outside the body (the body's
``copy_`` is part of the body). A failure to add a node or to capture a body
raises RuntimeError naming the call and the CUDA error; nothing falls back
to the host.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from badslam_torch.ops import kernels

SOURCE = "conditional.cu"


def _lib():
    lib = kernels._library(SOURCE)
    lib.badslam_while_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_ulonglong)]
    lib.badslam_set_condition.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong,
                                          ctypes.c_void_p]
    lib.badslam_while_end.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    for fn in (lib.badslam_while_begin, lib.badslam_set_condition, lib.badslam_while_end):
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(f"{what}: the current stream is not capturing a CUDA graph")
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


# libcuda's node type of a kernel (CU_GRAPH_NODE_TYPE_KERNEL).
_KERNEL_NODE = 0


def node_counts(graph_handle: int) -> tuple:
    """(nodes, kernel nodes) at the top level of a CUDA graph (a cudaGraph_t
    as an int, e.g. ``CUDAGraph.raw_cuda_graph()`` of a graph made with
    keep_graph=True), read through libcuda (cuGraphGetNodes, cuGraphNodeGetType)."""
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(ctypes.c_void_p(graph_handle), None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(ctypes.c_void_p(graph_handle), nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    kernels_ = 0
    kind = ctypes.c_int(0)
    for node in nodes[: n.value]:
        _check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        kernels_ += kind.value == _KERNEL_NODE
    return n.value, kernels_


class WhileNodes:
    """The WHILE nodes of one capture on `device`: ``count`` counts them and
    ``bodies`` holds their body graphs (for ``body_node_counts``)."""

    def __init__(self, device: torch.device):
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.MemPool()
        self.count = 0
        self.bodies = []

    @contextlib.contextmanager
    def while_(self, cond: torch.Tensor):
        if not (cond.is_cuda and cond.dtype == torch.bool and cond.numel() == 1):
            raise ValueError(f"a WHILE node's condition must be a CUDA bool scalar, got "
                             f"{tuple(cond.shape)} {cond.dtype} on {cond.device}")
        lib = _lib()
        parent = torch.cuda.current_stream(self.device)
        handle = ctypes.c_ulonglong()
        _check(lib.badslam_while_begin(parent.cuda_stream, cond.data_ptr(),
                                       self.stream.cuda_stream, ctypes.byref(handle)),
               "capturing a WHILE node (cudaGraphAddNode / cudaStreamBeginCaptureToGraph)")
        body = ctypes.c_void_p()
        try:
            with torch.cuda.stream(self.stream), torch.cuda.use_mem_pool(self.pool, self.device):
                yield
                _check(lib.badslam_set_condition(self.stream.cuda_stream, handle.value,
                                                 cond.data_ptr()),
                       "setting a WHILE node's condition in its body")
        finally:
            err = lib.badslam_while_end(self.stream.cuda_stream, ctypes.byref(body))
        _check(err, "ending a WHILE node's body (cudaStreamEndCapture)")
        self.count += 1
        self.bodies.append(body.value)

    def body_node_counts(self) -> tuple:
        """(nodes, kernel nodes) in all the bodies together."""
        counts = [node_counts(b) for b in self.bodies]
        return sum(c[0] for c in counts), sum(c[1] for c in counts)
