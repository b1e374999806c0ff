"""CUDA-graph WHILE nodes, captured around PyTorch work (``csrc/conditional.cu``),
and the three controls of a loop whose exit is decided by a device flag.

``WhileNodes`` serves one capture: inside ``with nodes.while_(cond):`` the
block's work goes into the body of a new WHILE node of the graph being
captured on the current stream. At replay the body runs while the device
flag `cond` (a CUDA bool scalar) is true: the card reads it when the node is
reached and again at the end of each run of the body, so the block must
update `cond` in place and make it false within a bounded number of runs.
WHILE nodes nest: a ``while_`` opened inside a body adds its node to that
body's graph. Each nesting depth captures its bodies on a stream of its own
(made with the ``WhileNodes``, up to `depth` levels), and every body's
tensors are allocated from a memory pool that belongs to the capture, so
nothing of a body is handed out again while the graph lives. Keep the
``WhileNodes`` alive as long as the graph.

A tensor made inside a body holds a value only when the body ran: copy what
the rest of the graph needs into tensors made outside the body (the body's
``copy_`` is part of the body). A failure to add a node or to capture a body
raises RuntimeError naming the call and the CUDA error; nothing falls back
to the host.

``loop`` runs a loop "while cond(state), at most n times" under one of three
controls, with the same result under each:

* ``HOST``: the plain loop, reading the flag back to the host before each
  step (the eager path on the CPU and on a card);
* ``MASKED``: `n` steps with no host read, each step's new state taken only
  where the flag held (``torch.where``); the plain version of the device
  loop, for tests;
* a ``DeviceControl``: inside a CUDA-graph capture, one WHILE node whose body
  is one step and ends by writing the flag, so the card decides the exit.

``for_each_slot`` applies a step to every set slot of a [K] mask in slot
order on top of ``loop``: the host loop over the set slots; every slot
with the step's result kept where the mask is set; or one WHILE node whose
body takes the next set slot from a device cursor, so it runs once per set
slot and not at all for an empty mask. It is the counterpart of the JAX
package's scan over the slots with a ``lax.cond`` on each slot's mask.

``GraphOwner`` is the one way the port captures, counts, stamps, records
and replays a CUDA graph of such loops; the steady frame, the BA call and
the closure attempt each own their graphs through it.

The same source holds the device stamps' kernels (``stamp``,
``clock_pair``; ``utils.timing`` captures them): a
``DeviceControl`` stamps each WHILE node it adds.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from collections import Counter
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.profiler import record_function

from badslam_torch.ops import kernels
from badslam_torch.utils.timing import Timing, stamped

SOURCE = "conditional.cu"


def _lib():
    lib = kernels._library(SOURCE)
    lib.badslam_while_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_ulonglong)]
    lib.badslam_set_condition.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong,
                                          ctypes.c_void_p]
    lib.badslam_while_end.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.badslam_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_longlong]
    lib.badslam_clock_pair.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_longlong),
                                       ctypes.POINTER(ctypes.c_longlong),
                                       ctypes.POINTER(ctypes.c_longlong)]
    for fn in (lib.badslam_while_begin, lib.badslam_set_condition, lib.badslam_while_end,
               lib.badslam_stamp, lib.badslam_clock_pair):
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(f"{what}: the current stream is not capturing a CUDA graph")
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


# The stamp kernel's forms (csrc/conditional.cu badslam_stamp); a region
# with a ring entry begins with STAMP_BEGIN_RING and ends with STAMP_END_RING
# (kernels named stamp_replay_begin and stamp_replay_end in a trace).
STAMP_BEGIN, STAMP_END, STAMP_END_RING, STAMP_BEGIN_RING = 0, 1, 2, 3


def stamp(row: torch.Tensor, mode: int, ctl: torch.Tensor, ring: torch.Tensor,
          frame: Optional[torch.Tensor] = None, graph: int = 0) -> None:
    """Launch the one-thread stamp kernel on the current stream of `row`'s
    device: the begin forms write the card's globaltimer into row[0]; the
    end forms add the time since row[0] to row[1] and one to row[2], and
    STAMP_END_RING also writes (graph, frame, start, end) at the ring's
    cursor ctl[0] (`frame`: a device int64 scalar holding the frame index,
    kept in ctl[1]; None repeats ctl[1]). All int64 on one CUDA device."""
    stream = torch.cuda.current_stream(row.device).cuda_stream
    _check(_lib().badslam_stamp(stream, row.data_ptr(), mode, ctl.data_ptr(),
                                ring.data_ptr(), ring.shape[0],
                                None if frame is None else frame.data_ptr(), graph),
           "launching a device stamp")


def clock_pair(device: torch.device, clock_id: int) -> Tuple[int, int, int]:
    """(host ns on the clock `clock_id` of time.clock_gettime, the card's
    globaltimer ns, the round trip's ns) read together on `device`'s current
    stream, which should be idle: the host waits for the work queued
    before. The host time is the middle of a round trip through mapped
    memory, so the launch's cost does not enter it."""
    host, dev, round_trip = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib().badslam_clock_pair(stream, clock_id, ctypes.byref(host), ctypes.byref(dev),
                                    ctypes.byref(round_trip))
    if err == -2:
        raise RuntimeError("reading the globaltimer beside the host clock: the kernel did "
                           "not answer within a second")
    _check(err, "reading the globaltimer beside the host clock")
    return host.value, dev.value, round_trip.value


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
    """The WHILE nodes of one capture on `device`, nested up to `depth`
    levels: ``count`` counts them and ``bodies`` holds their body graphs
    (for ``body_node_counts``). ``streams`` are the body streams, one per
    depth, made here so that a caller can set up library state on them
    before the capture."""

    def __init__(self, device: torch.device, depth: int = 1):
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        # Made before the capture, so that its regions can be stamped.
        Timing.stamp_table(device)
        self.streams = [torch.cuda.Stream(self.device) for _ in range(max(1, depth))]
        self.pool = torch.cuda.MemPool()
        self.count = 0
        self.bodies = []
        self._depth = 0

    @property
    def stream(self) -> torch.cuda.Stream:
        return self.streams[0]

    @contextlib.contextmanager
    def while_(self, cond: torch.Tensor):
        if not (cond.is_cuda and cond.dtype == torch.bool and cond.numel() == 1):
            raise ValueError(f"a WHILE node's condition must be a CUDA bool scalar, got "
                             f"{tuple(cond.shape)} {cond.dtype} on {cond.device}")
        if self._depth >= len(self.streams):
            raise RuntimeError(f"WHILE nodes nested deeper than the {len(self.streams)} "
                               f"levels this capture was made for")
        lib = _lib()
        parent = torch.cuda.current_stream(self.device)
        stream = self.streams[self._depth]
        handle = ctypes.c_ulonglong()
        _check(lib.badslam_while_begin(parent.cuda_stream, cond.data_ptr(),
                                       stream.cuda_stream, ctypes.byref(handle)),
               "capturing a WHILE node (cudaGraphAddNode / cudaStreamBeginCaptureToGraph)")
        body = ctypes.c_void_p()
        # The outermost body routes this thread's allocations to the pool;
        # the bodies nested in it allocate from it already.
        pool = (torch.cuda.use_mem_pool(self.pool, self.device) if self._depth == 0
                else contextlib.nullcontext())
        self._depth += 1
        try:
            with torch.cuda.stream(stream), pool:
                yield
                _check(lib.badslam_set_condition(stream.cuda_stream, handle.value,
                                                 cond.data_ptr()),
                       "setting a WHILE node's condition in its body")
        finally:
            self._depth -= 1
            err = lib.badslam_while_end(stream.cuda_stream, ctypes.byref(body))
        _check(err, "ending a WHILE node's body (cudaStreamEndCapture)")
        self.count += 1
        self.bodies.append(body.value)

    def body_node_counts(self) -> tuple:
        """(nodes, kernel nodes) in all the bodies together (a nested body's
        nodes are counted in its own entry, not in its parent's)."""
        counts = [node_counts(b) for b in self.bodies]
        return sum(c[0] for c in counts), sum(c[1] for c in counts)


# ---------------------------------------------------------------------------
# Loop controls
# ---------------------------------------------------------------------------

HOST = "host"
MASKED = "masked"


class DeviceControl:
    """Loops as WHILE nodes of the graph being captured. `nodes` is the
    capture's ``WhileNodes``; `units` a device int64 tensor made (zeroed)
    before the capture, with an entry per body: each run of body j adds one
    to ``units[j]``. ``body_launches[j]`` holds the kernel launches captured
    in body j (``kernels.count_into``; one run's, a nested body's apart),
    ``body_names[j]`` its name and ``body_graphs[j]`` its body graph (for
    ``node_counts``). Each WHILE node is stamped in its parent graph
    (``utils.timing.stamped``) as "<scope>: <body name>": its device time
    per replay that reaches it, the bodies' runs included."""

    def __init__(self, nodes: WhileNodes, units: torch.Tensor, scope: str):
        self.nodes = nodes
        self.units = units
        self.scope = scope
        self.body_launches: List[Counter] = []
        self.body_names: List[str] = []
        self.body_graphs: List[int] = []

    @contextlib.contextmanager
    def body(self, flag: torch.Tensor, name: str):
        j = len(self.body_launches)
        if j >= self.units.numel():
            raise RuntimeError(f"more WHILE bodies than the {self.units.numel()} "
                               f"counters made for this capture")
        launches = Counter()
        self.body_launches.append(launches)
        self.body_names.append(name)
        self.body_graphs.append(0)
        with stamped(f"{self.scope}: {name}", self.nodes.device), \
                self.nodes.while_(flag), kernels.count_into(launches):
            yield
            self.units[j:j + 1].add_(1)
        self.body_graphs[j] = self.nodes.bodies[-1]


Control = Union[str, DeviceControl]
State = Tuple[torch.Tensor, ...]


def loop(control: Control, state: Sequence[torch.Tensor],
         cond: Callable[[State], torch.Tensor], step: Callable[[State], Sequence[torch.Tensor]],
         most: Optional[int] = None, limit: Optional[torch.Tensor] = None,
         name: str = "loop", step_in_place: Optional[Callable] = None,
         ) -> Tuple[State, Union[int, torch.Tensor]]:
    """Run ``state = step(state)`` while ``cond(state)`` (a bool scalar
    tensor) holds, at most `most` times (a host int) and, with `limit` (an
    integer scalar tensor), fewer than `limit` times. Returns (state, steps
    run): an int under HOST, an int64 scalar tensor otherwise. `step` must
    not change the tensors it is given. HOST and MASKED need `most`; a
    DeviceControl takes the bound from `limit` when given (so one capture
    serves any bound), else from `most`. Under a DeviceControl,
    `step_in_place(bufs, i, flag, most)`, when given, is the whole body: it
    updates the state buffers in place, adds one to the steps counter `i`
    and writes the condition `flag` (cond and i < most) itself, as `step`
    and the loop's own updates would; it takes the host bound `most`, so
    not `limit`."""
    if step_in_place is not None and limit is not None:
        raise ValueError("step_in_place takes the host bound `most`, not `limit`")
    state = tuple(state)
    if control == HOST:
        i = 0
        while i < most and (limit is None or i < int(limit)) and bool(cond(state)):
            state = tuple(step(state))
            i += 1
        return state, i
    ref = state[0]
    if control == MASKED:
        i = torch.zeros((), dtype=torch.int64, device=ref.device)
        for _ in range(most):
            run = cond(state)
            if limit is not None:
                run = run & (i < limit)
            new = tuple(step(state))
            # (The flag goes to each tensor's device: a mesh's state spans several.)
            state = tuple(torch.where(run.to(n.device), n, o) for n, o in zip(new, state))
            i = i + run.to(torch.int64)
        return state, i
    if not isinstance(control, DeviceControl):
        raise ValueError(f"unknown loop control {control!r}")
    # The state lives in buffers made outside the body, which updates them
    # in place; `flag` is the WHILE node's condition.
    bound = limit if limit is not None else most
    bufs = tuple(s.clone() for s in state)
    i = torch.zeros((), dtype=torch.int64, device=ref.device)
    flag = cond(bufs) & (i < bound)
    with control.body(flag, name):
        if step_in_place is not None:
            step_in_place(bufs, i, flag, bound)
        else:
            new = tuple(step(bufs))
            for b, n in zip(bufs, new):
                if n is not b:
                    b.copy_(n)
            i.add_(1)
            flag.copy_(cond(bufs) & (i < bound))
    return bufs, i


def pick(x: torch.Tensor, i: Union[int, torch.Tensor]) -> torch.Tensor:
    """Row i of x, for a host int or an integer scalar tensor."""
    if isinstance(i, int):
        return x[i]
    return x.index_select(0, i.reshape(1)).squeeze(0)


def for_each_slot(control: Control, mask: torch.Tensor, state: Sequence[torch.Tensor],
                  step: Callable[[State, Union[int, torch.Tensor]], Sequence[torch.Tensor]],
                  name: str = "slots") -> State:
    """``state = step(state, i)`` for each set slot i of the [K] bool mask,
    in slot order (module docstring). `i` is a host int under HOST and
    MASKED, an int64 scalar tensor under a DeviceControl. `step` must not
    change the tensors it is given."""
    state = tuple(state)
    k = mask.shape[0]
    if control == HOST:
        for i in torch.nonzero(mask).flatten().tolist():
            state = tuple(step(state, i))
        return state
    if control == MASKED:
        for i in range(k):
            new = tuple(step(state, i))
            state = tuple(torch.where(mask[i].to(n.device), n, o) for n, o in zip(new, state))
        return state
    slots = torch.arange(k, device=mask.device)

    def next_slot(cursor):
        return torch.where(mask & (slots >= cursor), slots, k).amin()

    def cond(st):
        return next_slot(st[-1]) < k

    def advance(st):
        i = next_slot(st[-1])
        return (*step(st[:-1], i), i + 1)

    cursor = torch.zeros((), dtype=torch.int64, device=mask.device)
    out, _ = loop(control, (*state, cursor), cond, advance, most=k, name=name)
    return out[:-1]


# ---------------------------------------------------------------------------
# Graph owners
# ---------------------------------------------------------------------------

class Captured(NamedTuple):
    """One graph of a ``GraphOwner`` and what a replay of it needs."""
    graph: torch.cuda.CUDAGraph
    control: DeviceControl   # its bodies and WHILE nodes (which keep the bodies'
                             # memory pool alive); control.units[j]: runs of body j
    launches: Counter        # kernel launches of one replay outside the bodies
    outputs: Any             # what the captured work returned (graph memory)
    record: dict             # its entry of the owner's ``captures``


class GraphOwner:
    """What the port's CUDA-graph owners (``steady.SteadyFrameGraph``,
    ``ba.graph.BAGraph``, ``loop.graph.ClosureGraph``) share: one CUDA
    device, their graphs by key (``_graphs``), a record per capture
    (``captures``), the replays (``replays``), and how a graph is captured
    and replayed.

    A capture runs on a side stream with ``capture_error_mode=
    "thread_local"``, its loops as WHILE nodes of one ``DeviceControl``
    (scope: the owner's stamp prefix), inside the profiler range
    "capture/<name>" and a ring-stamped region named after the scope. A
    capture or instantiation failure raises RuntimeError; nothing falls back
    to an eager call. Its launches are counted as ``kernels`` says: those
    outside the bodies per replay on the host, those of each body per run
    from ``control.units`` (``kernels.count_on_device``). Each record holds
    the owner's own fields, then the capture and instantiate seconds, node
    counts (all; kernel nodes; kernel nodes outside the bodies; per body,
    in capture order, (body name, kernel nodes)), the WHILE nodes, the
    memory the capture's pools reserved and the replays."""

    # A host timer around each replay's launch (``Timing.time``), or None.
    launch_timer: Optional[str] = None

    def __init__(self, device: torch.device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"{type(self).__name__} runs on a CUDA device, not {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._graphs: Dict[Any, Captured] = {}
        self.captures: List[dict] = []
        self.replays = 0
        Timing.stamp_table(device)

    def _capture(self, scope: str, name: str, bodies: int,
                 work: Callable[[DeviceControl], Any], depth: int = 1,
                 warm_up: Optional[Callable[[], None]] = None,
                 frame: Optional[torch.Tensor] = None, **fields) -> Captured:
        """Capture ``work(control)`` as one graph: `bodies` WHILE bodies at
        most, nested `depth` deep; `warm_up`, when given, runs first on each
        capture stream (library state: handles and workspaces), outside the
        timed span; `frame` goes to the ring stamp. The record starts with
        `fields`."""
        device = self.device
        current = torch.cuda.current_stream(device)
        stream = torch.cuda.Stream(device)
        nodes = WhileNodes(device, depth)
        if warm_up is not None:
            for s in (stream, *nodes.streams):
                s.wait_stream(current)
                with torch.cuda.stream(s):
                    warm_up()
                current.wait_stream(s)
        units = torch.zeros(bodies, dtype=torch.int64, device=device)
        control = DeviceControl(nodes, units, scope=scope)
        launches: Counter = Counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        reserved = torch.cuda.memory_reserved(device)
        stream.wait_stream(current)
        t0 = time.perf_counter()
        try:
            with record_function(f"capture/{name}"), torch.cuda.stream(stream), \
                    kernels.count_into(launches):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    with stamped(scope, device, ring=True, frame=frame):
                        outputs = work(control)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                graph.capture_end()
            t1 = time.perf_counter()
            graph.instantiate()
        except Exception as e:
            raise RuntimeError(f"badslam_torch: capturing the {scope} as a CUDA graph "
                               f"failed: {type(e).__name__}: {e}") from e
        t2 = time.perf_counter()
        current.wait_stream(stream)
        top, top_kernels = node_counts(graph.raw_cuda_graph())
        counts = [node_counts(b) for b in control.body_graphs]
        record = dict(
            fields, capture_s=t1 - t0, instantiate_s=t2 - t1,
            nodes=top + sum(n for n, _ in counts),
            kernel_nodes=top_kernels + sum(k for _, k in counts),
            top_kernel_nodes=top_kernels,
            body_kernel_nodes=[(body, k) for body, (_, k) in zip(control.body_names, counts)],
            while_nodes=nodes.count,
            reserved_mib=(torch.cuda.memory_reserved(device) - reserved) / 2**20,
            replays=0)
        kernels.count_on_device(graph, units, control.body_launches)
        self.captures.append(record)
        return Captured(graph, control, launches, outputs, record)

    def _replay(self, captured: Captured) -> None:
        """Replay a graph of this owner and count it (its launches outside
        the bodies on the host; the bodies' on the card)."""
        kernels.add_launches(captured.launches)
        with (Timing.time(self.launch_timer) if self.launch_timer
              else contextlib.nullcontext()):
            captured.graph.replay()
        captured.record["replays"] += 1
        self.replays += 1

