"""One captured CUDA graph per (shape signature, outputs): the port's
counterpart of the JAX Engine's jitted program per signature
(recom_tpu/runtime/executor.py:661-680 ``_get_jitted``, cached in
``_jit_cache`` at :201-205).

A ``Program`` holds what one forward needs to run again with no Python in
the way: static device input buffers shaped by the signature (the wire
blob, whose size the signature fixes, or one buffer per structured
array), the captured ``torch.cuda.CUDAGraph``, the graph's own output
tensors, and the kernel launches the graph holds.  A replay reads the
static inputs and writes the static outputs: every pointer baked into the
graph (the kernels' arguments, X1's by-value descriptors) points into
them, into the graph's memory pool, into the Engine's live parameter
tensors, which are only ever written in place, or into the plan arrays
that the program itself holds (``kept``: what the recorded launches named
in their ``keep``, such as X1b's work items and Part's member rows, which
otherwise only a bounded cache holds).

``Program.capture`` makes one.  The request's pinned host arrays are
copied into fresh static inputs; one eager pass of the forward then runs
on the capture stream: it builds and loads the kernels, makes the hash
constants and fills the allocator, so that nothing runs for the first
time under capture, and its outputs serve the request.  Then the forward
is captured with ``capture_error_mode="thread_local"``, so that other
threads (the serving pipeline's prep workers allocating pinned memory)
cannot invalidate it.  The caller holds the Engine's dispatch lock
throughout, and every replay runs under it too, one at a time on the
caller's stream: that is why all of one Engine's graphs can share one
memory pool, and why a copy into a program's static inputs is queued
after the previous replay that read them.

Launch accounting (``ops/kernels.launches``): the eager pass counts, as
any launch on the card does; the capture queues nothing, so its launches
are recorded (``kernels.recording``) and not counted.  The captured graph
is then read back through libcuda (``graph_launches``): its kernel
nodes, named by ``kernels.kernel_of``, are the launches the program holds,
and a capture whose graph holds other kernels than the recorded launches
(one left out, say, or launched on another stream) raises.  Each replay
adds what its graph holds.  A request is thus counted once, whichever way
it ran.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch

from recom_tpu_torch.ops import kernels
from recom_tpu_torch.utils import spans
from recom_tpu_torch.utils.tree import tree_leaves, tree_map


_CU_GRAPH_NODE_TYPE_KERNEL = 0
_libcuda_handle = None


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _libcuda():
    """libcuda, CUDA's low-level API, loaded on first use."""
    global _libcuda_handle
    if _libcuda_handle is None:
        lib = ctypes.CDLL("libcuda.so.1")
        _P = ctypes.c_void_p
        for fn, args in (
                ("cuGraphGetNodes", [_P, _P, ctypes.POINTER(ctypes.c_size_t)]),
                ("cuGraphNodeGetType", [_P, ctypes.POINTER(ctypes.c_int)]),
                ("cuGraphKernelNodeGetParams_v2",
                 [_P, ctypes.POINTER(_KernelNodeParams)]),
                ("cuFuncGetName", [ctypes.POINTER(ctypes.c_char_p), _P]),
                ("cuGetErrorString", [ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_char_p)])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _libcuda_handle = lib
    return _libcuda_handle


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = ctypes.c_char_p()
        _libcuda().cuGetErrorString(err, ctypes.byref(msg))
        raise RuntimeError(f"{what} failed: "
                           f"{(msg.value or b'?').decode()} ({err})")


def graph_functions(graph: int) -> list:
    """The device function names (mangled) of the kernel nodes of the CUDA
    graph ``graph`` (a ``cudaGraph_t``)."""
    cu = _libcuda()
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    names = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value == _CU_GRAPH_NODE_TYPE_KERNEL:
            p = _KernelNodeParams()
            _check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
                   "cuGraphKernelNodeGetParams")
            name = ctypes.c_char_p()
            _check(cu.cuFuncGetName(ctypes.byref(name), p.func),
                   "cuFuncGetName")
            names.append(name.value.decode())
    return names


def graph_launches(graph: int) -> Dict[str, int]:
    """{kernel id: kernel nodes} of the CUDA graph ``graph``: the launches
    of csrc/'s kernels that one replay of it makes."""
    counts: Dict[str, int] = {}
    for name in graph_functions(graph):
        kid = kernels.kernel_of(name)
        if kid is not None:
            counts[kid] = counts.get(kid, 0) + 1
    return counts


class CudaCapture:
    """How an Engine captures on its card: one side stream for every eager
    pass and capture, and one memory pool shared by all its graphs (safe
    because its replays run one at a time, in one order, on one stream)."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm(self, fn: Callable):
        """``fn()`` run eagerly on the side stream after the current
        stream's queued work, its outputs usable on the current stream."""
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        for t in tree_leaves(out):
            t.record_stream(cur)
        return out

    def capture(self, fn: Callable):
        """(the graph of ``fn``'s work, ``fn``'s outputs: the graph's
        static outputs, the launches of csrc/'s kernels that the graph
        holds), captured on the side stream into the pool."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn()
        held = graph_launches(graph.raw_cuda_graph())
        graph.instantiate()
        return graph, out, held


class Program:
    """One captured forward: ``inputs`` (static device buffers, in the
    prepared arrays' tree), ``graph``, ``outputs`` (the forward's result
    tree, written by each replay), ``launches`` ({kernel id: launches the
    graph holds}) and ``kept`` (the cached device arrays its launches point
    into, held as long as the program)."""

    def __init__(self, inputs, graph, outputs, launches: Dict[str, int]):
        self.inputs = inputs
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.kept: list = []

    @classmethod
    def capture(cls, capturer, device: torch.device, host,
                forward: Callable) -> Tuple["Program", Dict]:
        """(the program of ``forward`` on static inputs shaped as ``host``,
        the outputs of the eager pass on ``host``'s values).  ``capturer``
        runs the eager pass (``warm``) and the capture (``capture``, which
        also reads what the graph holds): a ``CudaCapture`` on the card.
        Raises if the graph's kernels are not the launches the capture
        recorded.  The span ``capture`` holds it all."""
        with spans.span("capture"):
            return cls._capture(capturer, device, host, forward)

    @classmethod
    def _capture(cls, capturer, device, host, forward):
        inputs = tree_map(lambda h: torch.empty(h.shape, dtype=h.dtype,
                                                device=device), host)
        prog = cls(inputs, None, None, {})
        prog.load(host)
        first = capturer.warm(lambda: forward(inputs))
        with kernels.recording(getattr(capturer, "stream", None),
                               kept=prog.kept) as recorded:
            prog.graph, prog.outputs, held = capturer.capture(
                lambda: forward(inputs))
        if held != recorded:
            raise RuntimeError(
                f"the captured graph holds the kernel launches {held}, the "
                f"forward made {recorded}")
        prog.launches = dict(held)
        return prog, first

    def load(self, host) -> None:
        """Queue non-blocking copies of the (pinned) host tensors of
        ``host``, a tree shaped as ``inputs``, into the static inputs."""
        src = tree_leaves(host)
        dst = tree_leaves(self.inputs)
        if [(t.shape, t.dtype) for t in src] != \
                [(t.shape, t.dtype) for t in dst]:
            raise ValueError("the arrays do not match the program's "
                             "static inputs")
        for d, s in zip(dst, src):
            d.copy_(s, non_blocking=True)

    def replay(self):
        """Replay the graph on the current stream; count the launches it
        holds.  Returns the static outputs."""
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.outputs
