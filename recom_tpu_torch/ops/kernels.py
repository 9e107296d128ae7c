"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``recom_tpu_torch/csrc/`` is compiled by nvcc into a shared
library of its own with a plain C interface (no PyTorch headers, so a build
takes seconds), keyed by a hash of the source and the flags, into the
git-ignored ``recom_tpu_torch/build/``, and loaded with ctypes.  Nothing is
built or loaded at import time: the first launch builds what it needs, and
``build_all`` builds every library at once with one nvcc per source, all
started together.

Exactness: no ``--use_fast_math``; ``-fmad=false`` keeps every multiply and
add separately rounded (the pooling contract of ops/lookup_gather.py), and
the kernels spell the rounding out with ``__fmul_rn``/``__fadd_rn`` besides.

Every entry point returns the ``cudaError_t`` of its launch, which
``launch`` turns into an exception.  ``launches`` counts the launches of each
kernel (the forwards K1, K2, X1, X2, the stored-dtype variants K1-bf16,
K2-bf16, X1-bf16 and X1-int8, the backwards K3a, K3b, X1b, the
partition pass Part that lists their work items' entries, and the
optimizer's row-wise AdaGrad O1): a
wrapper adds one where it launches, and nowhere else, so a run can show that
a path went through its kernels.  Only launches that run on the card count:
while a CUDA graph is captured (``recording``) the launches queued on the
capturing stream run nothing and are recorded instead, the capturing
thread's and any other thread's (autograd runs a captured backward on its
own device thread); the kernel nodes of the captured graph, named by
``kernel_of``, must be those launches, and each replay of the graph adds
them (``add_launches``; runtime/graphs.py).  Every entry point takes its
stream last.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int64

# library -> its source file; a library may hold several kernels
LIBRARIES = {
    "onehot_lookup": "onehot_lookup.cu",
    "onehot_bucketize": "onehot_bucketize.cu",
    "pooled_gather": "pooled_gather.cu",
    "hash_device": "hash_device.cu",
    "onehot_grad": "onehot_grad.cu",
    "pooled_gather_grad": "pooled_gather_grad.cu",
    "partition": "partition.cu",
    "rowwise_adagrad": "rowwise_adagrad.cu",
}

# kernel id -> (library, C entry point, argtypes)
KERNELS = {
    "K1": ("onehot_lookup", "rt_onehot_lookup_f32", [_P, _I, _I, _P]),
    "K2": ("onehot_bucketize", "rt_onehot_bucketize_f32",
           [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "X1": ("pooled_gather", "rt_pooled_gather_f32", [_P, _I, _I, _P]),
    # the stored-dtype variants: bf16 rows (K1, K2, X1) and int8 rows with
    # per-row f32 scales (X1), read as stored and pooled in f32
    "K1-bf16": ("onehot_lookup", "rt_onehot_lookup_bf16", [_P, _I, _I, _P]),
    "K2-bf16": ("onehot_bucketize", "rt_onehot_bucketize_bf16",
                [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "X1-bf16": ("pooled_gather", "rt_pooled_gather_bf16", [_P, _I, _I, _P]),
    "X1-int8": ("pooled_gather", "rt_pooled_gather_int8", [_P, _I, _I, _P]),
    "X2": ("hash_device", "rt_hash_rows",
           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "K3a": ("onehot_grad", "rt_onehot_lookup_grad_f32", [_P, _I, _P]),
    "K3b": ("onehot_grad", "rt_onehot_bucketize_grad_f32", [_P, _I, _P]),
    "X1b": ("pooled_gather_grad", "rt_pooled_gather_grad_f32",
            [_P, _I, _P, _P, _I, _P]),
    # the partition pass that lists each work item's entries for X1b, K3a
    # and K3b (ops/item_lists.py)
    "Part": ("partition", "rt_partition", [_P, _I, _I, _I, _P]),
    # the optimizer: row-wise AdaGrad on a param group's leaves, writing
    # only the rows a step touched (ops/rowwise_adagrad.py)
    "O1": ("rowwise_adagrad", "rt_rowwise_adagrad_f32",
           [_P, _I, _I, ctypes.c_float, ctypes.c_float, _P, _P]),
}

launches: Dict[str, int] = {kid: 0 for kid in KERNELS}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# per thread: the capture under way, if any, as (the launches it recorded,
# the tensors those launches point into: ``launch``'s ``keep``)
_capturing = threading.local()
# CUDA stream handle -> the capture under way on that stream, for launches
# queued on it from other threads
_by_stream: Dict[int, Tuple[Dict[str, int], list]] = {}
_by_stream_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@contextlib.contextmanager
def recording(stream=None, kept: Optional[list] = None):
    """Within it, this thread's launches are recorded in the yielded dict
    ({kernel id: launches}) instead of counted: the capture of a CUDA
    graph, whose launches run only when it is replayed.  ``stream``: the
    capturing ``torch.cuda.Stream``, whose launches from other threads are
    recorded here too.  ``kept``: a list that takes the tensors each
    recorded launch names in its ``keep``, for the graph's owner to hold
    while the graph lives.  A recording within another adds what it
    recorded to the outer one when it ends."""
    rec = ({}, [] if kept is None else kept)
    outer = getattr(_capturing, "rec", None)
    _capturing.rec = rec
    key = None if stream is None else int(stream.cuda_stream)
    if key is not None:
        with _by_stream_lock:
            _by_stream[key] = rec
    try:
        yield rec[0]
    finally:
        _capturing.rec = outer
        if key is not None:
            with _by_stream_lock:
                del _by_stream[key]
        if outer is not None:
            for kid, n in rec[0].items():
                outer[0][kid] = outer[0].get(kid, 0) + n
            outer[1].extend(rec[1])


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches ``counts`` of a graph's replay."""
    for kid, n in counts.items():
        launches[kid] += n


# the __global__ functions of csrc/ by their demangled names, as a CUDA
# graph's kernel nodes and the profiler name them: (pattern, kernel id), the
# first match wins; the template arguments tell the stored dtypes (unsigned
# short / uint2: bf16 units; pooled_gather_kernel<0, 1, 2>: f32, bf16,
# int8) and K3a from K3b (onehot_grad_kernel<kBucketize, ...>) apart
_FUNCTIONS = tuple((re.compile(p), kid) for p, kid in (
    (r"\bonehot_lookup_kernel<\w+, (unsigned short|uint2),", "K1-bf16"),
    (r"\bonehot_lookup_kernel<", "K1"),
    (r"\bonehot_bucketize_kernel<\w+, (unsigned short|uint2),", "K2-bf16"),
    (r"\bonehot_bucketize_kernel<", "K2"),
    (r"\bpooled_gather_kernel<(\([^<>]*\))?0>", "X1"),
    (r"\bpooled_gather_kernel<(\([^<>]*\))?1>", "X1-bf16"),
    (r"\bpooled_gather_kernel<(\([^<>]*\))?2>", "X1-int8"),
    (r"\bhash_rows_kernel<", "X2"),
    (r"\bonehot_grad_kernel<false,", "K3a"),
    (r"\bonehot_grad_kernel<true,", "K3b"),
    (r"\bpooled_gather_grad_kernel\b", "X1b"),
    (r"\bpartition_kernel\b", "Part"),
    (r"\browwise_adagrad_kernel\b", "O1"),
))


@functools.lru_cache(maxsize=None)
def _cxa_demangle():
    fn = getattr(ctypes.CDLL("libstdc++.so.6"), "__cxa_demangle")
    fn.restype = ctypes.c_void_p
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    free = ctypes.CDLL(None).free
    free.argtypes = [ctypes.c_void_p]
    return fn, free


def demangle(name: str) -> str:
    """The C++ name of a mangled symbol (``name`` itself if it is not
    one)."""
    if not name.startswith("_Z"):
        return name
    fn, free = _cxa_demangle()
    status = ctypes.c_int(0)
    out = fn(name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not out:
        return name
    try:
        return ctypes.string_at(out).decode()
    finally:
        free(out)


def kernel_of(name: str) -> Optional[str]:
    """The kernel id whose entry point launches the device function
    ``name`` (mangled or not), or None for a function not of csrc/."""
    name = demangle(name)
    for pat, kid in _FUNCTIONS:
        if pat.search(name):
            return kid
    return None


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> str:
    """The library's path, keyed by its source, every header in csrc/ (a
    source may include any of them) and the flags."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [LIBRARIES[name]] + headers:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            key.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{key.hexdigest()[:16]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build every missing library in ``names`` (default: all), one nvcc
    process per source, all running at once.  Raises with the compiler's
    output when any build fails.  Returns {name: .so path}."""
    names = list(LIBRARIES if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs: List = []
    for n in todo:
        tmp = f"{paths[n]}.tmp{os.getpid()}"
        src = os.path.join(CSRC_DIR, LIBRARIES[n])
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )))
    failed = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{out.decode()}")
        else:
            os.replace(tmp, paths[n])   # atomic under concurrent builds
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(path)
            for lname, fn, argtypes in KERNELS.values():
                if lname == name:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            lib.rt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rt_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
    return lib


def launch(kid: str, *args, keep=()) -> None:
    """Call kernel ``kid``'s entry point (``args``, its stream last), raise
    on a launch error, and count the launch (record it, under
    ``recording`` on this thread or on its stream).  ``keep``: the tensors
    the launch points into that only a bounded cache holds (a plan made
    once per shape): a recording keeps them, so that a captured graph's
    replays never read memory the cache has since given back."""
    name, fn, _ = KERNELS[kid]
    lib = library(name)
    err = getattr(lib, fn)(*args)
    if err != 0:
        msg = lib.rt_cuda_error_string(err).decode()
        raise RuntimeError(f"kernel {kid} ({fn}) launch failed: {msg} ({err})")
    rec = getattr(_capturing, "rec", None)
    if rec is None and _by_stream:
        with _by_stream_lock:
            rec = _by_stream.get(args[-1])
            if rec is not None:
                _record(rec, kid, keep)
                return
    if rec is None:
        launches[kid] += 1
    else:
        _record(rec, kid, keep)


def _record(rec, kid: str, keep) -> None:
    counts, kept = rec
    counts[kid] = counts.get(kid, 0) + 1
    kept.extend(keep)


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor (None for an absent optional input)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
