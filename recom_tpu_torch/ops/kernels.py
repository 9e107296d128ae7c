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
kernel (K1, K2, X1, X2): a wrapper adds one where it launches, and nowhere
else, so a run can show that a path went through its kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int64

# library -> (source file, kernel id, C entry point, argtypes)
LIBRARIES = {
    "onehot_lookup": (
        "onehot_lookup.cu", "K1", "rt_onehot_lookup_f32",
        [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "onehot_bucketize": (
        "onehot_bucketize.cu", "K2", "rt_onehot_bucketize_f32",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "pooled_gather": (
        "pooled_gather.cu", "X1", "rt_pooled_gather_f32",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "hash_device": (
        "hash_device.cu", "X2", "rt_hash_rows",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
}

launches: Dict[str, int] = {"K1": 0, "K2": 0, "X1": 0, "X2": 0}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    src = os.path.join(CSRC_DIR, LIBRARIES[name][0])
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
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
        src = os.path.join(CSRC_DIR, LIBRARIES[n][0])
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
            _, _, fn, argtypes = LIBRARIES[name]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
            lib.rt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rt_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call library ``name``'s entry point, raise on a launch error, and
    count the launch."""
    lib = library(name)
    _, kid, fn, _ = LIBRARIES[name]
    err = getattr(lib, fn)(*args)
    if err != 0:
        msg = lib.rt_cuda_error_string(err).decode()
        raise RuntimeError(f"kernel {kid} ({fn}) launch failed: {msg} ({err})")
    launches[kid] += 1


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor (None for an absent optional input)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
