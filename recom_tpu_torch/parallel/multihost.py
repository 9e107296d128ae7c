"""Multi-process execution: the process group, a mesh over every rank,
placing a host array, and fetching a result.

The port of recom_tpu/parallel/multihost.py:33-89.  In the JAX package a
process drives all of its host's devices; here every device is one rank
(one process), so a "host" is the ranks that share one
``LOCAL_WORLD_SIZE``:

  * init(): ``torch.distributed.init_process_group``, a no-op once a
    default group exists
  * global_mesh(): a ("data", "model") mesh over every rank
  * from_global(): a rank materialises only its stripe, its column slice
    or its copy of a host array: pass ``np.load(..., mmap_mode="r")`` and
    only those rows are paged in, so a table never exists whole in one
    rank's memory
  * gather_to_host(): every rank's piece of a result, on every rank
  * init_from_env() and spawn(): a world from torchrun's environment, or
    ``n`` local ranks started by ``spawn`` (the tools' ``--spawn N``),
    which meet through a ``FileStore`` in a fresh temporary directory, so
    that worlds started at once never race for a port
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from recom_tpu_torch.parallel.mesh import Mesh, make_mesh
from recom_tpu_torch.parallel.sharded_lookup import (
    member_stripe,
    stripe_rows_of,
)


def init(coordinator: str, num_processes: int, process_id: int,
         backend: Optional[str] = None) -> None:
    """Join the default process group: ``coordinator`` is ``host:port``
    (or any ``init_method`` URL, such as ``file:///path``), rank
    ``process_id`` of ``num_processes``.  ``backend`` defaults to NCCL
    where CUDA is available, else gloo.  A second call, once a group
    exists, is a no-op (recom_tpu/parallel/multihost.py:33-50)."""
    if dist.is_initialized():
        return
    if "://" not in coordinator:
        coordinator = "tcp://" + coordinator
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)


# the environment variable through which ``spawn`` hands its ranks the
# store they meet at (a ``file://`` init method)
SPAWN_INIT = "RECOM_TORCH_INIT_METHOD"


def init_from_env(backend: Optional[str] = None) -> None:
    """Join the default process group from the environment: a rank that
    ``spawn`` started meets its world at the store it was given
    (``RECOM_TORCH_INIT_METHOD``); otherwise torchrun's ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.  A no-op once a
    group exists.  Raises where the environment names no world."""
    if dist.is_initialized():
        return
    if SPAWN_INIT in os.environ:
        init(os.environ[SPAWN_INIT], int(os.environ["WORLD_SIZE"]),
             int(os.environ["RANK"]), backend)
        return
    need = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    missing = [k for k in need if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"no torch.distributed world: {', '.join(missing)} unset (run "
            "under torchrun --nproc-per-node N, or pass --spawn N)")
    init(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
         int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), backend)


def spawn(argv: Sequence[str], n: int, timeout_s: float = 1200.0):
    """Run ``python argv...`` as ``n`` local ranks (``RANK``,
    ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE`` as torchrun sets
    them), and wait for them: [(return code, output)] in rank order.  The
    ranks meet through a ``FileStore`` in a temporary directory of this
    call's own (``RECOM_TORCH_INIT_METHOD``, read by ``init_from_env``):
    no port is picked, freed and bound again, so worlds spawned at once
    cannot take each other's.  A rank that has not ended when the first
    failure is seen, or at the time limit, is killed; the directory is
    removed."""
    import subprocess
    import sys
    import threading
    import time

    where = tempfile.mkdtemp(prefix="recom_torch_world_")
    store = "file://" + os.path.join(where, "store")
    procs = []
    outs = [None] * n
    threads = []
    try:
        for r in range(n):
            env = {k: v for k, v in os.environ.items()
                   if k not in ("MASTER_ADDR", "MASTER_PORT")}
            env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_WORLD_SIZE=str(n), **{SPAWN_INIT: store})
            procs.append(subprocess.Popen(
                [sys.executable] + list(argv), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s

        def drain(i):
            outs[i] = procs[i].communicate()[0].decode(errors="replace")

        threads = [threading.Thread(target=drain, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in threads:
            t.join(timeout=30)
        shutil.rmtree(where, ignore_errors=True)
    return [(p.returncode, o or "") for p, o in zip(procs, outs)]


def spawn_self(module: str, argv: Sequence[str], device=None) -> str:
    """A tool's ``--spawn N``: run ``python -m module`` with ``argv`` less
    its ``--spawn N``, plus ``--backend gloo`` and ``--device`` (default
    ``cuda:0``: ranks that share one card), as N local ranks
    (``spawn``).  Returns rank 0's output; a rank that fails raises
    SystemExit with the end of its output."""
    argv = list(argv)
    i = argv.index("--spawn")
    n = int(argv[i + 1])
    rest = argv[:i] + argv[i + 2:] + ["--backend", "gloo"]
    if device is None:
        rest += ["--device", "cuda:0"]
    res = spawn(["-m", module] + rest, n)
    for r, (rc, text) in enumerate(res):
        if rc != 0:
            raise SystemExit(f"rank {r} failed (exit {rc}):\n{text[-4000:]}")
    return res[0][1]


def global_mesh(axis_names: Tuple[str, str] = ("data", "model"),
                data_parallel_hosts: bool = False, backend=None,
                device=None) -> Mesh:
    """A mesh over every rank.  ``data_parallel_hosts=False`` (default)
    puts the model axis across every rank, so table stripes and the lookup
    exchange cross hosts; True puts the data axis across hosts and the
    model axis over each host's ``LOCAL_WORLD_SIZE`` ranks."""
    world = dist.get_world_size()
    if data_parallel_hosts:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        return make_mesh((world // local, local), axis_names, backend, device)
    return make_mesh((1, world), axis_names, backend, device)


def from_global(mesh: Mesh, layout: str, array) -> torch.Tensor:
    """This rank's part of a host array, on its device.

    ``layout``: ``"replicated"`` (the whole array), ``"striped"`` (rows
    ``k, k + m, ...`` of an ``[R, ...]`` array for model rank ``k`` of
    ``m``, padded with zero rows to ``ceil(R / m)``: ``stripe_rows``'s
    block ``k``) or ``"columns"`` (columns ``[k d/m, (k+1) d/m)`` of an
    ``[R, d]`` array).  ``array`` is anything numpy can slice, such as an
    ``np.load(..., mmap_mode="r")`` array, whose other rows are never
    read."""
    model = mesh.axis_names[1]
    m, k = mesh.shape[model], mesh.axis_index(model)
    if layout == "replicated":
        part = array[:]
    elif layout == "striped":
        first, count, start = member_stripe(array.shape[0], 0, m, k)
        part = np.zeros((stripe_rows_of(array.shape[0], m),)
                        + tuple(array.shape[1:]), array.dtype)
        part[start:start + count] = array[first::m]
    elif layout == "columns":
        d = array.shape[1]
        if d % m:
            raise ValueError(f"{d} columns do not split over {m} ranks")
        part = array[:, k * (d // m):(k + 1) * (d // m)]
    else:
        raise ValueError(f"layout {layout!r}: expected 'replicated', "
                         "'striped' or 'columns'")
    return torch.from_numpy(np.ascontiguousarray(part)).to(mesh.device)


def gather_to_host(x: torch.Tensor, mesh: Optional[Mesh] = None,
                   axis: Optional[str] = None) -> np.ndarray:
    """Every rank's ``x`` (along ``axis`` of ``mesh``; by default every
    rank of the default group) concatenated on axis 0, as numpy, on every
    rank."""
    if mesh is not None:
        return mesh.all_gather(x, axis).flatten(0, 1).cpu().numpy()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts).cpu().numpy()
