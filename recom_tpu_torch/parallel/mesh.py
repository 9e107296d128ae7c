"""A ("data", "model") mesh of torch.distributed ranks.

The port of recom_tpu/parallel/mesh.py:47-70.  The JAX package arranges
the devices of one controller in a 2-D mesh; here each rank is one
process (SPMD: every rank builds the same objects and makes the same
calls in the same order), and rank ``r`` sits at ``(r // model, r %
model)``.  The batch is split over the "data" axis; tables whose rows are
sharded are striped over the "model" axis (parallel/sharded_lookup.py).

A ``Mesh`` holds its shape, its rank's coordinates, its device, its
backend, and one process subgroup for each data row (the ranks that
share a data index: the "model" axis's collectives) and each model
column (the "data" axis's), plus one over all of its ranks.  Its
``all_reduce``, ``all_gather`` and ``all_to_all`` run over one axis (or
all of it), skip a group of one rank, and add each call's wall time to
``timers`` under ``<collective>/<axis>``.

Backends: NCCL by default where each rank has its own card, gloo for
``device="cpu"``.  NCCL refuses two ranks on one card ("Duplicate GPU
detected"), so a world that shares one card asks for ``backend="gloo"``
itself; gloo takes CUDA tensors for the three collectives (torch 2.11 on
an H100, checked) and stages them through host memory.  Nothing switches
backend after an error.

Training takes the collectives under autograd through ``psum`` and
``all_gather`` below, each the eager method where no gradient is asked
(serving, under ``torch.inference_mode``), and the all-to-all exchange's
row return through ``all_to_all_lookup._RowsBack``.  Their backwards are
``shard_map``'s transposes for a result that every rank of the axis
holds alike: a psum's is the identity (each rank already holds the whole
cotangent: summing it again would count it ``n`` times), an all_gather's
the rank's own slice of the cotangent, an all_to_all's the reverse
all_to_all.  ``Mesh.grad_all_reduce`` sums the gradients of every leaf
over the "data" axis, never over "model".

Not ported: ``enable_async_collectives``, which sets an XLA flag for the
TPU's scheduler; NCCL's collectives are asynchronous on their stream
already.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from recom_tpu_torch.utils.logging import StageTimer


def mesh_shape(shape: Optional[Sequence[int]], world: int) -> Tuple[int, int]:
    """A 2-D shape parsed as the JAX package parses it: None means
    ``(world, 1)`` (pure data parallel), one -1 entry is inferred from the
    world size, and a shape that needs more ranks than exist raises."""
    if shape is None:
        shape = (world, 1)
    shape = [int(s) for s in shape]
    if len(shape) != 2:
        raise ValueError(f"mesh shape {shape}: expected (data, model)")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = world // known
    need = int(np.prod(shape))
    if min(shape) < 1:
        raise ValueError(f"mesh shape {shape} has an axis below 1")
    if need > world:
        raise ValueError(f"mesh shape {shape} needs {need} ranks, have "
                         f"{world}")
    return shape[0], shape[1]


def rank_device(device=None) -> torch.device:
    """The rank's device: ``device`` where the caller names one, else its
    card, ``cuda:<LOCAL_RANK>`` (``LOCAL_RANK`` as torchrun sets it; the
    global rank where it is unset).  A card that is not there raises."""
    from recom_tpu_torch.utils.device import resolve_device

    if device is not None:
        dev = resolve_device(device)
    else:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = resolve_device(f"cuda:{local}")
    if dev.type == "cuda":
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        if idx >= torch.cuda.device_count():
            raise RuntimeError(f"{dev}: this host has "
                               f"{torch.cuda.device_count()} CUDA devices")
        dev = torch.device("cuda", idx)
    return dev


class Mesh:
    """See the module docstring.  ``shape``: {axis name: size};
    ``coords``: this rank's (data index, model index); ``groups``: {axis
    name: this rank's subgroup along it, None: the mesh's ranks}."""

    def __init__(self, shape: Tuple[int, int], axis_names: Tuple[str, str],
                 device: torch.device, backend: str):
        d, m = shape
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {axis_names[0]: d, axis_names[1]: m}
        self.size = d * m
        self.rank = dist.get_rank()
        self.device = device
        self.backend = backend
        self.timers = StageTimer()
        # dist.new_group is collective over the default group: every rank
        # creates every subgroup, in this order, even those it is not in
        rows = [dist.new_group([r * m + k for k in range(m)], backend=backend)
                for r in range(d)]
        cols = [dist.new_group([r * m + k for r in range(d)], backend=backend)
                for k in range(m)]
        whole = dist.new_group(list(range(d * m)), backend=backend)
        if self.rank >= d * m:
            raise ValueError(f"rank {self.rank} is outside the {d}x{m} mesh; "
                             "only ranks below its size take part")
        self.coords = (self.rank // m, self.rank % m)
        self.groups = {axis_names[1]: rows[self.coords[0]],
                       axis_names[0]: cols[self.coords[1]], None: whole}

    def axis_size(self, axis: Optional[str]) -> int:
        return self.size if axis is None else self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (jax.lax.axis_index)."""
        return self.coords[self.axis_names.index(axis)]

    def _timed(self, name: str, axis, fn):
        t0 = time.perf_counter()
        out = fn()
        self.timers.add(f"{name}/{axis or 'world'}", time.perf_counter() - t0)
        return out

    def all_reduce(self, x: torch.Tensor,
                   axis: Optional[str]) -> torch.Tensor:
        """The sum of ``x`` over ``axis``'s ranks (None: every rank), in
        place (jax.lax.psum)."""
        if self.axis_size(axis) > 1:
            self._timed("all_reduce", axis, lambda: dist.all_reduce(
                x, group=self.groups[axis]))
        return x

    def all_gather(self, x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        """``[n, *x.shape]``: every rank's ``x`` (at least 1-d) along
        ``axis``, by index."""
        n = self.axis_size(axis)
        if n == 1:
            return x[None]
        x = x.contiguous()
        # gloo takes the output as the pieces concatenated on axis 0
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        self._timed("all_gather", axis, lambda: _all_gather_single(
            out, x, group=self.groups[axis]))
        return out.view((n,) + tuple(x.shape))

    def all_to_all(self, x: torch.Tensor, axis: str,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x`` is ``[n, ...]``: slice j goes to the rank at index j along
        ``axis``, and slice j of the result (``out``, contiguous, where
        given) came from it (jax.lax.all_to_all with split and concat axis
        0, tiled)."""
        n = self.axis_size(axis)
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {axis!r} takes [{n}, ...], "
                             f"got {tuple(x.shape)}")
        if n == 1:
            return x if out is None else out.copy_(x)
        x = x.contiguous()
        out = torch.empty_like(x) if out is None else out
        self._timed("all_to_all", axis, lambda: dist.all_to_all_single(
            out, x, group=self.groups[axis]))
        return out

    def barrier(self) -> None:
        """Wait until every rank of the mesh is here."""
        dist.barrier(group=self.groups[None])

    def grad_all_reduce(self, tensors: Sequence[torch.Tensor],
                        axis: str = "data") -> None:
        """Sum each of ``tensors`` (the leaves' gradients, in the params
        tree's fixed order) over ``axis``'s ranks, in place: one flat
        all_reduce of the consecutive tensors that fit ``GRAD_BUCKET_BYTES``
        together, and a tensor larger than that alone, in its own storage
        (model E's 2^23-row stripe: no second copy of its 2.68 GB).  Nothing
        runs where the axis has one rank."""
        if self.axis_size(axis) == 1:
            return
        bucket: list = []
        size = 0

        def flush():
            if not bucket:
                return
            flat = torch.cat([t.reshape(-1) for t in bucket])
            self.all_reduce(flat, axis)
            at = 0
            for t in bucket:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()
            bucket.clear()

        for t in tensors:
            nbytes = t.numel() * t.element_size()
            if nbytes > GRAD_BUCKET_BYTES and t.is_contiguous():
                flush()
                size = 0
                self.all_reduce(t, axis)
                continue
            if size + nbytes > GRAD_BUCKET_BYTES:
                flush()
                size = 0
            bucket.append(t)
            size += nbytes
        flush()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device}, {self.backend})")


# the largest flat buffer Mesh.grad_all_reduce packs gradients into
GRAD_BUCKET_BYTES = 256 << 20


def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.index = mesh.axis_index(axis)
        return mesh.all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None


def psum(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` summed over ``axis``'s ranks, a result every rank of the axis
    holds alike (``jax.lax.psum`` under ``shard_map``).  Under autograd a
    new tensor whose backward is the identity; otherwise ``Mesh.all_reduce``
    in place."""
    if _wants_grad(x):
        return _Psum.apply(x, mesh, axis)
    return mesh.all_reduce(x, axis)


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``Mesh.all_gather`` over a named axis; under autograd its backward
    is the rank's own slice of the cotangent (the result is the same on
    every rank of the axis, and so is its cotangent)."""
    if _wants_grad(x):
        return _AllGather.apply(x, mesh, axis)
    return mesh.all_gather(x, axis)


# torch 2.13 names all_gather_into_tensor all_gather_single
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)


def default_backend(device: torch.device) -> str:
    """NCCL for ranks on cards, gloo for ranks on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
    backend: Optional[str] = None,
    device=None,
) -> Mesh:
    """A 2-D ("data", "model") mesh over the initialised default process
    group.  ``shape=None`` is ``(world, 1)``, pure data parallel; a -1
    entry is inferred.  ``device``: the rank's device (default its card,
    ``rank_device``); ``backend``: the subgroups' (default
    ``default_backend(device)``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's default "
                           "process group (parallel.multihost.init)")
    dev = rank_device(device)
    return Mesh(mesh_shape(shape, dist.get_world_size()), tuple(axis_names),
                dev, backend or default_backend(dev))
