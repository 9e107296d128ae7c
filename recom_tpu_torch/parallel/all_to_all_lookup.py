"""All-to-all id-exchange lookup of a row-striped group.

The port of recom_tpu/parallel/all_to_all_lookup.py:118-262, the second
way to look up a striped group (the first, the psum path, is in
sharded_lookup.py):

  each model rank takes its 1/m slice of its data shard's batch rows
    -> routes each id to the model rank that owns its row: one stable
       sort by an owner-major key serves the routing and the dedup; each
       destination takes at most ``cap`` distinct ids, the rest overflow
    -> all_to_all over the model subgroup: ids out             [small]
    -> each owner gathers the rows asked of its stripe, as f32
       (``gather_rows_f32``: bf16 upcast, int8 dequantized, one rounding)
    -> all_to_all back: the rows return, in ``chunks`` capacity slices,
       each written into its own slice of one receive buffer
    -> X1 pools the returned rows in the bags' entry order (the buffer as
       the table, row offsets 0), bit for bit the single-device pooling
    -> all_gather over the model subgroup rebuilds the data shard's batch

Under autograd (training, recom_tpu/parallel/all_to_all_lookup.py:118-246
under ``jax.grad``) each step has its transpose: the all_gather's is the
rank's own slice; X1's pool into the receive buffer backs through X1b
with the buffer as the table (its columns share the buffer's rows, so
``groups_pooled_grad`` takes them as one column; the zero row's
cotangent is dropped); the chunked return is undone chunk by chunk by
the reverse all_to_all (``_RowsBack``); the owner's gather backs through
X1b into the stripe (``_OwnerGather``), never through ``index_add_`` or
``table[idx]``'s autograd.

Which entries overflow depends only on the sorted keys, so the overflow
count equals the JAX package's on the same batch.  An overflowed entry
pools as a zero row that still counts in its bag's MEAN / SQRTN divisor,
as the JAX path's fill-zeros do (all_to_all_lookup.py:205, :234, :239-246):
it points at one zero row appended to the receive buffer, not at -1 (X1
leaves a -1 slot out of the divisor).  Pad slots stay -1.

JAX's ``.at[...].set(mode="drop")`` scatters are written as explicit masks:
a torch scatter does not drop an index that is out of range.  The chunks
write disjoint slices and nothing is summed, so the JAX path's -0.0 ->
+0.0 of its chunk sums does not occur here (ROADMAP Queue 3); compare
with ``==``, which holds -0.0 and +0.0 equal.

``a2a_capacity`` is copied from recom_tpu/parallel/all_to_all_lookup.py:
47-52.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from recom_tpu_torch.ops.item_lists import StepLists
from recom_tpu_torch.ops.lookup_gather import (
    as_device,
    gather_rows_f32,
    group_pooled,
    groups_pooled_grad,
    shared_rows_consts,
    x1b_forward_entry,
)
from recom_tpu_torch.ops.quant import QuantizedTable
from recom_tpu_torch.parallel.mesh import all_gather


# Copied from recom_tpu/parallel/all_to_all_lookup.py:47-52.
def a2a_capacity(n_ids: int, m: int, factor: float = 2.0) -> int:
    """Static per-destination bucket capacity, padded to a multiple of 8
    (sublane alignment).  factor >= m gives a provably-lossless capacity."""
    cap = int(np.ceil(n_ids / m * factor))
    cap = min(cap, n_ids)            # never more than every id to one dest
    return max(8, ((cap + 7) // 8) * 8)


def a2a_chunks(cap: int, chunks: int) -> int:
    """The largest chunk count <= ``chunks`` that divides ``cap``: chunking
    never changes the capacity, which is part of the overflow contract
    (all_to_all_lookup.py:105-111)."""
    chunks = max(1, int(chunks))
    while chunks > 1 and cap % chunks:
        chunks -= 1
    return chunks


def table_rows(table) -> int:
    """The stored rows of an ``[R, d]`` table or a ``QuantizedTable``."""
    return (table.q if isinstance(table, QuantizedTable) else table).shape[0]


def _dim_of(table) -> int:
    return (table.q if isinstance(table, QuantizedTable) else table).shape[1]


def a2a_route(ids: torch.Tensor, row_offsets, shard_rows: int, m: int,
              k: int, capacity_factor: float = 2.0, dedup: bool = True,
              vocab_caps=None) -> Dict[str, torch.Tensor]:
    """The routing of model rank ``k``'s slice of its data shard's batch.

    ids: [C, b_loc, L] int32 of the data shard (b_loc % m == 0), clamped
    to ``vocab_caps`` first.  Returns ``send`` [m, cap] int32 (the local
    stripe rows asked of each owner, -1 in unused slots), ``pos`` [C, b_my,
    L] int64 (each valid entry's row in the receive buffer, ``m * cap`` =
    the zero row for an overflowed one; -1 for a pad), ``valid`` [C, b_my,
    L], ``overflow`` (the entries whose row is not exchanged, a 0-d int64),
    and ``cap``.  The flat order is JAX's ([b_my, C, L], batch-major), so
    the stable sort breaks ties as it does."""
    dev = ids.device
    if vocab_caps is not None:
        ids = torch.minimum(
            ids, as_device(vocab_caps, torch.int32, dev)[:, None, None])
    c, b_loc, l = ids.shape
    if b_loc % m:
        raise ValueError(f"local batch {b_loc} not divisible by model axis "
                         f"{m}")
    b_my = b_loc // m
    n = b_my * c * l
    cap = a2a_capacity(n, m, capacity_factor)
    my = ids[:, k * b_my:(k + 1) * b_my].permute(1, 0, 2)     # [b_my, C, L]
    valid = my >= 0
    offs = as_device(row_offsets, torch.int64, dev)[None, :, None]
    flat = (torch.where(valid, my, torch.zeros_like(my)).long()
            + offs).reshape(n)
    fvalid = valid.reshape(n)
    # owner-major key: sorted, it groups by owner and puts duplicate rows
    # side by side; pads sort past every owner and take no capacity
    sentinel = m * shard_rows
    okey = torch.where(fvalid, (flat % m) * shard_rows + flat // m,
                       torch.full_like(flat, sentinel))
    sk, order = torch.sort(okey, stable=True)
    real = sk < sentinel
    if dedup:
        first = torch.ones_like(real)
        first[1:] = sk[1:] != sk[:-1]
        is_first = real & first
    else:
        is_first = real
    seg = torch.cumsum(is_first.long(), 0) - 1           # unique index
    seg0 = seg.clamp(min=0)
    so = torch.where(real, sk // shard_rows, torch.full_like(sk, m))
    counts = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, so, is_first.long())             # uniques per owner
    ustarts = torch.cumsum(counts, 0) - counts
    urank = seg - ustarts[so]                            # rank in its owner
    ok_u = is_first & (urank < cap)
    # JAX's drop-mode scatters: an entry that must not land writes one
    # dump slot past the end instead, which is cut off (no host sync, as a
    # boolean-mask index would need)
    at_seg = torch.where(ok_u, seg, torch.full_like(seg, n))
    rep_ok = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    rep_ok.index_fill_(0, at_seg, True)       # a scalar: no host copy
    entry_ok = real & rep_ok[:n][seg0]
    overflow = (real & ~entry_ok).sum()
    lin_u = so * cap + urank                          # owner * cap + rank
    send = torch.full((m * cap + 1,), -1, dtype=torch.int32, device=dev)
    send[torch.where(ok_u, lin_u, torch.full_like(lin_u, m * cap))] = (
        sk % shard_rows).to(torch.int32)
    send = send[:m * cap].view(m, cap)
    # each unique's slot, read through its segment
    slot = torch.full((n + 1,), m * cap, dtype=torch.int64, device=dev)
    slot[at_seg] = lin_u
    lin_sorted = torch.where(entry_ok, slot[:n][seg0],
                             torch.full_like(seg, m * cap))
    lin = torch.empty_like(lin_sorted)
    lin[order] = lin_sorted
    pos = torch.where(fvalid, lin, torch.full_like(lin, -1))
    pos = pos.reshape(b_my, c, l).permute(1, 0, 2).contiguous()
    return {"send": send, "pos": pos, "valid": valid.permute(1, 0, 2),
            "overflow": overflow, "cap": cap}


def chunked_positions(pos: torch.Tensor, m: int, cap: int,
                      chunks: int) -> torch.Tensor:
    """Receive-buffer rows of ``pos`` when the rows return in ``chunks``
    capacity slices of ``capc = cap / chunks``: chunk ``ck`` lands as
    ``[m, capc, d]`` at buffer row ``ck * m * capc``, so slot ``so * cap +
    r`` is row ``(r // capc) * m * capc + so * capc + r % capc``.  The
    zero row ``m * cap`` and the pads (-1) stay."""
    if chunks == 1:
        return pos
    capc = cap // chunks
    so, r = pos // cap, pos % cap
    moved = (r // capc) * (m * capc) + so * capc + r % capc
    return torch.where((pos >= 0) & (pos < m * cap), moved, pos)


def owner_rows(table, recv: torch.Tensor) -> torch.Tensor:
    """The rows ``recv`` [n] int32 asks of the owner's stripe, ``[n, d]``
    f32; a slot no id filled (-1) reads row 0, as JAX's zero-filled
    ``send_ids`` ask for it (all_to_all_lookup.py:170-174), and its row is
    never read."""
    return gather_rows_f32(table, recv.clamp(min=0).long())


class _OwnerGather(torch.autograd.Function):
    """The owner's gather (``owner_rows``).  Backward: X1b scatters the
    rows' cotangents into the stripe, the received ids taken as one SUM
    column of L = 1 over ``n`` batch rows (``group_pooled_grad``): one
    member of sparse ranges, each reading only the slots that land in it
    (the partition pass lists them, ops/item_lists.py; in the step's one
    launch where ``lists``, an ``item_lists.StepLists``, is given, else in
    its own), so each row's terms add in slot order (the stable sort of
    csrc/ordered_runs.cuh), with no float atomics.  The unfilled slots (-1) add nothing: JAX adds
    their +0.0 cotangents to row 0, and X1b, whose sums start at +0.0,
    gives the same bits either way, without summing tens of thousands of
    zero terms into one row."""

    @staticmethod
    def forward(ctx, table, recv, lists):
        ctx.save_for_backward(recv)
        ctx.rows = table.shape[0]
        ctx.lists = StepLists() if lists is None else lists
        zero, no_cap, _ = shared_rows_consts(1, str(recv.device))
        ctx.key = ctx.lists.add(x1b_forward_entry(
            table.shape[0], table.shape[1], recv.view(1, -1, 1), zero,
            no_cap))
        return owner_rows(table, recv)

    @staticmethod
    def backward(ctx, g):
        (recv,) = ctx.saved_tensors
        zero, no_cap, flags = shared_rows_consts(1, str(g.device))
        args = (g.contiguous()[:, None, :], ctx.rows, recv.view(1, -1, 1),
                zero, zero, None, flags, no_cap)
        return groups_pooled_grad([args], lists=[
            ctx.lists.get(ctx.key)])[0], None, None


class _RowsBack(torch.autograd.Function):
    """The rows' return: ``rows`` [m, cap, d] sent back in ``chunks``
    capacity slices, each received into its own slice of the receive
    buffer ``[m * cap + 1, d]``, whose last row is zero (the overflowed
    entries').  Backward: the buffer's cotangent undone chunk by chunk
    (the inverse of ``chunked_positions``: chunk ``ck`` is the buffer's
    rows ``[ck m capc, (ck + 1) m capc)``), each slice sent back by the
    reverse all_to_all; the zero row's cotangent is dropped."""

    @staticmethod
    def forward(ctx, rows, mesh, axis, chunks):
        m, cap, d = rows.shape
        capc = cap // chunks
        ctx.mesh, ctx.axis, ctx.chunks = mesh, axis, chunks
        buf = rows.new_empty((m * cap + 1, d))
        buf[m * cap] = 0.0
        for ck in range(chunks):
            part = rows[:, ck * capc:(ck + 1) * capc]
            view = buf[ck * m * capc:(ck + 1) * m * capc].view(m, capc, d)
            mesh.all_to_all(part, axis, out=view)
        return buf

    @staticmethod
    def backward(ctx, g):
        mesh, axis, chunks = ctx.mesh, ctx.axis, ctx.chunks
        m = mesh.shape[axis]
        d = g.shape[1]
        cap = (g.shape[0] - 1) // m
        capc = cap // chunks
        g = g.contiguous()
        out = g.new_empty((m, cap, d))
        for ck in range(chunks):
            part = g[ck * m * capc:(ck + 1) * m * capc].view(m, capc, d)
            out[:, ck * capc:(ck + 1) * capc] = mesh.all_to_all(part, axis)
        return out, None, None, None


def a2a_exchange(mesh, table, route: Dict[str, torch.Tensor],
                 chunks: int = 1, model_axis: str = "model",
                 lists=None) -> torch.Tensor:
    """The two exchanges of a routed batch: the ids out, the owners' rows
    (f32) back.  Returns the receive buffer ``[m * cap + 1, d]`` f32, its
    last row zero, laid out as ``chunked_positions`` says.  Differentiable
    in an f32 ``table`` that requires grad (``_OwnerGather``,
    ``_RowsBack``; ``lists``: an ``item_lists.StepLists`` that takes the
    owner's scatter's entry, or None)."""
    m = mesh.shape[model_axis]
    cap = route["cap"]
    d = _dim_of(table)
    recv = mesh.all_to_all(route["send"], model_axis)            # [m, cap]
    chunks = a2a_chunks(cap, chunks)
    if isinstance(table, torch.Tensor) and table.requires_grad and \
            torch.is_grad_enabled():
        rows = _OwnerGather.apply(table, recv.reshape(-1), lists)
    else:
        rows = owner_rows(table, recv.reshape(-1))
    return _RowsBack.apply(rows.reshape(m, cap, d), mesh, model_axis, chunks)


def pool_args(buf: torch.Tensor, route: Dict[str, torch.Tensor], m: int,
              chunks: int, combiner_code,
              weights: Optional[torch.Tensor] = None, weighted_cols=None,
              k: int = 0):
    """``group_pooled`` arguments that pool the returned rows in entry
    order: the buffer as the table, the entries' buffer rows as ids (row
    offsets 0, no clamp, made on the device), the rank's slice of the
    weights."""
    cap = route["cap"]
    pos = chunked_positions(route["pos"], m, cap, a2a_chunks(cap, chunks))
    c, b_my, _ = pos.shape
    w = None
    if weights is not None:
        w = weights[:, k * b_my:(k + 1) * b_my].contiguous()
    zeros, no_cap, _ = shared_rows_consts(c, str(pos.device))
    return (buf, pos.to(torch.int32), zeros, combiner_code, w, weighted_cols,
            no_cap)


def all_to_all_group_pooled(
    mesh,
    table,                       # this rank's stripe [R_pad / m, d]
    ids: torch.Tensor,           # [C, b_loc, L] int32 of the data shard
    row_offsets,                 # [C]
    combiner_code,               # [C]
    weights: Optional[torch.Tensor] = None,    # [C, b_loc, L] f32
    capacity_factor: float = 2.0,
    dedup: bool = True,
    weighted_cols=None,
    vocab_caps=None,
    model_axis: str = "model",
    chunks: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled [b_loc, C, d] f32 of the rank's data shard, the same on every
    model rank; the overflow count summed over every rank of the mesh).
    The batch of each data shard must divide by the model axis.  Bit for
    bit the single-device pooling while nothing overflows; see the module
    docstring for what an overflow gives."""
    m = mesh.shape[model_axis]
    k = mesh.axis_index(model_axis)
    route = a2a_route(ids, row_offsets, table_rows(table), m, k,
                      capacity_factor, dedup, vocab_caps)
    buf = a2a_exchange(mesh, table, route, chunks, model_axis)
    mine = group_pooled(*pool_args(buf, route, m, chunks, combiner_code,
                                   weights, weighted_cols, k))
    pooled = all_gather(mesh, mine, model_axis)
    overflow = mesh.all_reduce(route["overflow"].reshape(1), None)[0]
    return pooled.reshape((-1,) + tuple(mine.shape[1:])), overflow
