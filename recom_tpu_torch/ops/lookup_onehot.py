"""K1: one-id lookup of a uniform-vocab column group (the port of
recom_tpu/ops/lookup_pallas.py's forward: ``_kernel`` through
``_onehot_lookup_impl``/``onehot_lookup``, wrapped by
``group_pooled_onehot``), and K2: the same lookup fused with the bucketize
of raw floats (the port of ``_bz_kernel`` through
``_onehot_bucketize_impl``/``onehot_bucketize_lookup``, with its interval
arrays from ``bucket_bounds``).

Stored dtypes: table3 is f32 or bf16 (``EngineConfig(table_dtype=
"bfloat16")``); a bf16 row is upcast exactly as it is read (the reference's
per-tile upcast, lookup_pallas.py:49-53 and :128-129), so the output is f32
and K1-bf16 and K2-bf16 copy each stored value's bits as K1 and K2 do.

The TPU kernel one-hot-multiplies vocab tiles on the MXU.  On Hopper the
same function is a row gather: the group's ``[C_pad, V_pad, d]`` table
(model E: 3.8 MB) sits in L2 and the kernel is bound by writing its
``[Bp, C, d]`` output (csrc/onehot_lookup.cu says how it is built).

Layout: ids arrive in the host's column-major ``[C, Bp]`` form and the
result leaves batch-major ``[Bp, C, d]``, so the reference's pad, its two
transposes and its one-id combiner fold into the one launch, as does the
serving clamp to each member's ``vocab_caps``.

K2 takes raw ``[C, Bp]`` f32 values instead of ids: bucket v of column c is
the interval ``lo[c, v] <= x < hi[c, v]``, and NaN and +inf select bucket
``counts[c]``.  On Hopper that is a binary search and the same row copy
(csrc/onehot_bucketize.cu); its result leaves batch-major ``[Bp, C, d]``
too, which folds in the reference's ``rows[:num_columns]`` slice and
transpose.

Gradients (training): both lookups are differentiable in ``table3``.  K3a
(``onehot_lookup_grad``, the port of ``onehot_lookup._bwd``) scatter-adds
the ``[Bp, C, d]`` cotangent into ``[C_pad, V_pad, d]``: per column, in
batch order, at the clamped ids, missing ids dropped.  The JAX package
clamps ids before its kernel (recom_tpu/runtime/executor.py:503-505); K1
fuses the clamp, so K3a clamps too and an id past its cap adds to the cap's
row.  K3b (``onehot_bucketize_lookup_grad``, the port of
``onehot_bucketize_lookup._bwd``) finds each raw value's bucket again with
K2's own search (csrc/bucket_search.cuh) and scatters the same way; raw
values get no gradient.  Both kernels sum each row in batch order without
float atomics (csrc/onehot_grad.cu), so they are repeatable bit for bit
and equal their plain versions.  One launch of K3a serves every one-hot
group of a backward (``onehot_lookups``, whose backward collects them);
a group whose vocab is cut into several tiles first has each column's
entries listed by tile (the partition pass Part, ops/item_lists.py), so
each tile reads only the batch rows that select it.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import List

import numpy as np
import torch

from recom_tpu_torch.ops import item_lists, kernels


# the kernel of each stored dtype of table3; the output is f32 in both
K1_KERNEL = {torch.float32: "K1", torch.bfloat16: "K1-bf16"}
K2_KERNEL = {torch.float32: "K2", torch.bfloat16: "K2-bf16"}


def _check_table3(table3):
    if table3.dtype not in K1_KERNEL or table3.dim() != 3:
        raise ValueError(f"table3 must be f32 or bf16 [C_pad, V_pad, d], "
                         f"got {table3.dtype} {tuple(table3.shape)}")


def _check(table3, ids, caps):
    _check_table3(table3)
    if ids.dtype != torch.int32 or ids.dim() != 2:
        raise ValueError(f"ids must be int32 [C, Bp], got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    c = ids.shape[0]
    if c > table3.shape[0]:
        raise ValueError(f"{c} id columns for a {table3.shape[0]}-plane table")
    if caps.dtype != torch.int32 or tuple(caps.shape) != (c,):
        raise ValueError(f"caps must be int32 [{c}], got {caps.dtype} "
                         f"{tuple(caps.shape)}")
    if int(table3.shape[1]) < 1:
        raise ValueError("table3 has no vocab rows")
    for name, t in (("table3", table3), ("ids", ids), ("caps", caps)):
        if t.device != table3.device:
            raise ValueError(f"{name} on {t.device}, table3 on {table3.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def onehot_lookup_plain(table3: torch.Tensor, ids: torch.Tensor,
                        caps: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K1: same function, torch ops (a bf16
    table's rows upcast after the gather)."""
    c = ids.shape[0]
    ids = torch.minimum(ids, caps[:, None])
    valid = ids >= 0
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    cols = torch.arange(c, device=ids.device)[:, None]
    rows = table3[cols, safe].float()                      # [C, Bp, d]
    rows = torch.where(valid[:, :, None], rows, torch.zeros_like(rows))
    return rows.transpose(0, 1).contiguous()               # [Bp, C, d]


def onehot_lookup(table3: torch.Tensor, ids: torch.Tensor,
                  caps: torch.Tensor) -> torch.Tensor:
    """rows [Bp, C, d] f32: ``table3[c, min(ids[c, b], caps[c])]`` for ids
    >= 0, else 0.

    table3: [C_pad, V_pad, d] f32 or bf16 (zero-padded planes; bf16 rows
    are upcast, exactly, as they are read); ids: [C, Bp] int32 local ids,
    < 0 = missing; caps: [C] int32 last valid row per column.  CPU tensors
    take the plain version; CUDA tensors launch kernel K1 (K1-bf16 for a
    bf16 table3).  Differentiable in an f32 table3 (backward:
    ``onehot_lookup_grad``)."""
    return onehot_lookups([(table3, ids, caps)])[0]


def onehot_lookups(groups) -> List[torch.Tensor]:
    """``onehot_lookup`` of several groups, one (table3, ids, caps) each:
    one launch of K1 a group, and, under autograd, one launch of K3a for
    every group whose table3 needs a gradient (``onehot_lookups_grad``)."""
    groups = [tuple(g) for g in groups]
    for g in groups:
        _check(*g)
    if torch.is_grad_enabled() and any(t.requires_grad for t, _, _ in groups):
        return list(_OnehotLookups.apply(groups, *(t for t, _, _ in groups)))
    return [_onehot_lookup(*g) for g in groups]


def _onehot_lookup(table3, ids, caps):
    if table3.device.type == "cpu":
        return onehot_lookup_plain(table3, ids, caps)
    if table3.device.type != "cuda":
        raise ValueError(f"unsupported device {table3.device}")
    c, bp = ids.shape
    v, d = table3.shape[1], table3.shape[2]
    out = torch.empty((bp, c, d), dtype=torch.float32, device=table3.device)
    kernels.launch(
        K1_KERNEL[table3.dtype],
        kernels.ptr(table3), kernels.ptr(ids), kernels.ptr(caps),
        kernels.ptr(out), c, bp, v, d, kernels.stream_of(table3),
    )
    return out


# ---------------------------------------------------------------------------
# K2: fused bucketize + one-id lookup
# ---------------------------------------------------------------------------


def bucket_bounds(
    boundary_matrix: np.ndarray,   # [C, Kmax] f32, +inf padded
    boundary_counts: np.ndarray,   # [C] int32
    v_pad: int,
    c_pad: int,
):
    """(lo, hi, counts) arrays for onehot_bucketize_lookup.  Bucket v of
    column c spans [bounds[v-1], bounds[v]) with -inf/+inf sentinels;
    vocab slots beyond count+1 and padded columns get empty intervals.
    (Copied from recom_tpu/ops/lookup_pallas.py::bucket_bounds.)"""
    c, kmax = boundary_matrix.shape
    lo = np.full((c_pad, v_pad), np.inf, dtype=np.float32)
    hi = np.full((c_pad, v_pad), np.inf, dtype=np.float32)
    counts = np.zeros((c_pad, 1), dtype=np.int32)
    for i in range(c):
        k = int(boundary_counts[i])
        b = boundary_matrix[i, :k].astype(np.float64)
        edges = np.concatenate([[-np.inf], b, [np.inf]])
        lo[i, : k + 1] = edges[:-1].astype(np.float32)
        hi[i, : k + 1] = edges[1:].astype(np.float32)
        counts[i, 0] = k
    return lo, hi, counts


def _check_bz(table3, raw, lo, hi, counts):
    _check_table3(table3)
    if not table3.is_contiguous():
        raise ValueError("table3 must be contiguous")
    _check_bounds(raw, lo, hi, counts, table3.shape[0], table3.shape[1],
                  table3.device)


def _check_bounds(raw, lo, hi, counts, c_pad: int, v: int, device):
    if raw.dtype != torch.float32 or raw.dim() != 2:
        raise ValueError(f"raw must be f32 [C, Bp], got {raw.dtype} "
                         f"{tuple(raw.shape)}")
    if raw.shape[0] > c_pad:
        raise ValueError(f"{raw.shape[0]} raw columns for a {c_pad}-plane "
                         "table")
    for name, t in (("lo", lo), ("hi", hi)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c_pad, v):
            raise ValueError(f"{name} must be f32 [{c_pad}, {v}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (c_pad, 1):
        raise ValueError(f"counts must be int32 [{c_pad}, 1], got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    for name, t in (("raw", raw), ("lo", lo), ("hi", hi),
                    ("counts", counts)):
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, table3 on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def onehot_bucketize_lookup_plain(table3: torch.Tensor, raw: torch.Tensor,
                                  lo: torch.Tensor, hi: torch.Tensor,
                                  counts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K2, in _bz_kernel's interval form:
    ``onehot[c, b, v] = lo[c, v] <= x < hi[c, v]``, or ``v == counts[c]``
    where x is NaN or +inf; the result is the selected row (0 where no
    slot is selected, as the one-hot product gives)."""
    c = raw.shape[0]
    x = raw[:, :, None]                                    # [C, Bp, 1]
    onehot = (lo[:c, None, :] <= x) & (x < hi[:c, None, :])
    special = ~(x < float("inf"))                          # NaN or +inf
    vids = torch.arange(table3.shape[1], device=raw.device)
    onehot |= special & (vids == counts[:c, :, None])      # [C, Bp, V]
    ids = onehot.to(torch.uint8).argmax(dim=2)             # [C, Bp]
    cols = torch.arange(c, device=raw.device)[:, None]
    rows = table3[cols, ids].float()                       # [C, Bp, d]
    rows = torch.where(onehot.any(dim=2)[:, :, None], rows,
                       torch.zeros_like(rows))
    return rows.transpose(0, 1).contiguous()               # [Bp, C, d]


def onehot_bucketize_lookup(table3: torch.Tensor, raw: torch.Tensor,
                            lo: torch.Tensor, hi: torch.Tensor,
                            counts: torch.Tensor) -> torch.Tensor:
    """rows [Bp, C, d] f32: ``table3[c, bucket(raw[c, b])]``, the bucket
    being the count of column c's boundaries <= x (NaN and +inf: all of
    them).

    table3: [C_pad, V_pad, d] f32 or bf16 (rows upcast as they are read);
    raw: [C, Bp] f32, column-major as the host staged it (C <= C_pad:
    padded planes are never read); lo, hi, counts: ``bucket_bounds(
    boundary_matrix, boundary_counts, V_pad, C_pad)`` on table3's device.
    CPU tensors take the plain version; CUDA tensors launch kernel K2
    (K2-bf16 for a bf16 table3).  Differentiable in an f32 table3
    (backward: ``onehot_bucketize_lookup_grad``)."""
    _check_bz(table3, raw, lo, hi, counts)
    if table3.requires_grad and torch.is_grad_enabled():
        return _OnehotBucketizeLookup.apply(table3, raw, lo, hi, counts)
    return _onehot_bucketize_lookup(table3, raw, lo, hi, counts)


def _onehot_bucketize_lookup(table3, raw, lo, hi, counts):
    if table3.device.type == "cpu":
        return onehot_bucketize_lookup_plain(table3, raw, lo, hi, counts)
    if table3.device.type != "cuda":
        raise ValueError(f"unsupported device {table3.device}")
    c, bp = raw.shape
    v, d = table3.shape[1], table3.shape[2]
    out = torch.empty((bp, c, d), dtype=torch.float32, device=table3.device)
    kernels.launch(
        K2_KERNEL[table3.dtype],
        kernels.ptr(table3), kernels.ptr(raw), kernels.ptr(hi),
        kernels.ptr(counts), kernels.ptr(out), c, bp, v, d,
        kernels.stream_of(table3),
    )
    return out


# ---------------------------------------------------------------------------
# K3a and K3b: the gradients of K1 and K2 in table3
# ---------------------------------------------------------------------------


def cotangent_rows(g: torch.Tensor, bp: int, c: int, d: int):
    """(g, batch stride) for a kernel that reads ``g[b, c, e]`` at
    ``b * stride + c * d + e``: g as given where its (C, d) rows are
    contiguous (a slice of a wider cotangent, or one broadcast along the
    batch), else a contiguous copy."""
    if g.dtype != torch.float32 or tuple(g.shape) != (bp, c, d):
        raise ValueError(f"cotangent must be f32 {(bp, c, d)}, got "
                         f"{g.dtype} {tuple(g.shape)}")
    if (d > 1 and g.stride(2) != 1) or (c > 1 and g.stride(1) != d):
        g = g.contiguous()
    return g, (g.stride(0) if bp > 1 else 0)


def _scatter_rows_plain(g, ids, c_pad, v_pad):
    """``[C_pad, V_pad, d]``: g's rows added at ``ids`` (< 0 dropped) with
    index_add_, one column after another, each in batch order."""
    c = ids.shape[0]
    d = g.shape[2]
    valid = ids >= 0
    cols = torch.arange(c, device=ids.device)[:, None] * v_pad
    flat = (cols + ids.long())[valid]                  # [C, Bp] order
    src = g.transpose(0, 1)[valid]
    out = torch.zeros((c_pad * v_pad, d), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, flat, src).view(c_pad, v_pad, d)


def onehot_lookup_grad_plain(g: torch.Tensor, ids: torch.Tensor,
                             caps: torch.Tensor, c_pad: int,
                             v_pad: int) -> torch.Tensor:
    """The plain PyTorch version of K3a: ids clamped to ``caps`` as K1 reads
    them, then the scatter (``index_add_`` in batch order, column after
    column).  On the CPU that order is exact; on CUDA ``index_add_`` adds
    with atomics in no fixed order."""
    ids = torch.minimum(ids, caps[:, None])
    return _scatter_rows_plain(g, ids, c_pad, v_pad)


def onehot_lookup_grad(g: torch.Tensor, ids: torch.Tensor, caps: torch.Tensor,
                       c_pad: int, v_pad: int) -> torch.Tensor:
    """d(table3) [C_pad, V_pad, d] of ``onehot_lookup(table3, ids, caps)``
    for the cotangent g [Bp, C, d]: g's rows summed per (column, clamped
    id) in batch order; missing ids, padded planes and rows no id selects
    give 0.  CPU tensors take the plain version; CUDA tensors launch kernel
    K3a (``onehot_lookups_grad``)."""
    return onehot_lookups_grad([(g, ids, caps, c_pad, v_pad)])[0]


def onehot_lookups_grad(groups) -> List[torch.Tensor]:
    """``onehot_lookup_grad`` of several groups, one (g, ids, caps, c_pad,
    v_pad) each, all on one device.  CPU tensors take the plain version; on
    CUDA one launch of K3a serves up to K3_MAX_GROUPS groups, after one
    launch of Part for those cut into several vocab tiles."""
    recs = []
    for g, ids, caps, c_pad, v_pad in groups:
        c, bp = ids.shape if ids.dim() == 2 else (-1, -1)
        d = g.shape[2] if g.dim() == 3 else -1
        g, gs = cotangent_rows(g, bp, c, d)
        if ids.dtype != torch.int32 or caps.dtype != torch.int32 or \
                tuple(caps.shape) != (c,) or c > c_pad:
            raise ValueError("ids must be int32 [C, Bp], caps int32 [C], C "
                             "<= C_pad")
        for name, t in (("ids", ids), ("caps", caps)):
            if t.device != g.device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {g.device}")
        recs.append(dict(g=g, gs=gs, ids=ids, caps=caps, c_pad=int(c_pad),
                         v=int(v_pad)))
    if not recs:
        return []
    dev = recs[0]["g"].device
    if any(r["g"].device != dev for r in recs):
        raise ValueError("groups on more than one device")
    if dev.type == "cpu":
        return [onehot_lookup_grad_plain(r["g"], r["ids"], r["caps"],
                                         r["c_pad"], r["v"]) for r in recs]
    return _k3_launch("K3a", recs, dev)


# The host side of K3a's and K3b's launch (csrc/onehot_grad.cu): one launch
# serves up to K3_MAX_GROUPS groups, each described by one K3_DESC record
# (the kernel's struct HostGroup, field for field).  An item is cb columns
# x a tile of nv vocab rows (``k3_geometry``); a group of several tiles
# (cb = 1) has its columns' entries listed by tile by one launch of Part
# first.  The kernel's constants: an item holds at most K3_MAX_KEYS
# (column, row) keys and K3_ACC_FLOATS sums, and a batch row's slice of
# at most K3_ROW_FLOATS floats where it takes several columns.
K3_MAX_GROUPS = 16
K3_MAX_KEYS = 512
K3_ACC_FLOATS = 4096
K3_ROW_FLOATS = 32
# g, ids, caps, raw, hi, counts, dtable, slot, val, off; gs, C, C_pad,
# Bp, V, d, cb, nv, v_tiles, nseg, item_begin
K3_DESC = struct.Struct("<10Q11q")
# what rt_onehot_grad_limits reports, in its order
K3_LIMITS = (K3_MAX_GROUPS, K3_MAX_KEYS, K3_ACC_FLOATS, K3_ROW_FLOATS,
             K3_DESC.size)


def k3_geometry(v: int, d: int):
    """(cb, nv, v_tiles) of a group of vocab V and row length d: the
    columns of an item (a batch row's slice of them at most K3_ROW_FLOATS
    floats, and their keys at most K3_MAX_KEYS), its vocab rows, and the
    tiles that cut a column."""
    if not 1 <= d <= K3_ACC_FLOATS or v < 1:
        raise ValueError(f"K3a / K3b take 1 <= d <= {K3_ACC_FLOATS} and V "
                         f">= 1, got d={d}, V={v}")
    keys = min(K3_MAX_KEYS, K3_ACC_FLOATS // d)
    cb = max(1, min(K3_ROW_FLOATS // d, keys // v))
    nv = min(v, keys // cb)
    return cb, nv, -(-v // nv)


def k3_listed(v: int, d: int) -> bool:
    """Whether a group of vocab V and row length d is cut into several
    vocab tiles, so that its entries are listed by tile (one launch of
    Part before K3a or K3b)."""
    return k3_geometry(v, d)[2] > 1


@functools.lru_cache(maxsize=None)
def _k3_library() -> None:
    """Load K3's library and check, once, that its constants and record
    size are the ones this module plans with."""
    lib = kernels.library("onehot_grad")
    got = (ctypes.c_int64 * len(K3_LIMITS))()
    lib.rt_onehot_grad_limits(got)
    for name, want, have in zip(
            ("groups", "keys", "acc floats", "row floats", "HostGroup size"),
            K3_LIMITS, got):
        if want != have:
            raise RuntimeError(f"csrc/onehot_grad.cu's {name} is {have}, "
                               f"ops/lookup_onehot.py plans with {want}")


@functools.lru_cache(maxsize=64)
def k3_member_info(c: int, v: int, d: int) -> np.ndarray:
    """The partition's member rows of a listed group of C columns
    (ops/item_lists.py): each column's items are its vocab tiles."""
    _, nv, tiles = k3_geometry(v, d)
    return item_lists.member_info(np.full(c, nv), np.full(c, tiles),
                                  np.full(c, v))


def _k3_launch(kid: str, recs, dev) -> List[torch.Tensor]:
    """K3a's or K3b's launches on the card for the groups ``recs`` (dicts:
    g, gs, c_pad, v and ids / caps, or raw / hi / counts): for each
    K3_MAX_GROUPS of them, one launch of Part for those cut into several
    vocab tiles (the dict is its entry), then one of the kernel."""
    _k3_library()
    outs = []
    stream = kernels.stream_of(recs[0]["g"])
    for i in range(0, len(recs), K3_MAX_GROUPS):
        part = recs[i: i + K3_MAX_GROUPS]
        for r in part:
            r["c"], r["bp"] = (r["ids"] if "ids" in r else r["raw"]).shape
            r["d"] = r["g"].shape[2]
            r["geo"] = k3_geometry(r["v"], r["d"])
        listed = [r for r in part if r["geo"][2] > 1 and r["c"] > 0]
        entries = [dict(r, info=k3_member_info(r["c"], r["v"], r["d"]))
                   for r in listed]
        lists = dict(zip(map(id, listed), item_lists.partition(entries)))
        records, items = [], 0
        for r in part:
            cb, nv, tiles = r["geo"]
            out = torch.empty((r["c_pad"], r["v"], r["d"]),
                              dtype=torch.float32, device=dev)
            slot, val, off = lists.get(id(r), (None, None, None))
            records.append(K3_DESC.pack(
                r["g"].data_ptr(), *(kernels.ptr(r.get(k)) or 0 for k in (
                    "ids", "caps", "raw", "hi", "counts")), out.data_ptr(),
                *(kernels.ptr(t) or 0 for t in (slot, val, off)), r["gs"],
                r["c"], r["c_pad"], r["bp"], r["v"], r["d"], cb, nv, tiles,
                0 if off is None else off.shape[1], items))
            items += -(-r["c_pad"] // cb) * tiles
            outs.append(out)
        kernels.launch(kid, b"".join(records), len(part), stream)
    return outs


def bucket_ids_plain(raw: torch.Tensor, hi: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """[C, Bp] int32 buckets of raw values as ``onehot_bucketize_lookup._bwd``
    finds them: the count of the column's boundaries <= x, and ``counts``
    for NaN and +inf.  Counted over ``hi`` (boundaries, then +inf), the row
    K2 searches.  _bwd counts the finite ``lo`` instead, which agrees
    except where a boundary is -inf: _bwd drops it and so disagrees with its
    own forward (ROADMAP Queue 3)."""
    c = raw.shape[0]
    ids = (hi[:c, None, :] <= raw[:, :, None]).sum(dim=2, dtype=torch.int32)
    special = ~(raw < float("inf"))
    return torch.where(special, counts[:c, 0:1], ids)


def onehot_bucketize_lookup_grad_plain(g: torch.Tensor, raw: torch.Tensor,
                                       lo: torch.Tensor, hi: torch.Tensor,
                                       counts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3b: ``bucket_ids_plain``, then K3a's
    scatter."""
    return _scatter_rows_plain(g, bucket_ids_plain(raw, hi, counts),
                               hi.shape[0], hi.shape[1])


def onehot_bucketize_lookup_grad(g: torch.Tensor, raw: torch.Tensor,
                                 lo: torch.Tensor, hi: torch.Tensor,
                                 counts: torch.Tensor) -> torch.Tensor:
    """d(table3) [C_pad, V_pad, d] of ``onehot_bucketize_lookup(table3,
    raw, lo, hi, counts)`` for the cotangent g [Bp, C, d].  CPU tensors
    take the plain version; CUDA tensors launch kernel K3b (after one
    launch of Part where V_pad is cut into several vocab tiles)."""
    c, bp = raw.shape
    c_pad, v_pad = hi.shape
    d = g.shape[2] if g.dim() == 3 else -1
    g, gs = cotangent_rows(g, bp, c, d)
    _check_bounds(raw, lo, hi, counts, c_pad, v_pad, g.device)
    if g.device.type == "cpu":
        return onehot_bucketize_lookup_grad_plain(g, raw, lo, hi, counts)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    return _k3_launch("K3b", [dict(g=g, gs=gs, raw=raw, hi=hi, counts=counts,
                                   c_pad=int(c_pad), v=int(v_pad))],
                      g.device)[0]


class _OnehotLookups(torch.autograd.Function):
    """K1 forward, one launch a group; K3a backward, one launch for every
    group (the backward skips groups whose table3 needs no gradient).
    Saves the ids and caps, not the outputs."""

    @staticmethod
    def forward(ctx, groups, *tables):
        ctx.groups = [(ids, caps, t.shape[0], t.shape[1])
                      for t, (_, ids, caps) in zip(tables, groups)]
        return tuple(_onehot_lookup(t, ids, caps)
                     for t, (_, ids, caps) in zip(tables, groups))

    @staticmethod
    def backward(ctx, *grads):
        need = [i for i, gr in enumerate(grads)
                if ctx.needs_input_grad[1 + i] and gr is not None]
        got = onehot_lookups_grad([(grads[i],) + ctx.groups[i] for i in need])
        out = [None] * (1 + len(grads))
        for i, gr in zip(need, got):
            out[1 + i] = gr
        return tuple(out)


class _OnehotBucketizeLookup(torch.autograd.Function):
    """K2 forward, K3b backward; saves the raw values, not the output.
    Bucketize is piecewise constant: raw gets no gradient."""

    @staticmethod
    def forward(ctx, table3, raw, lo, hi, counts):
        ctx.save_for_backward(raw, lo, hi, counts)
        return _onehot_bucketize_lookup(table3, raw, lo, hi, counts)

    @staticmethod
    def backward(ctx, g):
        raw, lo, hi, counts = ctx.saved_tensors
        return (onehot_bucketize_lookup_grad(g, raw, lo, hi, counts), None,
                None, None, None)
