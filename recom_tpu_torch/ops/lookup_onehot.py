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
serving clamp to each member's ``vocab_caps``.  One launch of K1 serves
every one-hot group of a forward (``onehot_lookups``), each group in a
block tile shaped by its columns and row length (``k1_tile``).

A group whose bucketize members reach the device as raw values, beside
members whose ids the host made (model E's 880 + 50 columns under
``host_bucketize=False``; a bucketize group with an id LUT), is
``Searched`` in K1's id read: the raw ``[n_bz, Bp]`` plane is bucketed by
K2's search over ``searched_bounds``, mapped through the group's LUT, then
capped, where the JAX Engine runs ``device_bucketize``, the LUT gather and
the concat with XLA in front of its kernel (recom_tpu/runtime/executor.py:
482-505).  Its plain version is exactly those steps (``_onehot_plain``).

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
group of a backward (``onehot_lookups``, whose backward collects them;
a searched group's ids are the ones K1 wrote under autograd); a group
whose vocab is cut into several tiles has each column's entries listed by
tile (the partition pass Part, ops/item_lists.py: the step's one launch in
the forward where an ``item_lists.StepLists`` is given), so each tile
reads only the batch rows that select it.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from recom_tpu_torch.ops import item_lists, kernels


# the kernel of each stored dtype of table3; the output is f32 in both
K1_KERNEL = {torch.float32: "K1", torch.bfloat16: "K1-bf16"}
# K1's launch (csrc/onehot_lookup.cu): up to K1_MAX_GROUPS groups, one
# K1_DESC record each (the kernel's struct K1Group, field for field: table3,
# ids, caps, raw, hi, counts, lut, out, ids_out; C, nbz, Bp, V, d, VB, half,
# VL, cols, rows_log2, col_tiles, vec, block_begin); a block tile holds at
# most K1_ENTRIES entries and aims at K1_TILE_BYTES of output
K1_MAX_GROUPS = 16
K1_ENTRIES = 1024
K1_TILE_BYTES = 32768
K1_DESC = struct.Struct("<9Q13q")
# what rt_onehot_lookup_limits reports, in its order
K1_LIMITS = (K1_MAX_GROUPS, K1_ENTRIES, K1_DESC.size)
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


class Searched(NamedTuple):
    """The bucketize members of a one-hot group that reach the device as
    raw values (its columns ``[0, nbz)``), searched in K1's id read.

    raw: [nbz, Bp] f32 as the host staged it; hi, counts: K2's interval
    bounds of their boundaries (``searched_bounds``: ``bucket_bounds``'
    hi and counts over ``boundary_matrix``, one +inf column past the
    widest), [nbz, VB] f32 and [nbz, 1] int32; lut: [nbz, VB] int32, the
    id of each bucket (-1: dropped), or None."""
    raw: torch.Tensor
    hi: torch.Tensor
    counts: torch.Tensor
    lut: Optional[torch.Tensor] = None


def searched_bounds(boundary_matrix: np.ndarray,
                    boundary_counts: np.ndarray, lut_matrix=None):
    """(hi [nbz, VB] f32, counts [nbz, 1] int32, lut [nbz, VB] int32 or
    None) of a group's bucketize members for ``Searched``: VB = the widest
    member's boundaries + 1 (its buckets), the LUT's width."""
    nbz, kmax = np.shape(boundary_matrix)
    _, hi, counts = bucket_bounds(np.asarray(boundary_matrix, np.float32),
                                  boundary_counts, kmax + 1, nbz)
    lut = None
    if lut_matrix is not None:
        lut = np.ascontiguousarray(lut_matrix, np.int32)
        if lut.shape != (nbz, kmax + 1):
            raise ValueError(f"lut must be [{nbz}, {kmax + 1}], got "
                             f"{lut.shape}")
    return hi, counts, lut


def searched_ids_plain(s: Searched) -> torch.Tensor:
    """[nbz, Bp] int32 ids of the searched columns: ``device_bucketize``
    over the boundaries (hi's +inf padding counts nowhere), then the LUT."""
    from recom_tpu_torch.ops.lookup_gather import device_bucketize

    ids = device_bucketize(s.raw, s.hi, s.counts[:, 0])
    if s.lut is not None:
        cols = torch.arange(ids.shape[0], device=ids.device)[:, None]
        ids = s.lut[cols, ids.long()]
    return ids.to(torch.int32)


def _check_searched(table3, ids, caps, s: Searched):
    """A searched group's inputs checked: ``ids`` [C - nbz, Bp] int32 host
    ids, ``caps`` [C], ``s`` as ``Searched`` says."""
    _check_table3(table3)
    nbz, bp = s.raw.shape if s.raw.dim() == 2 else (-1, -1)
    if s.raw.dtype != torch.float32 or nbz < 0:
        raise ValueError(f"raw must be f32 [nbz, Bp], got {s.raw.dtype} "
                         f"{tuple(s.raw.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 2 or ids.shape[1] != bp:
        raise ValueError(f"ids must be int32 [C - nbz, {bp}], got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    c = nbz + ids.shape[0]
    if c > table3.shape[0]:
        raise ValueError(f"{c} id columns for a {table3.shape[0]}-plane table")
    if caps.dtype != torch.int32 or tuple(caps.shape) != (c,):
        raise ValueError(f"caps must be int32 [{c}], got {caps.dtype} "
                         f"{tuple(caps.shape)}")
    vb = s.hi.shape[1] if s.hi.dim() == 2 else -1
    if s.hi.dtype != torch.float32 or tuple(s.hi.shape) != (nbz, vb) or \
            vb < 1:
        raise ValueError(f"hi must be f32 [{nbz}, VB], got {s.hi.dtype} "
                         f"{tuple(s.hi.shape)}")
    if s.counts.dtype != torch.int32 or tuple(s.counts.shape) != (nbz, 1):
        raise ValueError(f"counts must be int32 [{nbz}, 1], got "
                         f"{s.counts.dtype} {tuple(s.counts.shape)}")
    if s.lut is not None and (s.lut.dtype != torch.int32 or
                              tuple(s.lut.shape) != (nbz, vb)):
        raise ValueError(f"lut must be int32 [{nbz}, {vb}], got "
                         f"{s.lut.dtype} {tuple(s.lut.shape)}")
    for name, t in (("table3", table3), ("ids", ids), ("caps", caps),
                    ("raw", s.raw), ("hi", s.hi), ("counts", s.counts),
                    ("lut", s.lut)):
        if t is None:
            continue
        if t.device != table3.device:
            raise ValueError(f"{name} on {t.device}, table3 on {table3.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def onehot_lookups(groups, lists=None) -> List[torch.Tensor]:
    """``onehot_lookup`` of several groups, all on one device: each a
    (table3, ids, caps), or a (table3, host ids, caps, ``Searched``) whose
    first nbz columns are found from raw values in the id read (ids then
    holds the other ``C - nbz`` columns).  One launch of K1 for all of them
    (up to K1_MAX_GROUPS a launch; K1-bf16 for bf16 tables), and, under
    autograd, one launch of K3a for every group whose table3 needs a
    gradient (``onehot_lookups_grad``).  ``lists``: an
    ``item_lists.StepLists`` in which the groups cut into several vocab
    tiles register their entries for K3a (listed by the step's one launch
    of Part), or None (K3a's call lists them)."""
    groups = [tuple(g) for g in groups]
    for g in groups:
        if len(g) == 4 and g[3] is not None:
            _check_searched(*g)
        else:
            _check(*g[:3])
    if torch.is_grad_enabled() and any(g[0].requires_grad for g in groups):
        return list(_OnehotLookups.apply(groups, lists,
                                         *(g[0] for g in groups)))
    return _onehot_lookups(groups)[0]


def _searched(g) -> Optional[Searched]:
    return g[3] if len(g) == 4 else None


def _onehot_plain(g, want_ids: bool):
    """(rows, the group's [C, Bp] ids or None) by the plain version:
    ``searched_ids_plain`` joined to the host ids, then
    ``onehot_lookup_plain``."""
    table3, ids, caps = g[:3]
    s = _searched(g)
    if s is not None:
        ids = torch.cat([searched_ids_plain(s), ids], dim=0)
    return (onehot_lookup_plain(table3, ids, caps),
            ids if want_ids or s is None else None)


def k1_tile(c: int, bp: int, d: int):
    """(cols, rows_log2) of K1's block tile for a group of C columns,
    batch Bp and row length d: up to 32 columns, and as many batch rows (a
    power of two) as bring a block's output near K1_TILE_BYTES, within
    K1_ENTRIES entries and no more than Bp needs."""
    cols = max(1, min(int(c), 32))
    rows = min(max(1, K1_TILE_BYTES // (4 * max(1, int(d)) * cols)),
               K1_ENTRIES // cols)
    rl2 = rows.bit_length() - 1
    while rl2 > 0 and (1 << (rl2 - 1)) >= bp:
        rl2 -= 1
    return cols, rl2


def k1_blocks(c: int, bp: int, d: int) -> int:
    """The blocks of a group's K1 tile grid."""
    cols, rl2 = k1_tile(c, bp, d)
    return -(-c // cols) * -(-bp // (1 << rl2)) if c and bp else 0


@functools.lru_cache(maxsize=None)
def _k1_library() -> None:
    """Load K1's library and check, once, that its constants and record
    size are the ones this module plans with."""
    lib = kernels.library("onehot_lookup")
    got = (ctypes.c_int64 * len(K1_LIMITS))()
    lib.rt_onehot_lookup_limits(got)
    for name, want, have in zip(("groups", "entries", "K1Group size"),
                                K1_LIMITS, got):
        if want != have:
            raise RuntimeError(f"csrc/onehot_lookup.cu's {name} is {have}, "
                               f"ops/lookup_onehot.py plans with {want}")


def _onehot_lookups(groups, want_ids: bool = False):
    """(outputs, ids): each group's rows [Bp, C, d], and, where
    ``want_ids``, each searched group's [C, Bp] ids as K1 read them (the
    ids as given for the others).  CPU tensors take the plain version; on
    CUDA one launch of K1 for every K1_MAX_GROUPS groups of one stored
    dtype."""
    if not groups:
        return [], []
    dev = groups[0][0].device
    if any(g[0].device != dev for g in groups):
        raise ValueError("groups on more than one device")
    if dev.type == "cpu":
        got = [_onehot_plain(g, want_ids) for g in groups]
        return [o for o, _ in got], [i for _, i in got]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _k1_library()
    outs, ids_outs = [None] * len(groups), [None] * len(groups)
    for dtype, kid in K1_KERNEL.items():
        mine = [i for i, g in enumerate(groups) if g[0].dtype == dtype]
        for k in range(0, len(mine), K1_MAX_GROUPS):
            part = mine[k: k + K1_MAX_GROUPS]
            records, blocks = [], 0
            for i in part:
                table3, ids, caps = groups[i][:3]
                s = _searched(groups[i])
                nbz = 0 if s is None else s.raw.shape[0]
                c, bp = nbz + ids.shape[0], ids.shape[1]
                v, d = int(table3.shape[1]), int(table3.shape[2])
                out = torch.empty((bp, c, d), dtype=torch.float32,
                                  device=dev)
                ids_out = None
                if s is not None and want_ids:
                    ids_out = torch.empty((c, bp), dtype=torch.int32,
                                          device=dev)
                cols, rl2 = k1_tile(c, bp, d)
                vb = 0 if s is None else int(s.hi.shape[1])
                vec = (d % 4 == 0 and table3.data_ptr() %
                       (4 * table3.element_size()) == 0 and
                       out.data_ptr() % 16 == 0)
                srcs = (None,) * 4 if s is None else tuple(s)
                records.append(K1_DESC.pack(
                    table3.data_ptr(), kernels.ptr(ids) or 0, caps.data_ptr(),
                    *(kernels.ptr(t) or 0 for t in srcs),
                    out.data_ptr(), kernels.ptr(ids_out) or 0,
                    c, nbz, bp, v, d, vb, item_lists.first_step(vb) if vb
                    else 0, vb, cols, rl2, -(-c // cols), int(vec), blocks))
                blocks += k1_blocks(c, bp, d)
                outs[i] = out
                ids_outs[i] = ids_out if s is not None else ids
            kernels.launch(kid, b"".join(records), len(part), blocks,
                           kernels.stream_of(groups[part[0]][0]))
    return outs, ids_outs


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
                            counts: torch.Tensor,
                            lists=None) -> torch.Tensor:
    """rows [Bp, C, d] f32: ``table3[c, bucket(raw[c, b])]``, the bucket
    being the count of column c's boundaries <= x (NaN and +inf: all of
    them).

    table3: [C_pad, V_pad, d] f32 or bf16 (rows upcast as they are read);
    raw: [C, Bp] f32, column-major as the host staged it (C <= C_pad:
    padded planes are never read); lo, hi, counts: ``bucket_bounds(
    boundary_matrix, boundary_counts, V_pad, C_pad)`` on table3's device.
    CPU tensors take the plain version; CUDA tensors launch kernel K2
    (K2-bf16 for a bf16 table3).  Differentiable in an f32 table3
    (backward: ``onehot_bucketize_lookup_grad``; ``lists``: an
    ``item_lists.StepLists`` that takes its ``k3b_entry`` for the step's
    one launch of Part, or None)."""
    _check_bz(table3, raw, lo, hi, counts)
    if table3.requires_grad and torch.is_grad_enabled():
        return _OnehotBucketizeLookup.apply(table3, raw, lo, hi, counts,
                                            lists)
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


def onehot_lookups_grad(groups, lists=None) -> List[torch.Tensor]:
    """``onehot_lookup_grad`` of several groups, one (g, ids, caps, c_pad,
    v_pad) each, all on one device.  CPU tensors take the plain version; on
    CUDA one launch of K3a serves up to K3_MAX_GROUPS groups, after one
    launch of Part for those cut into several vocab tiles.  ``lists``: one
    entry a group, the (slot, val, off) that Part already wrote for its
    ``k3a_entry`` (the forward's launch) or None; Part then lists only the
    groups left without."""
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
    for r, got in zip(recs, lists or ()):
        if got is not None:
            r["lists"] = got
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


def k3a_entry(ids, caps, c_pad: int, v_pad: int, d: int):
    """The partition's entry (ops/item_lists.py) of a K3a group of [C, Bp]
    ids and row length d where its vocab is cut into several tiles (its
    columns' entries listed by tile), else None."""
    c = ids.shape[0]
    if c == 0 or not k3_listed(v_pad, d):
        return None
    return dict(ids=ids, caps=caps, info=k3_member_info(c, v_pad, d))


def k3b_entry(raw, hi, counts, d: int):
    """K3b's counterpart of ``k3a_entry`` for a raw [C, Bp] plane and K2's
    bounds."""
    c = raw.shape[0]
    if c == 0 or not k3_listed(hi.shape[1], d):
        return None
    return dict(raw=raw, hi=hi, counts=counts,
                info=k3_member_info(c, hi.shape[1], d))


def _k3_launch(kid: str, recs, dev) -> List[torch.Tensor]:
    """K3a's or K3b's launches on the card for the groups ``recs`` (dicts:
    g, gs, c_pad, v and ids / caps, or raw / hi / counts; ``lists`` where
    Part already listed it): for each K3_MAX_GROUPS of them, one launch of
    Part for those cut into several vocab tiles and not yet listed (the
    dict is its entry), then one of the kernel."""
    _k3_library()
    outs = []
    stream = kernels.stream_of(recs[0]["g"])
    for i in range(0, len(recs), K3_MAX_GROUPS):
        part = recs[i: i + K3_MAX_GROUPS]
        for r in part:
            r["c"], r["bp"] = (r["ids"] if "ids" in r else r["raw"]).shape
            r["d"] = r["g"].shape[2]
            r["geo"] = k3_geometry(r["v"], r["d"])
        listed = [r for r in part if r["geo"][2] > 1 and r["c"] > 0
                  and "lists" not in r]
        entries = [dict(r, info=k3_member_info(r["c"], r["v"], r["d"]))
                   for r in listed]
        lists = dict(zip(map(id, listed), item_lists.partition(entries)))
        lists.update((id(r), r["lists"]) for r in part if "lists" in r)
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
                0 if off is None else item_lists.segments(r["bp"]), items))
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
                                 counts: torch.Tensor,
                                 lists=None) -> torch.Tensor:
    """d(table3) [C_pad, V_pad, d] of ``onehot_bucketize_lookup(table3,
    raw, lo, hi, counts)`` for the cotangent g [Bp, C, d].  CPU tensors
    take the plain version; CUDA tensors launch kernel K3b (after one
    launch of Part where V_pad is cut into several vocab tiles, unless
    ``lists``, Part's (slot, val, off) of ``k3b_entry``, are given)."""
    c, bp = raw.shape
    c_pad, v_pad = hi.shape
    d = g.shape[2] if g.dim() == 3 else -1
    g, gs = cotangent_rows(g, bp, c, d)
    _check_bounds(raw, lo, hi, counts, c_pad, v_pad, g.device)
    if g.device.type == "cpu":
        return onehot_bucketize_lookup_grad_plain(g, raw, lo, hi, counts)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    rec = dict(g=g, gs=gs, raw=raw, hi=hi, counts=counts, c_pad=int(c_pad),
               v=int(v_pad))
    if lists is not None:
        rec["lists"] = lists
    return _k3_launch("K3b", [rec], g.device)[0]


class _OnehotLookups(torch.autograd.Function):
    """K1 forward, one launch for every group; K3a backward, one launch for
    every group (the backward skips groups whose table3 needs no
    gradient).  Saves each group's [C, Bp] ids (a searched group's as K1
    wrote them) and caps, not the outputs; the groups cut into several
    vocab tiles register their entries in ``lists`` (a ``StepLists`` of
    its own where none is given), for the step's one launch of Part."""

    @staticmethod
    def forward(ctx, groups, lists, *tables):
        groups = [(t,) + tuple(g[1:]) for t, g in zip(tables, groups)]
        outs, ids = _onehot_lookups(groups, want_ids=True)
        ctx.groups = [(i, g[2], t.shape[0], t.shape[1])
                      for t, g, i in zip(tables, groups, ids)]
        ctx.lists = item_lists.StepLists() if lists is None else lists
        ctx.keys = {k: ctx.lists.add(k3a_entry(*g, t.shape[2]))
                    for k, (t, g) in enumerate(zip(tables, ctx.groups))
                    if t.requires_grad}
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        need = [i for i, gr in enumerate(grads)
                if ctx.needs_input_grad[2 + i] and gr is not None]
        args = [(grads[i],) + ctx.groups[i] for i in need]
        got = onehot_lookups_grad(args, lists=[
            ctx.lists.get(ctx.keys.get(i)) for i in need])
        out = [None] * (2 + len(grads))
        for i, gr in zip(need, got):
            out[2 + i] = gr
        return tuple(out)


class _OnehotBucketizeLookup(torch.autograd.Function):
    """K2 forward, K3b backward; saves the raw values, not the output.
    Bucketize is piecewise constant: raw gets no gradient."""

    @staticmethod
    def forward(ctx, table3, raw, lo, hi, counts, lists):
        ctx.save_for_backward(raw, lo, hi, counts)
        ctx.lists = item_lists.StepLists() if lists is None else lists
        ctx.key = ctx.lists.add(k3b_entry(raw, hi, counts, table3.shape[2]))
        return _onehot_bucketize_lookup(table3, raw, lo, hi, counts)

    @staticmethod
    def backward(ctx, g):
        raw, lo, hi, counts = ctx.saved_tensors
        got = ctx.lists.get(ctx.key)
        return (onehot_bucketize_lookup_grad(g, raw, lo, hi, counts, got),
                None, None, None, None, None)
