"""X1: masked, in-order gather + pooling of a stacked column group (the
port of recom_tpu/ops/lookup_xla.py: ``group_pooled`` with
``gather_rows_f32``, ``pool_rows_inorder`` and ``apply_combiner_divisors``;
``device_bucketize`` comes along for the structured, non-wire path).

Bit-exactness contract (vs the NumPy oracle): pooling accumulates float32
in in-row entry order, each product and sum rounded separately (no FMA),
empty rows produce zeros, ids < 0 are masked out.  Combiner divisors are
applied once, after the sum, as IEEE float32 divisions and square roots;
unweighted columns multiply by the rounded reciprocal, weighted columns
divide (TF's two rounding conventions).  The reference needs emulated f64
for this on the TPU; f32 IEEE division on the CPU and in CUDA (``__fdiv_rn``,
and torch's own ``/``) gives the same bits directly.  Square roots: CUDA's
``__fsqrt_rn`` is correctly rounded, torch's f32 ``sqrt`` on the CPU is not,
so the plain version takes the root in f64 and narrows it.

Layout: the port keeps the host's column-major order, so ids and weights
are ``[C, Bp, L]``, gathered rows ``[C, Bp, L, d]``, sums ``[C, Bp, d]``
and ``[C, Bp]``.  ``group_pooled`` returns batch-major ``[Bp, C, d]`` like
its reference.  The plain versions below are the reference's arithmetic as
eager torch ops (a Python loop over L, the multiply and the add as separate
ops); on CUDA tensors ``group_pooled`` launches kernel X1
(csrc/pooled_gather.cu) instead, and ``groups_pooled`` serves several
groups with one launch (the Engine's gather groups, all at once).  The
kernel skips a missing slot where the plain version adds row 0 of the
member times 0, as the reference does: the two agree with ``==`` while
no member's row 0 holds NaN or inf (csrc/pooled_gather.cu says why).

Stored dtypes: a table is f32, bf16, or an int8 ``ops/quant.QuantizedTable``
(rows and per-row f32 scales), as ``EngineConfig.table_dtype`` stores it.
Rows are gathered as stored and made f32 before the pooling: bf16 upcast
(exact), int8 dequantized as ``f32(q) * scale``, one rounded product
(``gather_rows_f32``, the reference's lookup_xla.py:61-76).  On the card
each stored dtype has its own kernel (X1, X1-bf16, X1-int8 in
csrc/pooled_gather.cu).

Gradient (training): ``groups_pooled`` is differentiable in each group's
f32 table.  X1b (``groups_pooled_grad``, one launch for every group of a
backward, after one launch of the partition Part that lists each work
item's slots, ops/item_lists.py; csrc/pooled_gather_grad.cu) is the
transpose of the reference's arithmetic, each step rounded on its own: the
pooled cotangent scaled as the combiner divided (times the rounded
reciprocal, or divided, by the bag's denominator; 0 where it is not > 0),
times each slot's weight, added into the dense ``[R, d]`` table gradient at
the slot's clamped, offset row.  A missing slot adds nothing.  Both the
plain version and the kernel sum each row in ``[C, Bp, L]`` slot order, so
they agree bit for bit; the reference's autodiff adds in its gather's
``[L, Bp, C]`` order, so it agrees to rounding where a row takes several
slots.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import weakref
from typing import List, Optional

import numpy as np
import torch

from recom_tpu_torch.ops import item_lists, kernels
from recom_tpu_torch.ops.quant import QuantizedTable, dequantize_rows


def as_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a contiguous ``dtype`` tensor on ``device`` (host arrays and
    tensors alike; a tensor already in place is returned as is)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device).contiguous()


def device_bucketize(x: torch.Tensor, boundaries: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """TF Bucketize over a column group, column-major.

    x: [C, Bp] raw floats; boundaries: [C, K] padded with +inf; counts: [C]
    true boundary counts.  id = #boundaries <= x (upper_bound); NaN maps to
    count.  Returns [C, Bp] int32."""
    kmax = boundaries.shape[1]
    less = (x[:, :, None] < boundaries[:, None, :]).sum(
        dim=-1, dtype=torch.int32
    )
    ids = kmax - less
    return torch.minimum(torch.clamp(ids, min=0), counts[:, None])


def gather_rows_f32(table, idx: torch.Tensor) -> torch.Tensor:
    """Rows of an ``[R, d]`` table at int64 ``idx`` (any shape), as f32
    (recom_tpu/ops/lookup_xla.py:61-76): an f32 table's rows as they are;
    a bf16 table's upcast after the gather; a ``QuantizedTable``'s int8
    rows and their scales gathered, then dequantized (one rounded
    product)."""
    if isinstance(table, QuantizedTable):
        return dequantize_rows(table.q[idx], table.scale[idx])
    rows = table[idx]
    return rows if rows.dtype == torch.float32 else rows.float()


def combiner_denominators(wsum: torch.Tensor, w2sum: torch.Tensor,
                          combiner_code: np.ndarray):
    """(nonzero, safe) [C, Bp]: whether each bag's combiner denominator
    (mean: the weight sum, sqrtn: the root of the squared weights' sum,
    sum: 1) is > 0, and the denominator where it is, else 1."""
    combiner_code = np.asarray(combiner_code)
    code = torch.as_tensor(combiner_code, device=wsum.device)[:, None]
    one = torch.ones_like(wsum)
    if (combiner_code == 2).any():
        # torch's f32 sqrt on the CPU is not always correctly rounded (its
        # vectorized kernel misses by an ulp on some inputs); narrowing the
        # f64 root to f32 rounds correctly
        sq = torch.sqrt(w2sum.double()).float()
        denom = torch.where(code == 1, wsum, torch.where(code == 2, sq, one))
    else:
        denom = torch.where(code == 1, wsum, one)
    nonzero = denom > 0
    return nonzero, torch.where(nonzero, denom, one)


def apply_combiner_divisors(
    acc: torch.Tensor,              # [C, Bp, d] in-order sums
    wsum: torch.Tensor,             # [C, Bp] sum of weights
    w2sum: torch.Tensor,            # [C, Bp] sum of squared weights
    combiner_code: np.ndarray,      # [C] 0 sum / 1 mean / 2 sqrtn
    weighted_cols,                  # bool or [C] bool: divide vs reciprocal
) -> torch.Tensor:
    """Combiner denominator (mean: wsum, sqrtn: sqrt(w2sum)); rows whose
    denominator is not > 0 become zeros."""
    combiner_code = np.asarray(combiner_code)
    if not ((combiner_code == 1) | (combiner_code == 2)).any():
        return acc
    dev = acc.device
    nonzero, safe = combiner_denominators(wsum, w2sum, combiner_code)
    one = torch.ones_like(safe)
    wmask = (
        np.full(combiner_code.shape, bool(weighted_cols))
        if isinstance(weighted_cols, (bool, np.bool_))
        else np.asarray(weighted_cols, bool)
    )
    if wmask.all():
        out = acc / safe[:, :, None]
    elif not wmask.any():
        out = acc * (one / safe)[:, :, None]
    else:
        out = torch.where(
            torch.as_tensor(wmask, device=dev)[:, None, None],
            acc / safe[:, :, None],
            acc * (one / safe)[:, :, None],
        )
    return torch.where(nonzero[:, :, None], out, torch.zeros_like(out))


def pool_rows_inorder(
    rows: torch.Tensor,             # [C, Bp, L, d] gathered rows
    w: torch.Tensor,                # [C, Bp, L] f32 weights, 0 at pads
    combiner_code: np.ndarray,
    weighted_cols,
) -> torch.Tensor:
    """Pool gathered rows left to right in float32: the multiply and the add
    are separate eager ops, so each is rounded on its own."""
    combiner_code = np.asarray(combiner_code)
    need_sqrtn = bool((combiner_code == 2).any())
    acc = rows[:, :, 0] * 0.0
    wsum = w[:, :, 0] * 0.0
    w2sum = w[:, :, 0] * 0.0
    for l in range(rows.shape[2]):
        wl = w[:, :, l]
        acc = acc + rows[:, :, l] * wl[:, :, None]
        wsum = wsum + wl
        w2sum = w2sum + (wl * wl if need_sqrtn else wl)
    return apply_combiner_divisors(acc, wsum, w2sum, combiner_code,
                                   weighted_cols)


def group_pooled_plain(
    table,                          # [R, d] stacked table: f32, bf16 or int8
    ids: torch.Tensor,              # [C, Bp, L] int32, -1 = missing/pad
    row_offsets: np.ndarray,        # [C]
    combiner_code: np.ndarray,      # [C]
    weights: Optional[torch.Tensor] = None,   # [C, Bp, L] f32
    weighted_cols=None,             # scalar or [C] bool
    vocab_caps: Optional[np.ndarray] = None,  # [C] last valid row
) -> torch.Tensor:
    """The plain PyTorch version of X1 (the reference's two branches)."""
    dev = ids.device
    combiner_code = np.asarray(combiner_code)
    if vocab_caps is not None:
        ids = torch.minimum(
            ids, as_device(vocab_caps, torch.int32, dev)[:, None, None]
        )
    c, bp, l = ids.shape
    mask = ids >= 0
    weighted = (
        (weights is not None) if weighted_cols is None else weighted_cols
    )
    w = mask.to(torch.float32) if weights is None else weights * mask
    offs = as_device(row_offsets, torch.int64, dev)[:, None, None]
    safe = torch.where(mask, ids, torch.zeros_like(ids)).long() + offs
    need_mean = bool((combiner_code == 1).any())
    need_sqrtn = bool((combiner_code == 2).any())
    if l == 1:
        acc = gather_rows_f32(table, safe[:, :, 0]) * w[:, :, 0][:, :, None]
        if need_mean or need_sqrtn:
            wsum = w[:, :, 0]
            w2sum = wsum * wsum if need_sqrtn else wsum
            acc = apply_combiner_divisors(acc, wsum, w2sum, combiner_code,
                                          weighted)
    else:
        rows = gather_rows_f32(table, safe)                  # [C, Bp, L, d]
        acc = pool_rows_inorder(rows, w, combiner_code, weighted)
    return acc.transpose(0, 1).contiguous()                  # [Bp, C, d]


# The host side of kernel X1's launch (csrc/pooled_gather.cu): a block of
# X1_THREADS lanes takes a tile of columns x batch rows of one group, and
# one launch serves up to X1_MAX_GROUPS groups of one stored dtype, each
# described by one X1_DESC record (the kernel's struct X1Group, field for
# field: X1_FIELDS).  Each stored dtype has its own kernel and launch
# count: X1 (f32 rows), X1-bf16 and X1-int8 (int8 rows and f32 scales).
# A group takes the bag tile (G lanes a bag, U stored elements a lane
# load) or, with L == 1 and no weights plane, the one-id tile (32 columns
# x 32 batch rows, K1's); the record's kind is 64 * one-id + 8 * log2(U) +
# log2(G).
X1_THREADS = 256
X1_MAX_GROUPS = 8
X1_ONEID_TILE = 32
X1_FIELDS = ("table", "scales", "ids", "weights", "row_offsets", "caps",
             "codes", "weighted", "out", "C", "Bp", "L", "dq", "block_begin",
             "tiles_b", "kind")
X1_DESC = struct.Struct("<9Q5q2i")
X1_KERNEL = {torch.float32: "X1", torch.bfloat16: "X1-bf16",
             torch.int8: "X1-int8"}
# f32 groups of one id take the one-id tile below this row width (bf16 and
# int8 ones at every width): an f32 row of 32 floats or more already
# leaves the bag tile as whole 128-byte lines.  chip_smoke.py's
# x1_oneid_f32_ab times X1's f32 launch both ways in turns; on an NVIDIA
# H100 80GB HBM3 at 700 W the bag tile / the one-id tile read 0.0120,
# 0.0122 / 0.0122, 0.0118 ms at model E (d = 8), 0.0137, 0.0137 / 0.0116,
# 0.0119 at model F (d = 8), and 0.0074 (bag, earlier run) / 0.0089 at the
# Criteo DLRM's d = 64.
X1_ONEID_F32_BELOW_D = 32


def x1_unit(d: int, itemsize: int, ptr: int, oneid: bool = False) -> int:
    """The stored elements U a lane loads at once for rows of d elements
    of ``itemsize`` bytes starting at address ``ptr``: the largest of 16,
    8 and 4 whose load is at most 16 bytes (f32 4; bf16 8; int8 16) and
    that divides d, with each row aligned to it; else 1.  The one-id tile
    loads K1's units: 4 or 1."""
    for u in (4,) if oneid else (16, 8, 4):
        if u * itemsize <= 16 and d % u == 0 and ptr % (u * itemsize) == 0:
            return u
    return 1


def x1_tile(d: int, unit: int, oneid: bool = False):
    """(dq, lanes, tile_rows, tile_cols) of a group with row length d and
    lane unit ``unit``: dq = d / unit units a row, ``lanes`` (G) a bag, the
    smallest power of two >= dq up to 32, and a block tile of tile_cols
    columns x tile_rows batch rows.  The one-id tile is 32 x 32 with no
    lanes a bag (G = 1 in its kind)."""
    dq = d // unit
    if oneid:
        return dq, 1, X1_ONEID_TILE, X1_ONEID_TILE
    lanes = 1
    while lanes < min(dq, 32):
        lanes *= 2
    bags = X1_THREADS // lanes
    rows = min(32, bags)
    return dq, lanes, rows, bags // rows


def x1_descriptors(groups):
    """The X1_DESC records of one launch, packed, and its block count.

    groups: one dict per group, with the device pointers ``table``,
    ``scales`` (an int8 table's; 0 for none), ``ids``, ``weights`` (0 for
    none), ``row_offsets``, ``caps``, ``codes``, ``weighted`` and ``out``,
    the sizes ``C``, ``Bp``, ``L``, ``d``, ``unit`` (stored elements a lane
    load, ``x1_unit``) and ``oneid`` (the one-id tile).  Blocks are
    numbered group after group; each group's first block is its
    ``block_begin``."""
    if not 1 <= len(groups) <= X1_MAX_GROUPS:
        raise ValueError(f"1 to {X1_MAX_GROUPS} groups per launch, got "
                         f"{len(groups)}")
    records = []
    blocks = 0
    for g in groups:
        unit, oneid = g["unit"], bool(g["oneid"])
        if unit not in ((1, 4) if oneid else (1, 4, 8, 16)) or g["d"] % unit:
            raise ValueError(f"a unit of {unit} elements does not fit rows "
                             f"of d={g['d']} ({'one-id' if oneid else 'bag'} "
                             "tile)")
        if oneid and (g["L"] != 1 or g["weights"]):
            raise ValueError("the one-id tile takes L == 1 and no weights")
        dq, lanes, rows, cols = x1_tile(g["d"], unit, oneid)
        tiles_b = -(-g["Bp"] // rows)
        records.append(X1_DESC.pack(
            g["table"], g["scales"], g["ids"], g["weights"], g["row_offsets"],
            g["caps"], g["codes"], g["weighted"], g["out"], g["C"], g["Bp"],
            g["L"], dq, blocks, tiles_b,
            64 * oneid + 8 * (unit.bit_length() - 1) + lanes.bit_length() - 1,
        ))
        blocks += -(-g["C"] // cols) * tiles_b
    if blocks >= 1 << 31:
        raise ValueError(f"{blocks} blocks exceed the grid")
    return b"".join(records), blocks


def _weighted_mask(weighted_cols, weights, c: int) -> np.ndarray:
    if weighted_cols is None:
        return np.full(c, weights is not None)
    if isinstance(weighted_cols, (bool, np.bool_)):
        return np.full(c, bool(weighted_cols))
    if isinstance(weighted_cols, torch.Tensor):
        # the host copy kept while the tensor is unchanged: a captured
        # backward reads no device tensor on the host
        return _host_array(weighted_cols).astype(bool)
    return np.asarray(weighted_cols, bool)


def _rows(table) -> torch.Tensor:
    """The stored ``[R, d]`` rows of a table: itself, or a QuantizedTable's
    int8 ``q``."""
    return table.q if isinstance(table, QuantizedTable) else table


def _check_group(table, ids, weights):
    if isinstance(table, QuantizedTable):
        q, sc = table
        if q.dtype != torch.int8 or q.dim() != 2 or \
                sc.dtype != torch.float32 or tuple(sc.shape) != q.shape[:1] \
                or sc.device != q.device:
            raise ValueError(f"a QuantizedTable holds int8 [R, d] rows and "
                             f"f32 [R] scales on one device, got {q.dtype} "
                             f"{tuple(q.shape)} and {sc.dtype} "
                             f"{tuple(sc.shape)} on {sc.device}")
        table = q
    elif table.dtype not in (torch.float32, torch.bfloat16) or \
            table.dim() != 2:
        raise ValueError(f"table must be f32 or bf16 [R, d], or a "
                         f"QuantizedTable, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 3:
        raise ValueError(f"ids must be int32 [C, Bp, L], got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    c, bp, l = ids.shape
    if weights is not None and (
        weights.dtype != torch.float32 or tuple(weights.shape) != (c, bp, l)
    ):
        raise ValueError(f"weights must be f32 {(c, bp, l)}, got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    for name, t in (("ids", ids), ("weights", weights)):
        if t is not None and t.device != table.device:
            raise ValueError(f"{name} on {t.device}, table on {table.device}")


def _plain(table, ids, row_offsets, combiner_code, weights=None,
           weighted_cols=None, vocab_caps=None):
    to_np = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else x
    return group_pooled_plain(
        table, ids, to_np(row_offsets), to_np(combiner_code), weights,
        _weighted_mask(weighted_cols, weights, ids.shape[0]),
        None if vocab_caps is None else to_np(vocab_caps),
    )


def _column_args(c: int, dev, row_offsets, combiner_code, weights,
                 weighted_cols, vocab_caps):
    """A group's per-column kernel arguments on ``dev``: row offsets, caps
    (no clamp: int32 max), combiner codes (int32) and the divide-or-
    reciprocal flags (uint8)."""
    if vocab_caps is None:
        vocab_caps = np.full(c, np.iinfo(np.int32).max, np.int32)
    offs = as_device(row_offsets, torch.int32, dev)
    caps = as_device(vocab_caps, torch.int32, dev)
    codes = as_device(combiner_code, torch.int32, dev)
    if isinstance(weighted_cols, torch.Tensor):
        wcols = as_device(weighted_cols, torch.uint8, dev)
    else:
        wcols = as_device(_weighted_mask(weighted_cols, weights, c),
                          torch.uint8, dev)
    for name, t in (("row_offsets", offs), ("vocab_caps", caps),
                    ("combiner_code", codes), ("weighted_cols", wcols)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must have shape ({c},), got "
                             f"{tuple(t.shape)}")
    return offs, caps, codes, wcols


def _x1_group(table, ids, row_offsets, combiner_code, weights=None,
              weighted_cols=None, vocab_caps=None):
    """One group's descriptor fields on the card, its output, and the
    tensors its pointers refer to (held until the launch is queued)."""
    rows = _rows(table)
    scales = table.scale if isinstance(table, QuantizedTable) else None
    dev = rows.device
    c, bp, l = ids.shape
    offs, caps, codes, wcols = _column_args(c, dev, row_offsets,
                                            combiner_code, weights,
                                            weighted_cols, vocab_caps)
    for name, t in (("table", rows), ("scales", scales), ("ids", ids),
                    ("weights", weights)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d = rows.shape[1]
    out = torch.empty((bp, c, d), dtype=torch.float32, device=dev)
    oneid = l == 1 and weights is None and (rows.dtype != torch.float32
                                            or d < X1_ONEID_F32_BELOW_D)
    # a unit of U > 1 elements stores U / 4 float4s
    unit = (x1_unit(d, rows.element_size(), rows.data_ptr(), oneid)
            if out.data_ptr() % 16 == 0 else 1)
    fields = dict(
        table=rows.data_ptr(),
        scales=0 if scales is None else scales.data_ptr(),
        ids=ids.data_ptr(),
        weights=0 if weights is None else weights.data_ptr(),
        row_offsets=offs.data_ptr(), caps=caps.data_ptr(),
        codes=codes.data_ptr(), weighted=wcols.data_ptr(),
        out=out.data_ptr(), C=c, Bp=bp, L=l, d=d, unit=unit,
        oneid=oneid,
    )
    return fields, out, (offs, caps, codes, wcols)


@functools.lru_cache(maxsize=None)
def _x1_library() -> None:
    """Load X1's library and check, once, that its X1Group is X1_DESC's
    size."""
    lib = kernels.library("pooled_gather")
    if lib.rt_pooled_gather_desc_size() != X1_DESC.size:
        raise RuntimeError("csrc/pooled_gather.cu's X1Group and X1_DESC "
                           "differ in size")


def groups_pooled(groups, lists=None) -> List[torch.Tensor]:
    """Pooled lookups of several groups, [Bp, C, d] f32 each.

    groups: one argument tuple of ``group_pooled`` per group (table, ids,
    row_offsets, combiner_code[, weights, weighted_cols, vocab_caps]), all
    on one device.  CPU tensors take the plain version; on CUDA one launch
    of kernel X1 (X1-bf16, X1-int8 for those stored dtypes) serves up to
    X1_MAX_GROUPS groups of one stored dtype.  Differentiable in each f32
    table (backward: ``groups_pooled_grad``, one launch of X1b for every
    group; ``lists``: an ``item_lists.StepLists`` that takes each such
    group's partition entry, ``x1b_forward_entry``, for the step's one
    launch of Part, or None: X1b's call lists them)."""
    groups = [tuple(g) for g in groups]
    for g in groups:
        _check_group(g[0], g[1], g[4] if len(g) > 4 else None)
    if not groups:
        return []
    if torch.is_grad_enabled() and any(
            isinstance(g[0], torch.Tensor) and g[0].requires_grad
            for g in groups):
        return list(_GroupsPooled.apply(groups, lists,
                                        *(g[0] for g in groups)))
    return _groups_pooled(groups)


def _groups_pooled(groups) -> List[torch.Tensor]:
    dev = _rows(groups[0][0]).device
    if any(_rows(g[0]).device != dev for g in groups):
        raise ValueError("groups on more than one device")
    if dev.type == "cpu":
        return [_plain(*g) for g in groups]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _x1_library()
    outs: List[Optional[torch.Tensor]] = [None] * len(groups)
    by_kernel: dict = {}
    for i, g in enumerate(groups):
        by_kernel.setdefault(X1_KERNEL[_rows(g[0]).dtype], []).append(i)
    stream = kernels.stream_of(_rows(groups[0][0]))
    for kid, idx in by_kernel.items():
        made = {j: _x1_group(*groups[j]) for j in idx}
        # bag groups first: their blocks, bound by the latency of their
        # slot chains, start first, and the one-id tiles' streaming writes
        # fill the SMs around them
        idx = sorted(idx, key=lambda j: made[j][0]["oneid"])
        for i in range(0, len(idx), X1_MAX_GROUPS):
            part = idx[i: i + X1_MAX_GROUPS]
            desc, blocks = x1_descriptors([made[j][0] for j in part])
            kernels.launch(kid, desc, len(part), blocks, stream)
            for j in part:
                outs[j] = made[j][1]
    return outs


def group_pooled(
    table: torch.Tensor,
    ids: torch.Tensor,
    row_offsets,
    combiner_code,
    weights: Optional[torch.Tensor] = None,
    weighted_cols=None,
    vocab_caps=None,
) -> torch.Tensor:
    """Pooled group lookups [Bp, C, d] f32.

    table: [R, d] stacked rows, f32 or bf16, or an int8 ``QuantizedTable``
    of rows and per-row scales (pooled in f32 all the same: each row is
    upcast or dequantized after its load); ids: [C, Bp, L] int32
    member-local ids (< 0 = missing), clamped to ``vocab_caps`` then offset by
    ``row_offsets``; weights: optional [C, Bp, L] f32; combiner_code: [C]
    0 sum / 1 mean / 2 sqrtn; weighted_cols: per-column divide-vs-reciprocal
    rounding (default: weights given).  The per-column arguments may be
    host arrays or device tensors.  CPU tensors take the plain version;
    CUDA tensors launch kernel X1."""
    return groups_pooled([(table, ids, row_offsets, combiner_code, weights,
                           weighted_cols, vocab_caps)])[0]


# ---------------------------------------------------------------------------
# X1b: the gradient of the pooled lookup in the stacked table
# ---------------------------------------------------------------------------


def combiner_cotangent(
    g: torch.Tensor,                # [Bp, C, d] cotangent of the pooled
    ids: torch.Tensor,              # [C, Bp, L] int32, clamped, -1 = missing
    combiner_code,                  # [C]
    weights: Optional[torch.Tensor] = None,   # [C, Bp, L] f32
    weighted_cols=None,             # scalar or [C] bool
) -> torch.Tensor:
    """[C, Bp, d]: the cotangent each slot of a bag takes before its
    weight: ``g`` as is under SUM; under MEAN / SQRTN scaled as the
    combiner divided (times the rounded reciprocal, or divided, by the
    bag's denominator summed in slot order), 0 where the denominator is
    not > 0."""
    if isinstance(combiner_code, torch.Tensor):
        combiner_code = combiner_code.cpu().numpy()
    combiner_code = np.asarray(combiner_code)
    dacc = g.transpose(0, 1)                                 # [C, Bp, d]
    need_sqrtn = bool((combiner_code == 2).any())
    if not (need_sqrtn or bool((combiner_code == 1).any())):
        return dacc
    c, _, l = ids.shape
    mask = ids >= 0
    w = mask.to(torch.float32) if weights is None else weights * mask
    wsum = w[:, :, 0] * 0.0
    w2sum = w[:, :, 0] * 0.0
    for k in range(l):
        wk = w[:, :, k]
        wsum = wsum + wk
        w2sum = w2sum + (wk * wk if need_sqrtn else wk)
    nz, safe = combiner_denominators(wsum, w2sum, combiner_code)
    safe = safe[:, :, None]
    dacc = torch.where(nz[:, :, None], dacc, torch.zeros_like(dacc))
    wmask = torch.as_tensor(
        _weighted_mask(weighted_cols, weights, c), device=ids.device
    )[:, None, None]
    return torch.where(wmask, dacc / safe,
                       dacc * (torch.ones_like(safe) / safe))


def slot_contributions(
    g: torch.Tensor,                # [Bp, C, d] cotangent of the pooled
    ids: torch.Tensor,              # [C, Bp, L] int32, -1 = missing/pad
    row_offsets: np.ndarray,        # [C]
    combiner_code: np.ndarray,      # [C]
    weights: Optional[torch.Tensor] = None,   # [C, Bp, L] f32
    weighted_cols=None,             # scalar or [C] bool
    vocab_caps: Optional[np.ndarray] = None,  # [C] last valid row
):
    """(rows [N] int64, contributions [N, d] f32) of the valid slots in
    [C, Bp, L] order: each slot's clamped, offset row, and the pooled
    cotangent scaled as the combiner divided, times the slot's weight.
    The per-column arguments may be host arrays or device tensors."""
    dev = ids.device
    if vocab_caps is not None:
        ids = torch.minimum(
            ids, as_device(vocab_caps, torch.int32, dev)[:, None, None]
        )
    mask = ids >= 0
    w = mask.to(torch.float32) if weights is None else weights * mask
    dacc = combiner_cotangent(g, ids, combiner_code, weights, weighted_cols)
    contrib = dacc[:, :, None, :] * w[:, :, :, None]         # [C, Bp, L, d]
    offs = as_device(row_offsets, torch.int64, dev)[:, None, None]
    return (ids.long() + offs)[mask], contrib[mask]


def group_pooled_grad_plain(
    g: torch.Tensor,                # [Bp, C, d] cotangent of the pooled
    num_rows: int,                  # R, the stacked table's rows
    ids: torch.Tensor,              # [C, Bp, L] int32, -1 = missing/pad
    row_offsets: np.ndarray,        # [C]
    combiner_code: np.ndarray,      # [C]
    weights: Optional[torch.Tensor] = None,   # [C, Bp, L] f32
    weighted_cols=None,             # scalar or [C] bool
    vocab_caps: Optional[np.ndarray] = None,  # [C] last valid row
) -> torch.Tensor:
    """The plain PyTorch version of X1b: ``slot_contributions``, then
    ``index_add_`` into a zero [R, d] in their [C, Bp, L] order (exact on
    the CPU; atomics on CUDA)."""
    rows, contrib = slot_contributions(g, ids, row_offsets, combiner_code,
                                       weights, weighted_cols, vocab_caps)
    out = torch.zeros((num_rows, g.shape[2]), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, rows, contrib)




# The host side of kernel X1b's launch (csrc/pooled_gather_grad.cu): one
# launch serves up to X1B_MAX_GROUPS groups, each described by one
# X1B_DESC record (the kernel's struct X1bGroup, field for field) and one
# X1B_LISTS record (struct X1bLists: the group's item lists, which one
# partition launch writes first, ops/item_lists.py), and a device array of
# work items, a block each, that cut every group's rows (x1b_plan).  The
# kernel's constants: a dense tile or a sparse window sums at most
# X1B_MAX_KEYS rows and X1B_ACC_FLOATS floats in shared memory, and a
# sparse item spans at most X1B_RANGE_ROWS rows (its bitmap).
X1B_MAX_GROUPS = 8
X1B_DESC = struct.Struct("<7Q5q")
# slot, val, off, S, nseg, member info
X1B_LISTS = struct.Struct("<3Q2qQ")
X1B_MAX_KEYS = 512
X1B_ACC_FLOATS = 4096
X1B_RANGE_ROWS = 32768
# a member takes dense tiles when its rows are at most this many a slot
# (the all-to-all exchange's receive buffer, most of whose rows the pool
# reads): sparse ranges would be crowded past their windows
X1B_DENSE_ROWS_PER_SLOT = 4
# what rt_pooled_gather_grad_limits reports, in its order (32: the bytes
# of a work item, the kernel's struct Work)
X1B_LIMITS = (X1B_MAX_GROUPS, X1B_MAX_KEYS, X1B_ACC_FLOATS, X1B_RANGE_ROWS,
              X1B_DESC.size, 32, X1B_LISTS.size)


def x1b_tile_rows(d: int) -> int:
    """Rows of a dense tile (and the touched rows of a sparse window) at
    row length d: as many as the shared sums hold."""
    return min(X1B_MAX_KEYS, X1B_ACC_FLOATS // d)


def x1b_sparse(extent: int, d: int, slots: int) -> bool:
    """Whether a member of ``extent`` rows and ``slots`` slots takes sparse
    ranges (a large vocab) rather than dense tiles: its rows outnumber one
    range's bitmap, a window holds a bitmap word's 32 rows, and its rows
    are more than X1B_DENSE_ROWS_PER_SLOT a slot."""
    return (extent > X1B_RANGE_ROWS and x1b_tile_rows(d) >= 32 and
            extent > X1B_DENSE_ROWS_PER_SLOT * slots)


def x1b_range_rows(extent: int, d: int, slots: int) -> int:
    """Rows of each sparse range of a member of ``extent`` rows: the largest
    power of two, at most X1B_RANGE_ROWS and at least 32, whose share of
    the member's ``slots`` (spread evenly) fills at most one window of
    ``x1b_tile_rows(d)`` touched rows, so that a range is seldom crowded
    (a crowded range sums window by window, each window a pass over the
    range's slots)."""
    rows = 32
    while (rows < X1B_RANGE_ROWS and
           2 * rows * slots <= x1b_tile_rows(d) * extent):
        rows *= 2
    return rows


def _x1b_members(num_rows: int, d: int, row_offsets, vocab_caps,
                 slots: int):
    """[(member, first row, rows, item rows, sparse)] in row order (item
    rows: a dense tile's, or a sparse range's, ``x1b_range_rows``), and
    the rows each member owns checked (ValueError where two overlap or one
    runs past R)."""
    offs = np.asarray(row_offsets, np.int64).reshape(-1)
    c = offs.size
    caps = (np.full(c, np.iinfo(np.int32).max, np.int64) if vocab_caps is None
            else np.asarray(vocab_caps, np.int64).reshape(-1))
    if caps.size != c:
        raise ValueError(f"vocab_caps must have {c} entries, got {caps.size}")
    order = np.argsort(offs, kind="stable")
    out = []
    row = 0
    for k, m in enumerate(order):
        lo = int(offs[m])
        end = int(offs[order[k + 1]]) if k + 1 < c else num_rows
        if lo < row or lo > num_rows:
            raise ValueError(
                f"X1b: member {m}'s rows start at {lo}, inside another "
                f"member's rows or past R = {num_rows}")
        extent = end - lo
        if extent == 0 and k + 1 < c:
            raise ValueError(
                f"X1b: members {m} and {order[k + 1]} share the rows from "
                f"{lo} (shared_rows_grad takes such a group)")
        if caps[m] < np.iinfo(np.int32).max:
            if caps[m] + 1 > extent:
                raise ValueError(
                    f"X1b: member {m}'s rows [{lo}, {lo + int(caps[m]) + 1})"
                    f" overlap the next member's or run past R = {num_rows}")
            extent = max(int(caps[m]) + 1, 0)
        sparse = x1b_sparse(extent, d, slots)
        unit = (x1b_range_rows(extent, d, slots) if sparse
                else x1b_tile_rows(d))
        out.append((int(m), lo, extent, unit, sparse))
        row = lo + extent
    return out


def x1b_plan(num_rows: int, d: int, row_offsets, vocab_caps,
             slots: int) -> np.ndarray:
    """X1b's work items for one group's [R, d] gradient: [n, 5] int64 rows
    (row_lo, local_lo, nrows, member, dense), every row of [0, R) in exactly
    one item.

    Member c owns its rows [row_offsets[c], row_offsets[c] + caps[c] + 1)
    (``vocab_caps`` None: up to the next member's offset, or R), where its
    clamped ids land; raises ValueError where two members' rows overlap or
    a member's run past R.  ``slots``: a member's slots (Bp x L).  A
    member with a small vocab, or with few rows a slot, takes dense tiles of
    ``x1b_tile_rows(d)`` rows; one with a large vocab (``x1b_sparse``)
    sparse ranges of ``x1b_range_rows`` rows; rows no member owns, zero
    items (member -1).  Dense items come first, then sparse, then zero
    ones."""
    dense, sparse, zero = [], [], []

    def zeros(lo, hi):
        for r in range(lo, hi, X1B_RANGE_ROWS):
            zero.append((r, 0, min(X1B_RANGE_ROWS, hi - r), -1, 0))

    row = 0
    for m, lo, extent, unit, is_sparse in _x1b_members(
            num_rows, d, row_offsets, vocab_caps, slots):
        zeros(row, lo)
        for r in range(0, extent, unit):
            (sparse if is_sparse else dense).append(
                (lo + r, r, min(unit, extent - r), m, int(not is_sparse)))
        row = lo + extent
    zeros(row, num_rows)
    items = dense + sparse + zero
    return np.asarray(items, np.int64).reshape(-1, 5)


def x1b_member_info(num_rows: int, d: int, row_offsets, vocab_caps,
                    slots: int) -> np.ndarray:
    """The partition's member rows of one group (ops/item_lists.py): each
    member's item rows (its dense tile or sparse range rows), its items as
    ``x1b_plan`` cuts them, and its rows (its ids' bound), in member
    order."""
    members = sorted(_x1b_members(num_rows, d, row_offsets, vocab_caps,
                                  slots))
    return item_lists.member_info(
        [u for _, _, _, u, _ in members],
        [-(-e // u) for _, _, e, u, _ in members],
        [e for _, _, e, _, _ in members])


@functools.lru_cache(maxsize=64)
def _x1b_plan_cached(num_rows, d, offs_bytes, caps_bytes, slots):
    offs = np.frombuffer(offs_bytes, np.int64)
    caps = None if caps_bytes is None else np.frombuffer(caps_bytes, np.int64)
    return x1b_plan(num_rows, d, offs, caps, slots)


@functools.lru_cache(maxsize=64)
def _x1b_info_cached(num_rows, d, offs_bytes, caps_bytes, slots):
    offs = np.frombuffer(offs_bytes, np.int64)
    caps = None if caps_bytes is None else np.frombuffer(caps_bytes, np.int64)
    return x1b_member_info(num_rows, d, offs, caps, slots)


def x1b_work(plans) -> np.ndarray:
    """One launch's work items, [n, 4] int64 (the kernel's struct Work):
    each group's plan (``plans``, in group order), packed as (row_lo,
    local_lo, nrows, ((member + 1) << 4) | (group << 1) | dense); all
    groups' sparse items first (long, bound by their writes), then dense,
    then zero ones, which fill the SMs that the last sparse items leave.
    (Dense items spread evenly among the sparse ones measured slower on an
    H100.)"""
    if not 1 <= len(plans) <= X1B_MAX_GROUPS:
        raise ValueError(f"1 to {X1B_MAX_GROUPS} groups per launch, got "
                         f"{len(plans)}")
    packed, cls = [], []
    for gi, p in enumerate(plans):
        kind = ((p[:, 3] + 1) << 4) | (gi << 1) | p[:, 4]
        packed.append(np.stack([p[:, 0], p[:, 1], p[:, 2], kind], axis=1))
        cls.append(np.where(p[:, 3] < 0, 2, p[:, 4]))   # sparse 0, dense 1
    packed = np.concatenate(packed).reshape(-1, 4)
    return packed[np.argsort(np.concatenate(cls), kind="stable")]


@functools.lru_cache(maxsize=64)
def _x1b_work_on(keys, device) -> torch.Tensor:
    """The work array of one launch on the card, made once per set of
    group plans (X1b's launch names it in ``kernels.launch``'s ``keep``,
    so that a captured graph holds it past its eviction)."""
    work = x1b_work([_x1b_plan_cached(*k) for k in keys])
    return torch.from_numpy(np.ascontiguousarray(work)).to(device)


_host_copies: dict = {}


def _host_array(x) -> Optional[np.ndarray]:
    """A per-column argument's values on the host.  A device tensor is
    copied once and the copy kept while the tensor lives and is not
    changed in place (its version counter), so a backward over the Engine's
    constants reads them from the card only the first time."""
    if x is None or not isinstance(x, torch.Tensor):
        return None if x is None else np.asarray(x)
    if x.device.type == "cpu":
        return x.numpy()
    try:
        version = x._version
    except RuntimeError:            # an inference tensor: not tracked
        return x.cpu().numpy()
    key = id(x)
    hit = _host_copies.get(key)
    if hit is not None and hit[0] == version:
        return hit[1]
    arr = x.cpu().numpy()
    if hit is None:
        weakref.finalize(x, _host_copies.pop, key, None)
    _host_copies[key] = (version, arr)
    return arr


@functools.lru_cache(maxsize=None)
def _x1b_library() -> None:
    """Load X1b's library and check, once, that its constants and record
    sizes are the ones this module plans with."""
    lib = kernels.library("pooled_gather_grad")
    got = (ctypes.c_int64 * len(X1B_LIMITS))()
    lib.rt_pooled_gather_grad_limits(got)
    for name, want, have in zip(
            ("groups", "keys", "acc floats", "range rows", "X1bGroup size",
             "Work size", "X1bLists size"), X1B_LIMITS, got):
        if want != have:
            raise RuntimeError(f"csrc/pooled_gather_grad.cu's {name} is "
                               f"{have}, ops/lookup_gather.py plans with "
                               f"{want}")


def _x1b_check(g, num_rows, ids, row_offsets, combiner_code, weights=None,
               weighted_cols=None, vocab_caps=None):
    """One group's arguments, checked: (g, batch stride) as the kernel
    reads it, and the rest as given."""
    from recom_tpu_torch.ops.lookup_onehot import cotangent_rows

    if ids.dtype != torch.int32 or ids.dim() != 3:
        raise ValueError(f"ids must be int32 [C, Bp, L], got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    c, bp, l = ids.shape
    d = g.shape[2] if g.dim() == 3 else -1
    g, gs = cotangent_rows(g, bp, c, d)
    if ids.device != g.device:
        raise ValueError(f"ids must be int32 on {g.device}")
    if weights is not None and (weights.dtype != torch.float32 or
                                tuple(weights.shape) != (c, bp, l) or
                                weights.device != g.device):
        raise ValueError(f"weights must be f32 {(c, bp, l)} on {g.device}")
    return (g, gs, int(num_rows), ids, row_offsets, combiner_code, weights,
            weighted_cols, vocab_caps)


def _x1b_key(num_rows, d, row_offsets, vocab_caps, slots):
    """A group's plan key: its rows, row length, host offsets and caps, and
    slots a member."""
    offs = np.ascontiguousarray(_host_array(row_offsets), np.int64)
    caps_h = _host_array(vocab_caps)
    return (num_rows, d, offs.tobytes(),
            None if caps_h is None else
            np.ascontiguousarray(caps_h, np.int64).tobytes(), slots)


def _x1b_entry(ids, caps, key) -> dict:
    """The partition's entry (ops/item_lists.py) of one group as X1b lists
    it: its contiguous ids as ``[C, Bp L]``, its caps on its device, and
    its member rows under its plan key ``key`` (``x1b_member_info``)."""
    return dict(ids=ids.view(ids.shape[0], -1), caps=caps,
                info=_x1b_info_cached(*key))


def x1b_partition_groups(groups):
    """The partition's entries that ``groups_pooled_grad`` lists for
    ``groups`` (its arguments), one a group, made as it makes them: to
    hold Part on its own to its plain version."""
    out = []
    for grp in groups:
        ids, _, caps, _, _, key = _x1b_columns(_x1b_check(*_one_column(grp)))
        out.append(_x1b_entry(ids, caps, key))
    return out


def _x1b_columns(gi_args):
    """One checked group's contiguous ids and weights, its per-column
    arguments on its device (caps, codes, wcols) and its plan key, with
    its row length and slots checked against the kernel's limits."""
    (g, _, num_rows, ids, row_offsets, combiner_code, weights,
     weighted_cols, vocab_caps) = gi_args
    c, bp, l = ids.shape
    d = g.shape[2]
    if d > X1B_ACC_FLOATS:
        raise ValueError(f"X1b takes rows of at most {X1B_ACC_FLOATS} "
                         f"floats, got d={d}")
    if bp * l >= 1 << 31:
        raise ValueError(f"X1b takes at most 2^31 - 1 slots a member, got "
                         f"{bp} x {l}")
    _, caps, codes, wcols = _column_args(c, g.device, row_offsets,
                                         combiner_code, weights,
                                         weighted_cols, vocab_caps)
    weights = None if weights is None else weights.contiguous()
    return (ids.contiguous(), weights, caps, codes, wcols,
            _x1b_key(num_rows, d, row_offsets, vocab_caps, bp * l))


def _x1b_group(gi_args, out=None):
    """One group's X1B_DESC record, its plan key, its output (``out``, or a
    new one), and the tensors its pointers refer to (g, ids, weights, caps,
    codes, wcols: held until the launch is queued)."""
    g, gs, num_rows = gi_args[:3]
    ids, weights, caps, codes, wcols, key = _x1b_columns(gi_args)
    c, bp, l = ids.shape
    d = g.shape[2]
    dev = g.device
    if out is None:
        out = torch.empty((num_rows, d), dtype=torch.float32, device=dev)
    elif (out.dtype != torch.float32 or tuple(out.shape) != (num_rows, d)
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous f32 {(num_rows, d)} on "
                         f"{dev}")
    desc = X1B_DESC.pack(
        g.data_ptr(), ids.data_ptr(),
        0 if weights is None else weights.data_ptr(), caps.data_ptr(),
        codes.data_ptr(), wcols.data_ptr(), out.data_ptr(), gs, c, bp, l, d,
    )
    return desc, key, out, (g, ids, weights, caps, codes, wcols)


@functools.lru_cache(maxsize=None)
def shared_rows_consts(c: int, device: str):
    """(zeros [c] int32, caps [c] int32 max, zeros [c] uint8) on
    ``device``, made once: the per-column arguments (row offsets and SUM
    codes; no clamp; the reciprocal flags) of a group whose columns all
    address one table's rows (the mesh roles: the psum path's partial
    sums, the exchange's pool, the owner's gather).  The same tensors every
    call, so X1b's plan and host copies are made once (``_host_array``)."""
    with torch.inference_mode(False):
        return (torch.zeros(c, dtype=torch.int32, device=device),
                torch.full((c,), np.iinfo(np.int32).max, dtype=torch.int32,
                           device=device),
                torch.zeros(c, dtype=torch.uint8, device=device))


def shares_rows(row_offsets, c: int) -> bool:
    """Whether two of a group's ``c`` columns start at one row: their rows
    are not disjoint, as X1b's plan needs them (``x1b_plan``)."""
    offs = _host_array(row_offsets)
    return c > 1 and np.unique(np.asarray(offs)).size < c


def shared_rows_ids(ids, row_offsets, vocab_caps=None) -> torch.Tensor:
    """``shared_rows_grad_args``' ids, ``[C, Bp, L]``: each id clamped to
    its cap and offset by its row offset (-1 stays)."""
    dev = ids.device
    c, bp, l = ids.shape
    if vocab_caps is not None:
        ids = torch.minimum(
            ids, as_device(vocab_caps, torch.int32, dev)[:, None, None])
    offs = as_device(row_offsets, torch.int32, dev)[:, None, None]
    return torch.where(ids >= 0, ids + offs, torch.full_like(ids, -1))


def shared_rows_grad_args(g, num_rows, ids, row_offsets, combiner_code,
                          weights=None, weighted_cols=None, vocab_caps=None):
    """The arguments of one group whose columns share rows, rewritten as
    one SUM column of the same gradient: each id clamped and offset in
    place (-1 stays), the ``[C, Bp, L]`` slots as ``[1, C * Bp, L]`` (so
    slot order is kept), and the cotangent scaled by the combiner first
    (``combiner_cotangent``), ``[C * Bp, 1, d]``.  X1b then sums each row
    in the same slot order, with the same rounded terms.  The column's
    rows are one member: dense tiles where they are few beside its slots
    (the all-to-all exchange's receive buffer, ``x1b_sparse``), else
    sparse ranges, each item reading only its own slots."""
    dev = ids.device
    c, bp, l = ids.shape
    ids = shared_rows_ids(ids, row_offsets, vocab_caps)
    dacc = combiner_cotangent(g, ids, _host_array(combiner_code), weights,
                              _weighted_mask(weighted_cols, weights, c))
    dacc = dacc.reshape(c * bp, 1, dacc.shape[2])
    ids = ids.reshape(1, c * bp, l)
    if weights is not None:
        weights = weights.reshape(1, c * bp, l)
    zero, no_cap, flags = shared_rows_consts(1, str(dev))
    return (dacc, num_rows, ids, zero, zero, weights, flags, no_cap)


def x1b_forward_entry(num_rows: int, d: int, ids, row_offsets,
                      vocab_caps=None) -> dict:
    """The partition's entry of one X1 group as its X1b will list it, made
    in the forward, before any cotangent (``groups_pooled``' ``lists``):
    the entry ``x1b_partition_groups`` makes from the same arguments."""
    c, bp, l = ids.shape
    if shares_rows(row_offsets, c):
        ids = shared_rows_ids(ids, row_offsets, vocab_caps).reshape(
            1, c * bp, l)
        row_offsets, vocab_caps, _ = shared_rows_consts(1, str(ids.device))
        c, bp = 1, c * bp
    # the caps X1b's call makes (``_column_args``), with no host copy: a
    # capture may be under way
    caps = (shared_rows_consts(c, str(ids.device))[1] if vocab_caps is None
            else as_device(vocab_caps, torch.int32, ids.device))
    return _x1b_entry(ids.contiguous(), caps,
                      _x1b_key(int(num_rows), int(d), row_offsets,
                               vocab_caps, bp * l))


def _one_column(grp):
    """A group's arguments, as one SUM column where its columns share rows
    (``shared_rows_grad_args``)."""
    if shares_rows(grp[3], grp[2].shape[0]):
        return shared_rows_grad_args(*grp)
    return grp


def groups_pooled_grad(groups, out=None, lists=None) -> List[torch.Tensor]:
    """d(table) [R, d] f32 of several groups: one argument tuple of
    ``group_pooled_grad`` per group, (g, num_rows, ids, row_offsets,
    combiner_code[, weights, weighted_cols, vocab_caps]), all on one
    device.  CPU tensors take the plain version; on CUDA one launch of
    kernel X1b serves up to X1B_MAX_GROUPS groups, with no sort and no fill:
    the kernel writes every element once, into ``out`` (one [R, d] tensor a
    group) where given.  A group whose columns share rows (``shares_rows``)
    is taken as one SUM column (``shared_rows_grad_args``).  ``lists``:
    one entry a group, the (slot, val, off) that Part already wrote for its
    ``x1b_forward_entry`` (the forward's launch) or None; Part then lists
    only the groups left without."""
    checked = [_x1b_check(*_one_column(grp)) for grp in groups]
    lists = [None] * len(checked) if lists is None else list(lists)
    if not checked:
        return []
    dev = checked[0][0].device
    if any(a[0].device != dev for a in checked):
        raise ValueError("groups on more than one device")
    if dev.type == "cpu":
        got = [group_pooled_grad_plain(a[0], *a[2:]) for a in checked]
        if out is not None:
            for o, x in zip(out, got):
                o.copy_(x)
            return list(out)
        return got
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _x1b_library()
    outs = []
    for i in range(0, len(checked), X1B_MAX_GROUPS):
        made = [_x1b_group(a, None if out is None else out[i + k])
                for k, a in enumerate(checked[i: i + X1B_MAX_GROUPS])]
        work = _x1b_work_on(tuple(k for _, k, _, _ in made), dev)
        # each group's slots listed by work item (one launch of Part for
        # the groups the forward did not list)
        entries = [_x1b_entry(keep[1], keep[3], key)
                   for _, key, _, keep in made]
        given = lists[i: i + X1B_MAX_GROUPS]
        todo = [e for e, got in zip(entries, given) if got is None]
        fresh = iter(item_lists.partition(todo))
        # held until X1b is queued
        parts = [next(fresh) if got is None else got for got in given]
        infos = [item_lists.info_on(e["info"], dev) for e in entries]
        packed = b"".join(X1B_LISTS.pack(
            slot.data_ptr(), val.data_ptr(), off.data_ptr(), slot.shape[1],
            item_lists.segments(slot.shape[1]), info.data_ptr())
            for (slot, val, off), info in zip(parts, infos))
        kernels.launch("X1b", b"".join(m[0] for m in made), len(made), packed,
                       work.data_ptr(), work.shape[0],
                       kernels.stream_of(checked[i][0]),
                       keep=[work] + infos)
        outs += [o for _, _, o, _ in made]
    return outs


def group_pooled_grad(
    g: torch.Tensor,
    num_rows: int,
    ids: torch.Tensor,
    row_offsets,
    combiner_code,
    weights: Optional[torch.Tensor] = None,
    weighted_cols=None,
    vocab_caps=None,
) -> torch.Tensor:
    """d(table) [R, d] f32 of ``group_pooled(table, ids, row_offsets,
    combiner_code, weights, weighted_cols, vocab_caps)`` for the cotangent
    g [Bp, C, d]: dense, as the reference's cotangent is, with +0.0 in
    every row no slot touches.  CPU tensors take the plain version; CUDA
    tensors launch kernel X1b (``groups_pooled_grad``)."""
    return groups_pooled_grad([(g, num_rows, ids, row_offsets, combiner_code,
                                weights, weighted_cols, vocab_caps)])[0]


class _GroupsPooled(torch.autograd.Function):
    """X1 forward and X1b backward, each one launch for every group (the
    backward skips groups whose table needs no gradient).  Saves the
    groups' ids, weights and per-column arguments, not their outputs;
    where ``lists`` is given, each group that needs a gradient registers
    its partition entry there (a ``StepLists`` of its own where none is
    given), for the step's one launch of Part."""

    @staticmethod
    def forward(ctx, groups, lists, *tables):
        ctx.groups = [(t.shape[0],) + tuple(grp[1:])
                      for t, grp in zip(tables, groups)]
        ctx.lists = item_lists.StepLists() if lists is None else lists
        ctx.keys = {k: ctx.lists.add(x1b_forward_entry(
            t.shape[0], t.shape[1], grp[1], grp[2],
            grp[6] if len(grp) > 6 else None))
            for k, (t, grp) in enumerate(zip(tables, groups))
            if isinstance(t, torch.Tensor) and t.requires_grad}
        return tuple(_groups_pooled(groups))

    @staticmethod
    def backward(ctx, *grads):
        need = [i for i, gr in enumerate(grads)
                if ctx.needs_input_grad[2 + i] and gr is not None]
        args = [(grads[i],) + ctx.groups[i] for i in need]
        got = groups_pooled_grad(args, lists=[
            ctx.lists.get(ctx.keys.get(i)) for i in need])
        out = [None] * (2 + len(grads))
        for i, gr in zip(need, got):
            out[2 + i] = gr
        return tuple(out)
