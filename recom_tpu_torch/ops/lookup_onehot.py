"""K1: one-id lookup of a uniform-vocab column group (the port of
recom_tpu/ops/lookup_pallas.py's forward: ``_kernel`` through
``_onehot_lookup_impl``/``onehot_lookup``, wrapped by
``group_pooled_onehot``), and K2: the same lookup fused with the bucketize
of raw floats (the port of ``_bz_kernel`` through
``_onehot_bucketize_impl``/``onehot_bucketize_lookup``, with its interval
arrays from ``bucket_bounds``).

The TPU kernel one-hot-multiplies vocab tiles on the MXU.  On Hopper the
same function is a row gather: the group's ``[C_pad, V_pad, d]`` table
(model E: 3.8 MB) sits in L2 and the kernel is bound by writing its
``[Bp, C, d]`` output (csrc/onehot_lookup.cu says how it is built).

Layout: ids arrive in the host's column-major ``[C, Bp]`` form and the
result leaves batch-major ``[Bp, C, d]``, so the reference's pad, its two
transposes and its one-id combiner fold into the one launch, as does the
serving clamp to each member's ``vocab_caps``.  Forward only: the
scatter-add gradient (K3) comes with training.

K2 takes raw ``[C, Bp]`` f32 values instead of ids: bucket v of column c is
the interval ``lo[c, v] <= x < hi[c, v]``, and NaN and +inf select bucket
``counts[c]``.  On Hopper that is a binary search and the same row copy
(csrc/onehot_bucketize.cu); its result leaves batch-major ``[Bp, C, d]``
too, which folds in the reference's ``rows[:num_columns]`` slice and
transpose.
"""

from __future__ import annotations

import numpy as np
import torch

from recom_tpu_torch.ops import kernels


def _check(table3, ids, caps):
    if table3.dtype != torch.float32 or table3.dim() != 3:
        raise ValueError(f"table3 must be f32 [C_pad, V_pad, d], got "
                         f"{table3.dtype} {tuple(table3.shape)}")
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
    """The plain PyTorch version of K1: same function, torch ops."""
    c = ids.shape[0]
    ids = torch.minimum(ids, caps[:, None])
    valid = ids >= 0
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    cols = torch.arange(c, device=ids.device)[:, None]
    rows = table3[cols, safe]                              # [C, Bp, d]
    rows = torch.where(valid[:, :, None], rows, torch.zeros_like(rows))
    return rows.transpose(0, 1).contiguous()               # [Bp, C, d]


def onehot_lookup(table3: torch.Tensor, ids: torch.Tensor,
                  caps: torch.Tensor) -> torch.Tensor:
    """rows [Bp, C, d] f32: ``table3[c, min(ids[c, b], caps[c])]`` for ids
    >= 0, else 0.

    table3: [C_pad, V_pad, d] f32 (zero-padded planes); ids: [C, Bp] int32
    local ids, < 0 = missing; caps: [C] int32 last valid row per column.
    CPU tensors take the plain version; CUDA tensors launch kernel K1."""
    _check(table3, ids, caps)
    if table3.device.type == "cpu":
        return onehot_lookup_plain(table3, ids, caps)
    if table3.device.type != "cuda":
        raise ValueError(f"unsupported device {table3.device}")
    c, bp = ids.shape
    v, d = table3.shape[1], table3.shape[2]
    out = torch.empty((bp, c, d), dtype=torch.float32, device=table3.device)
    kernels.launch(
        "onehot_lookup",
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
    if table3.dtype != torch.float32 or table3.dim() != 3:
        raise ValueError(f"table3 must be f32 [C_pad, V_pad, d], got "
                         f"{table3.dtype} {tuple(table3.shape)}")
    if raw.dtype != torch.float32 or raw.dim() != 2:
        raise ValueError(f"raw must be f32 [C, Bp], got {raw.dtype} "
                         f"{tuple(raw.shape)}")
    c_pad, v = table3.shape[0], table3.shape[1]
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
    for name, t in (("table3", table3), ("raw", raw), ("lo", lo),
                    ("hi", hi), ("counts", counts)):
        if t.device != table3.device:
            raise ValueError(f"{name} on {t.device}, table3 on {table3.device}")
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
    rows = table3[cols, ids]                               # [C, Bp, d]
    rows = torch.where(onehot.any(dim=2)[:, :, None], rows,
                       torch.zeros_like(rows))
    return rows.transpose(0, 1).contiguous()               # [Bp, C, d]


def onehot_bucketize_lookup(table3: torch.Tensor, raw: torch.Tensor,
                            lo: torch.Tensor, hi: torch.Tensor,
                            counts: torch.Tensor) -> torch.Tensor:
    """rows [Bp, C, d] f32: ``table3[c, bucket(raw[c, b])]``, the bucket
    being the count of column c's boundaries <= x (NaN and +inf: all of
    them).

    table3: [C_pad, V_pad, d] f32; raw: [C, Bp] f32, column-major as the
    host staged it (C <= C_pad: padded planes are never read); lo, hi,
    counts: ``bucket_bounds(boundary_matrix, boundary_counts, V_pad,
    C_pad)`` on table3's device.  CPU tensors take the plain version; CUDA
    tensors launch kernel K2."""
    _check_bz(table3, raw, lo, hi, counts)
    if table3.device.type == "cpu":
        return onehot_bucketize_lookup_plain(table3, raw, lo, hi, counts)
    if table3.device.type != "cuda":
        raise ValueError(f"unsupported device {table3.device}")
    c, bp = raw.shape
    v, d = table3.shape[1], table3.shape[2]
    out = torch.empty((bp, c, d), dtype=torch.float32, device=table3.device)
    kernels.launch(
        "onehot_bucketize",
        kernels.ptr(table3), kernels.ptr(raw), kernels.ptr(hi),
        kernels.ptr(counts), kernels.ptr(out), c, bp, v, d,
        kernels.stream_of(table3),
    )
    return out
