"""Row-sharded embedding lookup over a mesh of ranks: the striped layout
and the psum path.

The port of recom_tpu/parallel/sharded_lookup.py.  A group whose stacked
rows exceed ``EngineConfig.shard_rows_above`` is striped over the mesh's
"model" axis: logical row ``r`` lives on model rank ``r % m`` at local row
``r // m`` (``stripe_rows``), so members of very different vocab sizes
spread evenly.  The psum path looks it up as:

    ids of the rank's data slice (the same on every model rank)
      -> ids another model rank owns masked to -1
      -> X1 (``lookup_gather.group_pooled``) pools the local stripe with
         every combiner set to SUM: partial sums
      -> all_reduce over the model subgroup
      -> the combiner divisors (``lookup_gather.apply_combiner_divisors``),
         from the ids and weights every model rank holds

Under autograd (training) the all_reduce is ``mesh.psum``, whose
backward is the identity (the summed result is the same on every model
rank, and so is its cotangent); X1b takes the partial sums' backward on
the stripe; the divisors back through torch.

The all_reduce adds the ranks' partial sums, so where a bag's ids lie on
several ranks the result may differ from the single-device left-to-right
sum in the last ulps: within 1e-6, as the JAX package promises
(sharded_lookup.py:19-24), and exact where each bag's ids lie on one rank.

``pad_rows_to_multiple``, ``stripe_rows`` and ``unstripe_rows`` are copied
from recom_tpu/parallel/sharded_lookup.py:40-76.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from recom_tpu_torch.ops.lookup_gather import (
    apply_combiner_divisors,
    as_device,
    group_pooled,
    shared_rows_consts,
)
from recom_tpu_torch.parallel.mesh import psum


# Copied from recom_tpu/parallel/sharded_lookup.py:40-50.
def pad_rows_to_multiple(table: np.ndarray, multiple: int) -> np.ndarray:
    """Pad stacked table rows so they divide evenly across shards (pad rows
    are never addressed: ids always target real rows)."""
    r = table.shape[0]
    pad = (-r) % multiple
    if pad == 0:
        return table
    return np.concatenate(
        [table, np.zeros((pad,) + table.shape[1:], table.dtype)], axis=0
    )


# Copied from recom_tpu/parallel/sharded_lookup.py:53-66.
def stripe_rows(table: np.ndarray, m: int) -> np.ndarray:
    """Logical -> striped physical layout: logical row r lives on shard
    r % m at local index r // m (physical[(r % m) * (R/m) + r // m] =
    logical[r]).  Striping load-balances a stacked group whose members have
    very different vocab sizes — with contiguous blocks, a small table's
    rows land entirely on one shard and every batch's ids for that column
    hammer it (the skew that overflows all-to-all capacity and serializes
    the psum path's gathers).  Works on [R, ...] arrays (row vectors and
    per-row scale vectors alike)."""
    r = table.shape[0]
    rest = table.shape[1:]
    assert r % m == 0
    return np.moveaxis(
        table.reshape((r // m, m) + rest), 1, 0
    ).reshape((r,) + rest)


# Copied from recom_tpu/parallel/sharded_lookup.py:69-76.
def unstripe_rows(table: np.ndarray, m: int) -> np.ndarray:
    """Inverse of stripe_rows (physical -> logical), for checkpoint export."""
    r = table.shape[0]
    rest = table.shape[1:]
    assert r % m == 0
    return np.moveaxis(
        table.reshape((m, r // m) + rest), 0, 1
    ).reshape((r,) + rest)


def stripe_rows_of(rows: int, m: int) -> int:
    """The rows each of ``m`` model ranks holds of a striped group of
    ``rows`` logical rows (padded to a multiple of m)."""
    return -(-rows // m)


def member_stripe(n_rows: int, row_offset: int, m: int,
                  k: int) -> Tuple[int, int, int]:
    """Where a member's rows fall on model rank ``k``'s stripe: the member's
    rows ``first, first + m, ...`` (``count`` of them), whose stacked rows
    ``row_offset + first + j * m`` are the stripe's rows ``start + j``."""
    first = (k - row_offset) % m
    count = max(0, -(-(n_rows - first) // m))
    return first, count, (row_offset + first) // m


def owned_ids(ids: torch.Tensor, row_offsets, m: int, k: int,
              vocab_caps=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(local ids [C, b, L] int32, valid [C, b, L] bool): each id clamped
    to its column's cap and offset to its stacked row, then its row on
    model rank ``k``'s stripe where rank ``k`` owns it, else -1; ``valid``
    marks the ids >= 0."""
    dev = ids.device
    if vocab_caps is not None:
        ids = torch.minimum(
            ids, as_device(vocab_caps, torch.int32, dev)[:, None, None])
    valid = ids >= 0
    offs = as_device(row_offsets, torch.int64, dev)[:, None, None]
    gids = torch.where(valid, ids, torch.zeros_like(ids)).long() + offs
    mine = valid & (gids % m == k)
    local = torch.where(mine, gids // m, torch.full_like(gids, -1))
    return local.to(torch.int32), valid


def psum_divisors(total: torch.Tensor, valid: torch.Tensor,
                  weights: Optional[torch.Tensor], combiner_code,
                  weighted_cols) -> torch.Tensor:
    """The combiner divisors applied to the summed pooled rows ``total``
    [b, C, d], from the bags' ids (``valid`` [C, b, L]) and weights: the
    weight sums taken left to right, as the single-device pooling takes
    them.  Returns [b, C, d]."""
    combiner_code = np.asarray(combiner_code)
    if not ((combiner_code == 1) | (combiner_code == 2)).any():
        return total
    w = valid.to(torch.float32) if weights is None else weights * valid
    wsum = w[:, :, 0] * 0.0
    w2sum = w[:, :, 0] * 0.0
    for l in range(w.shape[2]):
        wl = w[:, :, l]
        wsum = wsum + wl
        w2sum = w2sum + wl * wl
    weighted = (weights is not None) if weighted_cols is None \
        else weighted_cols
    if isinstance(weighted, torch.Tensor):
        weighted = weighted.cpu().numpy().astype(bool)
    out = apply_combiner_divisors(total.transpose(0, 1), wsum, w2sum,
                                  combiner_code, weighted)
    return out.transpose(0, 1).contiguous()


def psum_partial_args(table, ids: torch.Tensor, row_offsets, m: int, k: int,
                      weights: Optional[torch.Tensor] = None,
                      vocab_caps=None):
    """(``group_pooled`` arguments of model rank ``k``'s partial sums,
    valid [C, b, L]): the owned ids on the local stripe, offsets 0, every
    combiner SUM, no clamp (``shared_rows_consts``: no host copy).  The
    Engine launches them in one X1 launch with its other gather groups.
    Under autograd their backward is X1b on the stripe (its columns share
    the stripe's rows: ``groups_pooled_grad`` takes them as one column),
    where an id another rank owns, masked, adds nothing."""
    local, valid = owned_ids(ids, row_offsets, m, k, vocab_caps)
    zeros, no_cap, flags = shared_rows_consts(ids.shape[0], str(ids.device))
    return (table, local, zeros, zeros,
            None if weights is None else weights.contiguous(),
            flags, no_cap), valid


def sharded_group_pooled(
    mesh,
    table,                       # this rank's stripe [R_pad / m, d]
    ids: torch.Tensor,           # [C, b, L] int32 of the rank's data slice
    row_offsets,                 # [C]
    combiner_code,               # [C] 0 sum / 1 mean / 2 sqrtn
    weights: Optional[torch.Tensor] = None,    # [C, b, L] f32
    weighted_cols=None,
    vocab_caps=None,
    model_axis: str = "model",
) -> torch.Tensor:
    """The psum path (see the module docstring): the pooled [b, C, d] f32
    of the rank's data slice, the same on every model rank.  ``table`` is
    f32, bf16 or an int8 ``QuantizedTable`` (stripes of rows and of
    scales); ids past ``vocab_caps`` clamp to it."""
    m = mesh.shape[model_axis]
    k = mesh.axis_index(model_axis)
    args, valid = psum_partial_args(table, ids, row_offsets, m, k, weights,
                                    vocab_caps)
    total = psum(mesh, group_pooled(*args), model_axis)
    return psum_divisors(total, valid, weights, combiner_code, weighted_cols)
