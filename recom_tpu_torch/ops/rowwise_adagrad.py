"""O1: row-wise AdaGrad (recom_tpu/train.py::rowwise_adagrad) on the leaves
of a param group, writing only the rows a step touched.

The rule, each operation a separate f32 rounding in this order: for a 2-D
leaf p ``[R, d]`` with one accumulator a row, ``acc += mean(g * g, 1)``,
``s = rsqrt(acc + eps)``, ``p += (-lr * g) * s[:, None]``; for any other
rank the same per element, with ``acc`` of the leaf's shape.

``rowwise_adagrad_plain`` is that formula as dense torch ops over every
row, the optimizer's step on the CPU.  ``update`` takes several leaves at
once: CPU tensors take the plain version one leaf at a time, CUDA tensors
launch kernel O1 (csrc/rowwise_adagrad.cu) once for up to
``O1_MAX_LEAVES`` leaves.  The kernel skips every row whose gradient is
+0.0 in every element, which the dense formula leaves as it was, bit for
bit; so on the card only the rows a step touched are read and written
beside the gradient.  It adds the rows it updates and the rows it sees to
an int64 ``[2]`` counter on the card, where given.
"""

from __future__ import annotations

import functools
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from recom_tpu_torch.ops import kernels

# one O1_DESC record a leaf (the kernel's struct O1Leaf, field for field):
# p, g, acc, rows, d, first chunk, rows a chunk, the mean's factor, kind,
# lanes a row, padding
O1_DESC = struct.Struct("<3Q4qf3i")
O1_MAX_LEAVES = 32
# rows a lane group of a 16-byte-lane leaf keeps in flight (a chunk is this
# many passes of a warp)
O1_UNROLL = 4
O1_ELEMENTWISE = 1
O1_VECTOR = 2
# the widths whose rows are d / 4 lanes of 16 bytes
O1_VECTOR_D = (4, 8, 16, 32, 64, 128)
# what rt_rowwise_adagrad_limits reports, in its order
O1_LIMITS = (O1_MAX_LEAVES, O1_DESC.size, O1_UNROLL)


def rowwise_adagrad_plain(p: torch.Tensor, g: torch.Tensor,
                          acc: torch.Tensor, lr: float, eps: float) -> None:
    """One dense step of row-wise AdaGrad on one leaf, ``p`` and ``acc``
    written in place: every row, touched or not."""
    if p.dim() == 2:
        acc.add_((g * g).mean(dim=1))
        s = torch.rsqrt(acc + eps)[:, None]
    else:
        acc.add_(g * g)
        s = torch.rsqrt(acc + eps)
    upd = -lr * g
    upd.mul_(s)
    p.add_(upd)


def aten_lanes(d: int) -> int:
    """The lanes ATen's reduction gives a row of ``d`` floats (a power of
    two, at most a warp): the order of the kernel's row sums."""
    return min(1 << (d.bit_length() - 1), 32)


def o1_leaf(p: torch.Tensor, g: torch.Tensor, acc: torch.Tensor,
            chunk0: int) -> Tuple[bytes, int]:
    """One non-empty leaf's O1_DESC record, its chunks numbered from
    ``chunk0``, and its number of chunks.  Checks that p, g and acc are
    contiguous f32 on one device, g of p's shape, and acc ``[R]`` for a 2-D
    p (one accumulator a row), else of p's shape (elementwise)."""
    for name, t in (("p", p), ("g", g), ("acc", acc)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"O1 takes contiguous f32 tensors; {name} is "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
        if t.device != p.device:
            raise ValueError(f"O1: {name} is on {t.device}, p on {p.device}")
    if g.shape != p.shape:
        raise ValueError(f"O1: g {tuple(g.shape)} is not of p's shape "
                         f"{tuple(p.shape)}")
    rowwise = p.dim() == 2
    want = tuple(p.shape[:1]) if rowwise else tuple(p.shape)
    if tuple(acc.shape) != want:
        raise ValueError(f"O1: acc {tuple(acc.shape)} for p {tuple(p.shape)}"
                         f" must be {want} ("
                         + ("one a row)" if rowwise else "elementwise)"))
    d = int(p.shape[-1]) if p.dim() else 1
    rows = p.numel() // d
    aligned = all(t.data_ptr() % 16 == 0
                  for t in ((p, g) if rowwise else (p, g, acc)))
    vector = d in O1_VECTOR_D and aligned
    lanes = d // 4 if vector else aten_lanes(d)
    chunk_rows = (O1_UNROLL if vector else 1) * (32 // lanes)
    # ATen's mean multiplies the sum by float(R) / float(R d)
    factor = (np.float32(rows) / np.float32(rows * d) if rowwise
              else np.float32(1))
    kind = (0 if rowwise else O1_ELEMENTWISE) | (O1_VECTOR if vector else 0)
    desc = O1_DESC.pack(p.data_ptr(), g.data_ptr(), acc.data_ptr(), rows, d,
                        chunk0, chunk_rows, float(factor), kind, lanes, 0)
    return desc, -(-rows // chunk_rows)


def o1_launches(leaves: Sequence) -> List[Tuple[bytes, int, int]]:
    """The launches of O1 for ``leaves`` ((p, g, acc) each; empty leaves
    left out): (records, leaves, chunks) for each run of up to
    O1_MAX_LEAVES leaves."""
    out = []
    full = [leaf for leaf in leaves if leaf[0].numel()]
    for i in range(0, len(full), O1_MAX_LEAVES):
        recs, chunks = [], 0
        for p, g, acc in full[i: i + O1_MAX_LEAVES]:
            desc, n = o1_leaf(p, g, acc, chunks)
            recs.append(desc)
            chunks += n
        out.append((b"".join(recs), len(recs), chunks))
    return out


@functools.lru_cache(maxsize=None)
def _o1_library() -> None:
    """Load O1's library and check, once, that its constants and record
    size are the ones this module plans with."""
    import ctypes

    lib = kernels.library("rowwise_adagrad")
    got = (ctypes.c_int64 * len(O1_LIMITS))()
    lib.rt_rowwise_adagrad_limits(got)
    for name, want, have in zip(("leaves", "O1Leaf size", "unroll"),
                                O1_LIMITS, got):
        if want != have:
            raise RuntimeError(f"csrc/rowwise_adagrad.cu's {name} is {have},"
                               f" ops/rowwise_adagrad.py plans with {want}")


def update(leaves: Sequence, lr: float, eps: float,
           counts: Optional[torch.Tensor] = None) -> None:
    """One row-wise AdaGrad step of every leaf in ``leaves`` ((p, g, acc)
    each, p and acc written in place), all on one device.  On the CPU the
    plain version, leaf by leaf; on CUDA one launch of O1 for up to
    O1_MAX_LEAVES leaves, on the current stream, which skips the rows
    whose gradient is +0.0 throughout and adds to ``counts`` (int64 ``[2]``
    on the card, or None) the rows it updated and the rows it saw.
    Raises before launching on a leaf it does not take (``o1_leaf``)."""
    leaves = list(leaves)
    if not leaves:
        return
    dev = leaves[0][0].device
    if any(p.device != dev for p, _, _ in leaves):
        raise ValueError("O1: leaves on more than one device")
    if dev.type == "cpu":
        for p, g, acc in leaves:
            rowwise_adagrad_plain(p, g, acc, lr, eps)
        return
    if dev.type != "cuda":
        raise ValueError(f"O1: unsupported device {dev}")
    if counts is not None and (counts.dtype != torch.int64
                               or tuple(counts.shape) != (2,)
                               or counts.device != dev):
        raise ValueError(f"O1: counts must be int64 [2] on {dev}")
    launches = o1_launches(leaves)
    _o1_library()
    stream = kernels.stream_of(leaves[0][0])
    for recs, n, chunks in launches:
        kernels.launch("O1", recs, n, chunks, float(np.float32(-lr)),
                       float(np.float32(eps)),
                       None if counts is None else counts.data_ptr(), stream)
