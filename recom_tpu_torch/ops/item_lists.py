"""Part: the partition pass that lists each work item's own entries for the
backward kernels X1b (ops/lookup_gather.py), K3a and K3b
(ops/lookup_onehot.py), so that each item reads only those
(csrc/partition.cu, csrc/item_lists.cuh).

A group of ``C`` members holds ``[C, S]`` entries: X1b's slots (a member's
``Bp x L`` ids), K3a's ids or K3b's raw values (a column's ``Bp`` batch
rows).  An entry's value is its id clamped to the member's cap (K3a, X1b)
or its bucket (K3b, K2's search); the member's info row ``(unit, items,
lim, ibase)`` gives its item, ``value // unit`` for ``0 <= value < lim``
and an item below ``items`` (no item otherwise: the entry is dropped),
and its first row of ``off``.

Layout: each member's entries are cut into segments of PART_SEG; the
region of segment ``s`` of member ``c`` in ``slot`` and ``val`` ([C, S]
int32) holds the segment's entries that have an item, ordered by item and
within an item by entry index (a stable sort), then -1 for the rest;
``slot`` is the member-local entry index, ``val`` the value.  ``off``
(flat int32, nseg x the sum over members of (items + 1)): member ``c``'s
offsets are ``nseg`` rows of ``items + 1`` from ``ibase * nseg`` on
(``off_at``), and word ``i`` of row ``s`` is item ``i``'s first place in
segment ``s``'s region, word ``items`` the segment's count of placed
entries, so the kernel's block of a segment writes its row contiguously.
Integers only: the kernel and ``partition_plain`` agree with ``==``.

Every size is fixed by the host plan (``S``, each member's items), and the
pass reads no count back to the host, so it captures into a CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from recom_tpu_torch.ops import kernels

PART_SEG = 2048          # entries of a segment, a block of the kernel
PART_MAX_GROUPS = 16     # groups a launch
PART_MAX_BINS = 4096     # items a counting-sort pass orders (12 bits)
PART_WIN = 256           # segments a consumer maps at once
# the kernel's struct PartGroup, field for field: ids, raw, caps, hi,
# counts, minfo, slot, val, off; S, C, nseg, V, half, kind, block_begin
PART_DESC = struct.Struct("<9Q7q")
# what rt_partition_limits reports, in its order
PART_LIMITS = (PART_MAX_GROUPS, PART_SEG, PART_MAX_BINS, PART_WIN,
               PART_DESC.size)


def segments(s: int) -> int:
    """The segments of a member of ``s`` entries (at least one, so that an
    empty member's offsets are written too)."""
    return max(1, -(-int(s) // PART_SEG))


def member_info(units, items, lims) -> np.ndarray:
    """[C, 4] int32 rows (unit, items, lim, ibase): each member's item
    rows, its items, the bound of its values, and its first row of
    ``off`` (the items + 1 of the members before it)."""
    units = np.asarray(units, np.int64).reshape(-1)
    items = np.asarray(items, np.int64).reshape(-1)
    lims = np.asarray(lims, np.int64).reshape(-1)
    if (units < 1).any() or (items < 0).any():
        raise ValueError("a member needs units >= 1 and items >= 0")
    ibase = np.concatenate([[0], np.cumsum(items + 1)[:-1]])
    info = np.stack([units, items, lims, ibase], axis=1)
    if info.size and (info.max() > np.iinfo(np.int32).max or
                      int((items + 1).sum()) > np.iinfo(np.int32).max):
        raise ValueError("the partition's plan exceeds int32")
    return np.ascontiguousarray(info.astype(np.int32))


def digit_bins(items: int) -> int:
    """The most bins a pass of the kernel's sort takes in a group of
    ``items`` items at most a member: one pass of ``items`` bins, or
    passes of PART_MAX_BINS (12-bit digits) past them."""
    return max(1, min(PART_MAX_BINS, int(items)))


def off_rows(info: np.ndarray) -> int:
    """The offsets a segment holds for the members ``info`` (their items
    + 1): ``off`` holds this many for each segment."""
    return int((np.asarray(info, np.int64)[:, 1] + 1).sum())


def off_at(info, nseg: int, member: int, item: int, seg: int) -> int:
    """The word of ``off`` that holds item ``item``'s first place in
    segment ``seg`` of member ``member`` (csrc/item_lists.cuh::row_of)."""
    ibase, items = int(info[member][3]), int(info[member][1])
    return ibase * nseg + seg * (items + 1) + item


def partition_plain(values: torch.Tensor, info) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of Part: (slot, val, off) of the ``[C,
    S]`` int32 ``values`` (clamped ids or buckets) under the member rows
    ``info`` ([C, 4]: unit, items, lim, ibase)."""
    c, s = values.shape
    nseg = segments(s)
    info = np.asarray(info, np.int64).reshape(c, 4)
    dev = values.device
    v = values.long()
    unit, items, lim = (torch.as_tensor(info[:, k], device=dev)[:, None]
                        for k in range(3))
    key = torch.div(v, unit, rounding_mode="floor")
    valid = (v >= 0) & (v < lim) & (key < items)
    key = torch.where(valid, key, torch.full_like(v, -1))
    big = int(info[:, 1].max()) + 1 if c else 1
    seg = torch.arange(s, device=dev) // PART_SEG
    order = torch.sort(seg[None, :] * (big + 1) +
                       torch.where(valid, key, torch.full_like(key, big)),
                       dim=1, stable=True).indices
    placed = torch.gather(valid, 1, order)
    none = torch.full_like(order, -1)
    slot = torch.where(placed, order, none).to(torch.int32)
    val = torch.where(placed, torch.gather(v, 1, order), none).to(torch.int32)
    off = torch.zeros(off_rows(info) * nseg, dtype=torch.int64, device=dev)
    for m in range(c):
        n_items = int(info[m, 1])
        k = key[m]
        ok = k >= 0
        cnt = torch.bincount(seg[ok] * n_items + k[ok],
                             minlength=nseg * n_items).view(nseg, n_items)
        first = torch.cat([torch.zeros((nseg, 1), dtype=torch.int64,
                                       device=dev), cnt.cumsum(1)], dim=1)
        ib = int(info[m, 3]) * nseg
        off[ib: ib + nseg * (n_items + 1)] = first.reshape(-1)
    return slot, val, off.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _library() -> None:
    """Load Part's library and check, once, that its constants and record
    size are the ones this module plans with."""
    lib = kernels.library("partition")
    got = (ctypes.c_int64 * len(PART_LIMITS))()
    lib.rt_partition_limits(got)
    for name, want, have in zip(
            ("groups", "segment entries", "bins", "window",
             "PartGroup size"), PART_LIMITS, got):
        if want != have:
            raise RuntimeError(f"csrc/partition.cu's {name} is {have}, "
                               f"ops/item_lists.py plans with {want}")


@functools.lru_cache(maxsize=256)
def _info_on(info_bytes: bytes, c: int, device: str) -> torch.Tensor:
    """A member info array on the card, made once per plan (a launch that
    points into it names it in ``kernels.launch``'s ``keep``, so that a
    captured graph holds it past its eviction)."""
    arr = np.frombuffer(info_bytes, np.int32).reshape(c, 4)
    with torch.inference_mode(False):
        return torch.from_numpy(arr.copy()).to(device)


def info_on(info: np.ndarray, device) -> torch.Tensor:
    """``info`` on ``device`` (a copy made once per plan and device)."""
    info = np.ascontiguousarray(info, np.int32)
    return _info_on(info.tobytes(), info.shape[0], str(device))


def first_step(v: int) -> int:
    """Half of the smallest power of two >= v: the bucket search's first
    step (csrc/bucket_search.cuh::first_step)."""
    p2 = 1
    while p2 < v:
        p2 *= 2
    return p2 // 2


def plain_values(group) -> torch.Tensor:
    """A group's ``[C, S]`` values as the kernel finds them: ids clamped to
    their caps, or raw values' buckets (``bucket_ids_plain``)."""
    if "ids" in group:
        return torch.minimum(group["ids"], group["caps"][:, None])
    from recom_tpu_torch.ops.lookup_onehot import bucket_ids_plain

    return bucket_ids_plain(group["raw"], group["hi"], group["counts"])


def partition(groups) -> List[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]:
    """(slot, val, off) of each group: one dict a group, all on one
    device, with ``info`` ([C, 4] int32 numpy: ``member_info``) and either
    ``ids`` ([C, S] int32) and ``caps`` ([C] int32), or ``raw`` ([C, Bp]
    f32), ``hi`` ([C_pad, V] f32) and ``counts`` ([C_pad, 1] int32), K2's
    bounds.  CPU tensors take the plain version; on CUDA one launch of Part
    serves up to PART_MAX_GROUPS groups."""
    if not groups:
        return []
    src = lambda g: g["ids"] if "ids" in g else g["raw"]
    dev = src(groups[0]).device
    for g in groups:
        x = src(g)
        want = torch.int32 if "ids" in g else torch.float32
        if x.dtype != want or x.dim() != 2 or not x.is_contiguous() \
                or x.device != dev:
            raise ValueError(f"partition entries must be contiguous {want} "
                             f"[C, S] on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if tuple(np.shape(g["info"])) != (x.shape[0], 4):
            raise ValueError(f"info must be [{x.shape[0]}, 4]")
        if x.shape[1] >= 1 << 31:
            raise ValueError(f"{x.shape[1]} entries a member exceed int32")
    if dev.type == "cpu":
        return [partition_plain(plain_values(g), g["info"]) for g in groups]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _library()
    out = []
    stream = kernels.stream_of(src(groups[0]))
    for i in range(0, len(groups), PART_MAX_GROUPS):
        part = groups[i: i + PART_MAX_GROUPS]
        records, keep, blocks, bins = [], [], 0, 1
        for g in part:
            x = src(g)
            c, s = x.shape
            nseg = segments(s)
            info = np.asarray(g["info"], np.int32)
            slot = torch.empty((c, s), dtype=torch.int32, device=dev)
            val = torch.empty((c, s), dtype=torch.int32, device=dev)
            off = torch.empty(off_rows(info) * nseg, dtype=torch.int32,
                              device=dev)
            info_d = info_on(info, dev)
            ids = g.get("ids")
            v = int(g["hi"].shape[1]) if "hi" in g else 0
            records.append(PART_DESC.pack(
                kernels.ptr(ids) or 0, kernels.ptr(g.get("raw")) or 0,
                kernels.ptr(g.get("caps")) or 0, kernels.ptr(g.get("hi")) or 0,
                kernels.ptr(g.get("counts")) or 0, info_d.data_ptr(),
                slot.data_ptr(), val.data_ptr(), off.data_ptr(), s, c, nseg,
                v, first_step(v) if v else 0, 0 if ids is not None else 1,
                blocks))
            keep.append(info_d)
            blocks += c * nseg
            if c:
                bins = max(bins, digit_bins(int(info[:, 1].max())))
            out.append((slot, val, off))
        kernels.launch("Part", b"".join(records), len(part), blocks, bins,
                       stream, keep=keep)
    return out


class StepLists:
    """The partition entries that one forward's lookups register for their
    backward kernels (K3a's, K3b's and X1b's groups), listed by one launch
    of Part for all of them: ``run``, which the executor calls once the
    forward has queued every lookup, or else the first ``get`` of a
    backward that finds its entry not yet listed.  The backward kernels
    then launch no Part of their own.  An entry added after a run is
    listed by the next one.  A lookup given none makes its own, which its
    backward's first ``get`` lists."""

    def __init__(self):
        self._pending: List[Tuple[int, dict]] = []
        self._lists: dict = {}

    def add(self, entry: Optional[dict]) -> Optional[int]:
        """Register ``entry`` (a ``partition`` group); returns its key, or
        None for no entry or one on the CPU, whose plain backward versions
        read no lists."""
        src = None if entry is None else entry.get("ids", entry.get("raw"))
        if src is None or src.device.type == "cpu":
            return None
        key = len(self._lists) + len(self._pending)
        self._pending.append((key, entry))
        return key

    def run(self) -> None:
        """List every pending entry: one launch of Part (up to
        PART_MAX_GROUPS groups a launch)."""
        if self._pending:
            keys = [k for k, _ in self._pending]
            got = partition([e for _, e in self._pending])
            self._pending = []
            self._lists.update(zip(keys, got))

    def get(self, key: Optional[int]) -> Optional[Tuple[torch.Tensor, ...]]:
        """The (slot, val, off) of the entry ``key``; None for None."""
        if key is None:
            return None
        if key not in self._lists:
            self.run()
        return self._lists[key]
