"""X2: string split + FarmHash on the device (the port of
recom_tpu/ops/hash_device.py and of the verbatim-row gather
``recom_tpu/runtime/wire.py::unpack_blob._verbatim_rows``).

The wire ships each string column's numpy ``'S'`` buffer verbatim; the
device re-pads rows, splits them on a one-byte delimiter, takes FarmHash
Fingerprint64 of each piece (up to 64 bytes: the straight-line branches;
longer pieces are routed to host hashing per request by the wire plan),
reduces it modulo the bucket count and pads with -1.  On CUDA tensors
``hash_verbatim`` runs all of that as one launch of kernel X2
(csrc/hash_device.cu), with native ``uint64_t``; its modulo is a
multiply by the per-column constants of ``bucket_reciprocals``.

The plain versions below must do without uint64: torch has no shifts, adds
or remainders for it.  They carry u64 values as int64 two's complement, in
which add, multiply and xor wrap identically; a logical right shift is an
arithmetic one masked to the low ``64 - n`` bits; ``% m`` (m <= 2^31) works
on the 32-bit halves so that nothing overflows; nothing goes through float.
Bytes are unsigned.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from recom_tpu_torch.ops import kernels


def _s64(x: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= (1 << 63) else x


# FarmHash constants (public-domain farmhashna::Hash64, identical to
# oracle/hashing.py and native/host_ops.cc)
_K0 = _s64(0xC3A5C85C97CB3127)
_K1 = _s64(0xB492B66FBE98F273)
_K2 = _s64(0x9AE16A3B2F90404F)

MAX_BUCKETS = 1 << 31   # ids are int32; the halves trick needs m <= 2^31


def _shr(v: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64-carried u64 values, 0 < n < 64."""
    return (v >> n) & ((1 << (64 - n)) - 1)


def _rot(v: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(v, n) | (v << (64 - n))


def _shift_mix(v):
    return v ^ _shr(v, 47)


def _hash_len_16(u, v, mul):
    a = (u ^ v) * mul
    a = a ^ _shr(a, 47)
    b = (v ^ a) * mul
    b = b ^ _shr(b, 47)
    return b * mul


def _fetch(bytes_i64: torch.Tensor, off: torch.Tensor, n: int) -> torch.Tensor:
    """Little-endian n-byte word at byte offset ``off`` (clamped into the
    row: only the selected length branch's reads are real, and those stay
    inside the piece)."""
    w = bytes_i64.shape[-1]
    v = torch.zeros_like(off)
    for k in range(n):
        idx = torch.clamp(off + k, 0, w - 1)
        v = v | (torch.gather(bytes_i64, -1, idx) << (8 * k))
    return v


def _hash0to16(b, off, ln):
    mul = _K2 + ln * 2
    # len >= 8
    a8 = _fetch(b, off, 8) + _K2
    b8 = _fetch(b, off + torch.clamp(ln - 8, min=0), 8)
    c8 = _rot(b8, 37) * mul + a8
    d8 = (_rot(a8, 25) + b8) * mul
    h8 = _hash_len_16(c8, d8, mul)
    # 4 <= len < 8
    a4 = _fetch(b, off, 4)
    b4 = _fetch(b, off + torch.clamp(ln - 4, min=0), 4)
    h4 = _hash_len_16(ln + (a4 << 3), b4, mul)
    # 1 <= len < 4
    sa = _fetch(b, off, 1)
    sb = _fetch(b, off + (ln >> 1), 1)
    sc = _fetch(b, off + torch.clamp(ln - 1, min=0), 1)
    y = sa + (sb << 8)
    z = ln + (sc << 2)
    h1 = _shift_mix(y * _K2 ^ z * _K0) * _K2
    h = torch.where(ln >= 8, h8, torch.where(ln >= 4, h4, h1))
    return torch.where(ln > 0, h, torch.full_like(h, _K2))


def _hash17to32(b, off, ln):
    mul = _K2 + ln * 2
    a = _fetch(b, off, 8) * _K1
    b_ = _fetch(b, off + 8, 8)
    c = _fetch(b, off + torch.clamp(ln - 8, min=0), 8) * mul
    d = _fetch(b, off + torch.clamp(ln - 16, min=0), 8) * _K2
    return _hash_len_16(
        _rot(a + b_, 43) + _rot(c, 30) + d,
        a + _rot(b_ + _K2, 18) + c,
        mul,
    )


def _hash33to64(b, off, ln):
    mul = _K2 + ln * 2
    a = _fetch(b, off, 8) * _K2
    b_ = _fetch(b, off + 8, 8)
    c = _fetch(b, off + torch.clamp(ln - 8, min=0), 8) * mul
    d = _fetch(b, off + torch.clamp(ln - 16, min=0), 8) * _K2
    y = _rot(a + b_, 43) + _rot(c, 30) + d
    z = _hash_len_16(y, a + _rot(b_ + _K2, 18) + c, mul)
    e = _fetch(b, off + 16, 8) * mul
    f = _fetch(b, off + 24, 8)
    g = (y + _fetch(b, off + torch.clamp(ln - 32, min=0), 8)) * mul
    h = (z + _fetch(b, off + torch.clamp(ln - 24, min=0), 8)) * mul
    return _hash_len_16(
        _rot(e + f, 43) + _rot(g, 30) + h,
        e + _rot(f + a, 18) + g,
        mul,
    )


def farmhash64_pieces(bytes_u8: torch.Tensor, off: torch.Tensor,
                      ln: torch.Tensor, max_len: int = 64) -> torch.Tensor:
    """Fingerprint64 of byte pieces (offset, length) into the trailing axis
    of ``bytes_u8`` [..., W] uint8; off/ln: [..., L].  Returns [..., L]
    int64 carrying the u64 hash bits."""
    b = bytes_u8.to(torch.int64)
    off = torch.clamp(off, min=0).to(torch.int64)
    ln = ln.to(torch.int64)
    h = _hash0to16(b, off, ln)
    if max_len > 16:
        h = torch.where(ln > 16, _hash17to32(b, off, ln), h)
    if max_len > 32:
        h = torch.where(ln > 32, _hash33to64(b, off, ln), h)
    return h


def mod_buckets(h: torch.Tensor, num_buckets: torch.Tensor) -> torch.Tensor:
    """u64 ``h % num_buckets`` as int32, num_buckets <= 2^31 (broadcasts).
    h = hi * 2^32 + lo, so h % m = ((hi % m) * (2^32 % m) + lo) % m, and
    each partial stays below 2^63."""
    m = num_buckets.to(torch.int64)
    hi = _shr(h, 32)
    lo = h & 0xFFFFFFFF
    r = ((hi % m) * ((1 << 32) % m) + lo) % m
    return r.to(torch.int32)


def bucket_reciprocals(buckets) -> np.ndarray:
    """Per-column constants of kernel X2's modulo: M = floor((2^64 - 1) /
    m) for each bucket count m in [1, 2^31], as the int64 with the same
    bits.  With them h % m = r or r - m, where r = h - umulhi(h, M) * m:
    M * m = 2^64 - 1 - e with 0 <= e < m, so h * M / 2^64 lies in
    (h / m - 1, h / m] and the quotient is exact or one short."""
    m = np.asarray(buckets, dtype=np.int64).reshape(-1)
    if m.size and (m.min() < 1 or m.max() > MAX_BUCKETS):
        raise ValueError(f"bucket counts must lie in [1, 2^31], got "
                         f"[{m.min()}, {m.max()}]")
    recips = [((1 << 64) - 1) // int(x) for x in m]
    return np.asarray(recips, dtype=np.uint64).view(np.int64)


def row_lengths(bytes_u8: torch.Tensor) -> torch.Tensor:
    """Byte length of each NUL-right-padded row: the last non-NUL byte + 1.
    [..., W] uint8 -> [...] int64."""
    w = bytes_u8.shape[-1]
    idx = torch.arange(1, w + 1, dtype=torch.int64, device=bytes_u8.device)
    return torch.where(bytes_u8 != 0, idx, torch.zeros_like(idx)).amax(-1)


def fixed_hash_ids(bytes_u8: torch.Tensor, num_buckets: torch.Tensor,
                   max_len: int = 64) -> torch.Tensor:
    """[C, B, W] uint8 rows -> [C, B] int32 = Fingerprint64(row) %
    buckets[c]."""
    ln = row_lengths(bytes_u8)
    h = farmhash64_pieces(
        bytes_u8, torch.zeros_like(ln)[..., None], ln[..., None],
        max_len=max_len,
    )[..., 0]
    return mod_buckets(h, num_buckets[:, None])


def split_pieces(bytes_u8: torch.Tensor, delim: torch.Tensor,
                 rowlen: int) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Delimiter split of NUL-padded rows into up to ``rowlen`` pieces.

    bytes_u8: [C, B, W] uint8; delim: [C] uint8.  Returns (off [C, B, L],
    len [C, B, L], npieces [C, B]), int64.  An empty row has 0 pieces;
    empty pieces between delimiters count; pieces past rowlen drop."""
    c, b, w = bytes_u8.shape
    dev = bytes_u8.device
    ln_row = row_lengths(bytes_u8)                               # [C, B]
    pos = torch.arange(w, dtype=torch.int64, device=dev)
    isd = (bytes_u8 == delim[:, None, None]) & (pos < ln_row[..., None])
    npieces = torch.where(
        ln_row > 0, isd.sum(-1) + 1, torch.zeros_like(ln_row)
    )
    # delimiter positions in order, padded with w
    dpos = torch.where(isd, pos, torch.full_like(pos, w)).sort(-1).values
    if dpos.shape[-1] < rowlen:
        dpos = torch.cat(
            [dpos, torch.full((c, b, rowlen - dpos.shape[-1]), w,
                              dtype=torch.int64, device=dev)], dim=-1)
    dpos = dpos[..., :rowlen]                                    # [C, B, L]
    slots = torch.arange(rowlen, dtype=torch.int64, device=dev)
    start = torch.cat(
        [torch.zeros_like(dpos[..., :1]), dpos[..., :-1] + 1], dim=-1
    )
    is_last = slots == (npieces[..., None] - 1)
    end = torch.where(is_last, ln_row[..., None], dpos)
    valid = slots < npieces[..., None]
    zero = torch.zeros_like(start)
    off = torch.where(valid, start, zero)
    plen = torch.where(valid, end - start, zero)
    return off, plen, npieces


def split_hash_ids(bytes_u8: torch.Tensor, delim: torch.Tensor,
                   num_buckets: torch.Tensor, rowlen: int,
                   max_len: int = 64) -> torch.Tensor:
    """Delimited [C, B, W] rows -> [C, B, rowlen] int32 ids, -1 padded."""
    off, plen, npieces = split_pieces(bytes_u8, delim, rowlen)
    h = farmhash64_pieces(bytes_u8, off, plen, max_len=max_len)
    ids = mod_buckets(h, num_buckets[:, None, None])
    slots = torch.arange(rowlen, device=ids.device)
    valid = slots < npieces[..., None]
    return torch.where(valid, ids, torch.full_like(ids, -1))


def verbatim_rows(raw: torch.Tensor, widths: torch.Tensor, bp: int,
                  wbk: int) -> torch.Tensor:
    """[n, Bp*W] verbatim column bytes + [n] itemsizes -> [n, Bp, W] uint8
    NUL-padded rows: row r of column c is bytes [r*w_c, (r+1)*w_c) of the
    buffer, bytes at j >= w_c read as NUL."""
    n = raw.shape[0]
    dev = raw.device
    r = torch.arange(bp, dtype=torch.int64, device=dev)[None, :, None]
    j = torch.arange(wbk, dtype=torch.int64, device=dev)[None, None, :]
    w = widths.to(torch.int64)[:, None, None]
    idx = torch.clamp(r * w + j, 0, raw.shape[1] - 1).reshape(n, -1)
    rows = torch.gather(raw, 1, idx).reshape(n, bp, wbk)
    return torch.where(j < w, rows, torch.zeros_like(rows))


def hash_verbatim_plain(raw, widths, buckets, delims, bp: int, wbk: int,
                        rowlen: int) -> torch.Tensor:
    """The plain PyTorch version of X2."""
    rows = verbatim_rows(raw, widths, bp, wbk)
    if delims is None:
        return fixed_hash_ids(rows, buckets)[..., None]
    return split_hash_ids(rows, delims, buckets, rowlen)


def hash_verbatim(
    raw: torch.Tensor,              # [n, Bp*W] uint8 verbatim buffers
    widths: torch.Tensor,           # [n] int32 itemsize per column (<= W)
    buckets: torch.Tensor,          # [n] int64 bucket count per column
    recips: torch.Tensor,           # [n] int64 bucket_reciprocals(buckets)
    delims: Optional[torch.Tensor],  # [n] uint8, None for fixed columns
    bp: int,
    wbk: int,
    rowlen: int = 1,
) -> torch.Tensor:
    """Hashed ids [n, Bp, L] int32 for the verbatim string views of the
    wire (L = 1 for fixed columns, ``rowlen`` for delimited ones, -1
    padded).  CPU tensors take the plain version (which needs no
    ``recips``); CUDA tensors launch kernel X2."""
    n = raw.shape[0]
    if raw.dtype != torch.uint8 or tuple(raw.shape) != (n, bp * wbk):
        raise ValueError(f"raw must be uint8 [{n}, {bp * wbk}], got "
                         f"{raw.dtype} {tuple(raw.shape)}")
    if widths.dtype != torch.int32 or tuple(widths.shape) != (n,):
        raise ValueError(f"widths must be int32 [{n}]")
    if buckets.dtype != torch.int64 or tuple(buckets.shape) != (n,):
        raise ValueError(f"buckets must be int64 [{n}]")
    if recips.dtype != torch.int64 or tuple(recips.shape) != (n,):
        raise ValueError(f"recips must be int64 [{n}]")
    if delims is not None and (
        delims.dtype != torch.uint8 or tuple(delims.shape) != (n,)
    ):
        raise ValueError(f"delims must be uint8 [{n}]")
    for name, t in (("widths", widths), ("buckets", buckets),
                    ("recips", recips), ("delims", delims)):
        if t is not None and t.device != raw.device:
            raise ValueError(f"{name} on {t.device}, raw on {raw.device}")
    length = 1 if delims is None else rowlen
    if raw.device.type == "cpu":
        return hash_verbatim_plain(raw, widths, buckets, delims, bp, wbk,
                                   length)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    for name, t in (("raw", raw), ("widths", widths), ("buckets", buckets),
                    ("recips", recips), ("delims", delims)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= wbk <= 65535:
        raise ValueError(f"kernel X2 takes width buckets 1..65535, got {wbk}")
    out = torch.empty((n, bp, length), dtype=torch.int32, device=raw.device)
    kernels.launch(
        "X2",
        kernels.ptr(raw), kernels.ptr(widths), kernels.ptr(buckets),
        kernels.ptr(recips), kernels.ptr(delims), kernels.ptr(out), n, bp,
        wbk, length, kernels.stream_of(raw),
    )
    return out
