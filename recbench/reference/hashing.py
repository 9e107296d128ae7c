"""FarmHash Fingerprint64, the hash of TF's ``StringToHashBucketFast``, for
the benchmark's plain reference.

The scalar functions are a frozen copy of the port's pure-Python FarmHash
(``recom_tpu_torch/oracle/hashing.py`` at the commit that added the
benchmark), so the reference imports nothing of the program.
``farmhash64_array`` is the same arithmetic on numpy ``uint64`` lanes for
byte strings of at most 16 bytes, every value the benchmark's traffic
hashes; longer strings take the scalar path.
"""

from __future__ import annotations

from typing import Union

import numpy as np

_M64 = (1 << 64) - 1

K0 = 0xC3A5C85C97CB3127
K1 = 0xB492B66FBE98F273
K2 = 0x9AE16A3B2F90404F


def _fetch64(s: bytes, i: int) -> int:
    return int.from_bytes(s[i : i + 8], "little")


def _fetch32(s: bytes, i: int) -> int:
    return int.from_bytes(s[i : i + 4], "little")


def _rotr(v: int, n: int) -> int:
    return ((v >> n) | (v << (64 - n))) & _M64


def _shift_mix(v: int) -> int:
    return (v ^ (v >> 47)) & _M64


def _hash_len_16(u: int, v: int, mul: int) -> int:
    a = ((u ^ v) * mul) & _M64
    a ^= a >> 47
    b = ((v ^ a) * mul) & _M64
    b ^= b >> 47
    return (b * mul) & _M64


def _hash_len_0_to_16(s: bytes) -> int:
    n = len(s)
    if n >= 8:
        mul = (K2 + n * 2) & _M64
        a = (_fetch64(s, 0) + K2) & _M64
        b = _fetch64(s, n - 8)
        c = (_rotr(b, 37) * mul + a) & _M64
        d = ((_rotr(a, 25) + b) * mul) & _M64
        return _hash_len_16(c, d, mul)
    if n >= 4:
        mul = (K2 + n * 2) & _M64
        a = _fetch32(s, 0)
        return _hash_len_16((n + (a << 3)) & _M64, _fetch32(s, n - 4), mul)
    if n > 0:
        a, b, c = s[0], s[n >> 1], s[n - 1]
        y = (a + (b << 8)) & 0xFFFFFFFF
        z = (n + (c << 2)) & 0xFFFFFFFF
        return (_shift_mix((y * K2 ^ z * K0) & _M64) * K2) & _M64
    return K2


def _hash_len_17_to_32(s: bytes) -> int:
    n = len(s)
    mul = (K2 + n * 2) & _M64
    a = (_fetch64(s, 0) * K1) & _M64
    b = _fetch64(s, 8)
    c = (_fetch64(s, n - 8) * mul) & _M64
    d = (_fetch64(s, n - 16) * K2) & _M64
    return _hash_len_16(
        (_rotr((a + b) & _M64, 43) + _rotr(c, 30) + d) & _M64,
        (a + _rotr((b + K2) & _M64, 18) + c) & _M64,
        mul,
    )


def _hash_len_33_to_64(s: bytes) -> int:
    n = len(s)
    mul = (K2 + n * 2) & _M64
    a = (_fetch64(s, 0) * K2) & _M64
    b = _fetch64(s, 8)
    c = (_fetch64(s, n - 8) * mul) & _M64
    d = (_fetch64(s, n - 16) * K2) & _M64
    y = (_rotr((a + b) & _M64, 43) + _rotr(c, 30) + d) & _M64
    z = _hash_len_16(y, (a + _rotr((b + K2) & _M64, 18) + c) & _M64, mul)
    e = (_fetch64(s, 16) * mul) & _M64
    f = _fetch64(s, 24)
    g = ((y + _fetch64(s, n - 32)) * mul) & _M64
    h = ((z + _fetch64(s, n - 24)) * mul) & _M64
    return _hash_len_16(
        (_rotr((e + f) & _M64, 43) + _rotr(g, 30) + h) & _M64,
        (e + _rotr((f + a) & _M64, 18) + g) & _M64,
        mul,
    )


def _weak_hash_len_32_with_seeds(s: bytes, i: int, a: int, b: int):
    w = _fetch64(s, i)
    x = _fetch64(s, i + 8)
    y = _fetch64(s, i + 16)
    z = _fetch64(s, i + 24)
    a = (a + w) & _M64
    b = _rotr((b + a + z) & _M64, 21)
    c = a
    a = (a + x + y) & _M64
    b = (b + _rotr(a, 44)) & _M64
    return (a + z) & _M64, (b + c) & _M64


def farmhash64(data: Union[str, bytes]) -> int:
    """FarmHash Fingerprint64 of ``data`` (utf-8 encoded if str)."""
    s = data.encode("utf-8") if isinstance(data, str) else bytes(data)
    n = len(s)
    if n <= 16:
        return _hash_len_0_to_16(s)
    if n <= 32:
        return _hash_len_17_to_32(s)
    if n <= 64:
        return _hash_len_33_to_64(s)

    seed = 81
    x = seed
    y = (seed * K1 + 113) & _M64
    z = (_shift_mix((y * K2 + 113) & _M64) * K2) & _M64
    v = (0, 0)
    w = (0, 0)
    x = (x * K2 + _fetch64(s, 0)) & _M64

    end = ((n - 1) // 64) * 64
    last64 = end + ((n - 1) & 63) - 63
    i = 0
    while True:
        x = (_rotr((x + y + v[0] + _fetch64(s, i + 8)) & _M64, 37) * K1) & _M64
        y = (_rotr((y + v[1] + _fetch64(s, i + 48)) & _M64, 42) * K1) & _M64
        x ^= w[1]
        y = (y + v[0] + _fetch64(s, i + 40)) & _M64
        z = (_rotr((z + w[0]) & _M64, 33) * K1) & _M64
        v = _weak_hash_len_32_with_seeds(s, i, (v[1] * K1) & _M64, (x + w[0]) & _M64)
        w = _weak_hash_len_32_with_seeds(
            s, i + 32, (z + w[1]) & _M64, (y + _fetch64(s, i + 16)) & _M64
        )
        z, x = x, z
        i += 64
        if i == end:
            break

    mul = (K1 + ((z & 0xFF) << 1)) & _M64
    i = last64
    w0 = (w[0] + ((n - 1) & 63)) & _M64
    v0 = (v[0] + w0) & _M64
    w0 = (w0 + v0) & _M64
    v = (v0, v[1])
    w = (w0, w[1])
    x = (_rotr((x + y + v[0] + _fetch64(s, i + 8)) & _M64, 37) * mul) & _M64
    y = (_rotr((y + v[1] + _fetch64(s, i + 48)) & _M64, 42) * mul) & _M64
    x ^= (w[1] * 9) & _M64
    y = (y + v[0] * 9 + _fetch64(s, i + 40)) & _M64
    z = (_rotr((z + w[0]) & _M64, 33) * mul) & _M64
    v = _weak_hash_len_32_with_seeds(s, i, (v[1] * mul) & _M64, (x + w[0]) & _M64)
    w = _weak_hash_len_32_with_seeds(
        s, i + 32, (z + w[1]) & _M64, (y + _fetch64(s, i + 16)) & _M64
    )
    z, x = x, z
    return _hash_len_16(
        (_hash_len_16(v[0], w[0], mul) + _shift_mix(y) * K0 + z) & _M64,
        (_hash_len_16(v[1], w[1], mul) + x) & _M64,
        mul,
    )


_U = np.uint64


def _vrotr(v: np.ndarray, n: int) -> np.ndarray:
    return (v >> _U(n)) | (v << _U(64 - n))


def _vshift_mix(v: np.ndarray) -> np.ndarray:
    return v ^ (v >> _U(47))


def _vhash_len_16(u: np.ndarray, v: np.ndarray, mul) -> np.ndarray:
    a = (u ^ v) * mul
    a ^= a >> _U(47)
    b = (v ^ a) * mul
    b ^= b >> _U(47)
    return b * mul


def _vfetch(raw: np.ndarray, i: int, width: int) -> np.ndarray:
    """Little-endian words of ``width`` bytes at byte ``i`` of each row."""
    out = np.zeros(raw.shape[0], np.uint64)
    for k in range(width):
        out |= raw[:, i + k].astype(np.uint64) << _U(8 * k)
    return out


def _vhash_len(raw: np.ndarray, n: int) -> np.ndarray:
    """``_hash_len_0_to_16`` of rows of ``raw`` [m, >= n] that all hold
    ``n`` <= 16 bytes."""
    if n == 0:
        return np.full(raw.shape[0], K2, np.uint64)
    mul = _U((K2 + n * 2) & _M64)
    if n >= 8:
        a = _vfetch(raw, 0, 8) + _U(K2)
        b = _vfetch(raw, n - 8, 8)
        c = _vrotr(b, 37) * mul + a
        d = (_vrotr(a, 25) + b) * mul
        return _vhash_len_16(c, d, mul)
    if n >= 4:
        a = _vfetch(raw, 0, 4)
        return _vhash_len_16(_U(n) + (a << _U(3)), _vfetch(raw, n - 4, 4),
                             mul)
    a = raw[:, 0].astype(np.uint64)
    b = raw[:, n >> 1].astype(np.uint64)
    c = raw[:, n - 1].astype(np.uint64)
    y = (a + (b << _U(8))) & _U(0xFFFFFFFF)
    z = (_U(n) + (c << _U(2))) & _U(0xFFFFFFFF)
    return _vshift_mix((y * _U(K2)) ^ (z * _U(K0))) * _U(K2)


def farmhash64_array(values: np.ndarray) -> np.ndarray:
    """``farmhash64`` of every byte string of the numpy ``S`` array
    ``values``, as ``uint64``.  A numpy ``S`` value ends at its first
    trailing NUL, as the port's wire reads it."""
    values = np.ascontiguousarray(np.asarray(values, dtype=np.bytes_))
    n = values.shape[0]
    out = np.empty(n, np.uint64)
    if n == 0:
        return out
    width = max(values.dtype.itemsize, 16)
    raw = np.zeros((n, width), np.uint8)
    raw[:, :values.dtype.itemsize] = values.view(np.uint8).reshape(
        n, values.dtype.itemsize)
    lens = np.char.str_len(values)
    for length in np.unique(lens):
        sel = lens == length
        if length <= 16:
            out[sel] = _vhash_len(raw[sel], int(length))
        else:
            out[sel] = [farmhash64(bytes(v)) for v in values[sel]]
    return out


def decimal_bytes(values: np.ndarray) -> np.ndarray:
    """Integers as the decimal strings that TF's hashed categorical column
    hashes."""
    return np.asarray(values, np.int64).astype(np.bytes_)
