"""An integer a row in the mix's ``dense_int`` range, hashed as its
decimal string on the host; -1 is missing."""

from __future__ import annotations

import numpy as np

from recbench import kinds
from recbench.reference.hashing import decimal_bytes

SINGLE = True
DEVICE_HASHED = False


def make(rng, cls, values, batch: int) -> np.ndarray:
    lo, hi = values["dense_int"]
    return rng.integers(lo, hi, (cls.count, batch), dtype=np.int64)


def ids(cls, column, rows: int) -> np.ndarray:
    if cls.transform == "bucketize":
        return kinds.bucketize(cls, column, rows)
    kinds.need_hash(cls)
    v = np.asarray(column, np.int64)
    out = kinds.hash_rows(decimal_bytes(v), rows)
    out[v == -1] = -1
    return out
