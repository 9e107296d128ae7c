"""A float a row, drawn as a whole number in the mix's
``bucketized_float`` range; bucketized by the class's boundaries (or
hashed as its string)."""

from __future__ import annotations

import numpy as np

from recbench import kinds

SINGLE = True
DEVICE_HASHED = False


def make(rng, cls, values, batch: int) -> np.ndarray:
    lo, hi = values["bucketized_float"]
    return rng.integers(lo, hi, (cls.count, batch)).astype(np.float32)


def ids(cls, column, rows: int) -> np.ndarray:
    if cls.transform == "bucketize":
        return kinds.bucketize(cls, column, rows)
    kinds.need_hash(cls)
    return kinds.hash_rows(np.asarray(column, np.bytes_), rows)
