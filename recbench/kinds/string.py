"""A string a row, ``string_bytes`` random letters and digits (RECom's
generator); hashed, on the card where the configuration says so."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from recbench import kinds

SINGLE = True
DEVICE_HASHED = True
raw_bytes = kinds.string_bytes


def strings(rng, shape: Tuple[int, ...], nbytes: int) -> np.ndarray:
    """Random ``S<nbytes>`` strings of letters and digits."""
    chars = kinds.ALPHABET[rng.integers(0, len(kinds.ALPHABET),
                                       shape + (nbytes,))]
    return np.ascontiguousarray(chars).view(f"S{nbytes}").reshape(shape)


def make(rng, cls, values, batch: int) -> np.ndarray:
    return strings(rng, (cls.count, batch), values["string_bytes"])


def ids(cls, column, rows: int) -> np.ndarray:
    if cls.transform == "bucketize":
        return kinds.bucketize(cls, column, rows)
    kinds.need_hash(cls)
    return kinds.hash_rows(np.asarray(column, np.bytes_), rows)

