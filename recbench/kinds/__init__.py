"""The column kinds a configuration's ``columns`` may state, one module a
kind, found by the name in an entry's ``kind``: ``kinds/<kind>.py``.  Each
module gives:

* ``SINGLE``: whether a column holds one value a row (else a list);
* ``DEVICE_HASHED``: whether the card hashes a column of the kind that is
  hashed, where the configuration's ``device_hash`` is on, and if so
  ``raw_bytes(column)``, the bytes of one column that it reads
  (counts/model.py);
* ``make(rng, cls, values, batch)``: the ``cls.count`` columns of a class
  (``spec.ColumnClass``), ``batch`` rows each, drawn from ``rng``
  (traffic/batches.py; ``values``: the mix's ranges);
* ``ids(cls, column, rows)``: one column's ids into its table of ``rows``
  rows by the class's transform, as TF's feature columns define them:
  ``[B]``, or ``[B, L]`` for lists; -1 where missing
  (reference/ids.py).

Shared here: TF's ``Bucketize``, the hashing of bytes, and the letters
and digits that strings are drawn from, and their bytes.  A new kind is a
new module here; one that is here is not edited.
"""

from __future__ import annotations

import importlib
import string

import numpy as np

from recbench.reference.hashing import farmhash64_array


def load(kind: str):
    """The module of column kind ``kind``."""
    try:
        return importlib.import_module(f"{__name__}.{kind}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{kind}":
            raise
        raise ValueError(f"unknown column kind {kind!r}: add "
                         f"recbench/kinds/{kind}.py") from None


ALPHABET = np.frombuffer((string.ascii_letters + string.digits).encode(),
                         np.uint8)


def bucketize(cls, column, rows: int) -> np.ndarray:
    """The upper bound of each value among the class's boundaries, capped
    to the table's last row."""
    x = np.asarray(column, np.float32).astype(np.float64)
    ids = np.searchsorted(cls.boundaries, x, side="right")
    return np.minimum(ids, rows - 1).astype(np.int64)


def hash_rows(values: np.ndarray, rows: int) -> np.ndarray:
    """``Fingerprint64 % rows`` of each byte string."""
    return (farmhash64_array(values) % np.uint64(rows)).astype(np.int64)


def need_hash(cls) -> None:
    if cls.transform != "hash":
        raise ValueError(f"unknown transform {cls.transform!r}")


def string_bytes(column) -> int:
    """The bytes of a column of byte strings."""
    return int(np.char.str_len(np.asarray(column, np.bytes_)).sum())
