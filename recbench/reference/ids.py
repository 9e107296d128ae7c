"""Lookup ids from raw batches, as TF's feature columns define them, in
plain numpy: ``Bucketize`` is the upper bound of the value among the
boundaries (then capped to the table's last row); a hashed column is
``Fingerprint64 % rows`` of the string, of an integer's decimal string, or
of each piece of a delimited list; a dense integer of -1 is missing.
Missing ids are -1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from recbench.reference.hashing import decimal_bytes, farmhash64_array


def _hash_rows(values: np.ndarray, rows: int) -> np.ndarray:
    return (farmhash64_array(values) % np.uint64(rows)).astype(np.int64)


def _column_single(cls, field: str, rows: int, batch: Dict) -> np.ndarray:
    data = batch[field]
    if cls.transform == "bucketize":
        x = np.asarray(data, np.float32).astype(np.float64)
        ids = np.searchsorted(cls.boundaries, x, side="right")
        return np.minimum(ids, rows - 1).astype(np.int64)
    if cls.transform != "hash":
        raise ValueError(f"unknown transform {cls.transform!r}")
    if cls.kind == "dense_int":
        v = np.asarray(data, np.int64)
        ids = _hash_rows(decimal_bytes(v), rows)
        ids[v == -1] = -1
        return ids
    return _hash_rows(np.asarray(data, np.bytes_), rows)


def _column_list(cls, field: str, rows: int, batch: Dict) -> np.ndarray:
    delim = cls.delimiter.encode()
    pieces = [bytes(s).split(delim) if len(s) else []
              for s in batch[field]]
    lens = np.asarray([len(p) for p in pieces], np.int64)
    flat = np.asarray([x for p in pieces for x in p], dtype=np.bytes_)
    ids = _hash_rows(flat, rows) if len(flat) else np.zeros(0, np.int64)
    out = np.full((len(pieces), max(int(lens.max(initial=0)), 1)), -1,
                  np.int64)
    row = np.repeat(np.arange(len(pieces)), lens)
    pos = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
    out[row, pos] = ids
    return out


def class_ids(cls, batch: Dict) -> np.ndarray:
    """The class's ids: ``[B, C]`` for single-valued columns, ``[B, C, L]``
    (-1 past a row's items) for lists."""
    if cls.single:
        return np.stack([_column_single(cls, f, int(r), batch)
                         for f, r in zip(cls.fields, cls.rows)], axis=1)
    cols = [_column_list(cls, f, int(r), batch)
            for f, r in zip(cls.fields, cls.rows)]
    width = max(c.shape[1] for c in cols)
    out = np.full((cols[0].shape[0], len(cols), width), -1, np.int64)
    for i, c in enumerate(cols):
        out[:, i, :c.shape[1]] = c
    return out


def flat_ids(cls, ids: np.ndarray) -> np.ndarray:
    """``ids`` as rows of the class's stacked table (``offsets`` added),
    -1 kept."""
    shape = (1, cls.count) + (1,) * (ids.ndim - 2)
    off = cls.offsets.reshape(shape)
    return np.where(ids >= 0, ids + off, -1)
