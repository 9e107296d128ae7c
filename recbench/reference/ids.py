"""Lookup ids from raw batches, as TF's feature columns define them, in
plain numpy, by each column's kind (``kinds/<kind>.py``: ``Bucketize`` is
the upper bound of the value among the boundaries, then capped to the
table's last row; a hashed column is ``Fingerprint64 % rows`` of the
string, of an integer's decimal string, or of each piece of a delimited
list; a dense integer of -1 is missing).  Missing ids are -1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def class_ids(cls, batch: Dict) -> np.ndarray:
    """The class's ids: ``[B, C]`` for single-valued columns, ``[B, C, L]``
    (-1 past a row's items) for lists."""
    cols = [cls.kind_module.ids(cls, batch[f], int(r))
            for f, r in zip(cls.fields, cls.rows)]
    if cls.single:
        return np.stack(cols, axis=1)
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
