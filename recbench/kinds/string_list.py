"""A list a row, ``list_items`` random strings of ``string_bytes`` letters
and digits joined by the class's delimiter (RECom's generator); each piece
hashed, on the card where the configuration says so."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from recbench import kinds

SINGLE = False
DEVICE_HASHED = True
raw_bytes = kinds.string_bytes


def _lists(rng, batch: int, items: Tuple[int, int], nbytes: int,
           delimiter: str) -> np.ndarray:
    """One joined string a row: ``items[0]..items[1]`` random strings."""
    lens = rng.integers(items[0], items[1] + 1, size=batch)
    width = nbytes + 1
    flat = np.empty((int(lens.sum()), width), np.uint8)
    flat[:, :nbytes] = kinds.ALPHABET[rng.integers(0, len(kinds.ALPHABET),
                                                   (len(flat), nbytes))]
    flat[:, nbytes] = ord(delimiter)
    raw = flat.tobytes()
    ends = np.cumsum(lens) * width
    starts = ends - lens * width
    return np.asarray([raw[a:b - 1] for a, b in zip(starts, ends)],
                      dtype=np.bytes_)


def make(rng, cls, values, batch: int) -> list:
    return [_lists(rng, batch, values["list_items"], values["string_bytes"],
                   cls.delimiter) for _ in range(cls.count)]


def ids(cls, column, rows: int) -> np.ndarray:
    """``[B, L]``: the pieces of each row's list, -1 past its last."""
    delim = cls.delimiter.encode()
    pieces = [bytes(s).split(delim) if len(s) else [] for s in column]
    lens = np.asarray([len(p) for p in pieces], np.int64)
    flat = np.asarray([x for p in pieces for x in p], dtype=np.bytes_)
    ids = (kinds.hash_rows(flat, rows) if len(flat)
           else np.zeros(0, np.int64))
    out = np.full((len(pieces), max(int(lens.max(initial=0)), 1)), -1,
                  np.int64)
    row = np.repeat(np.arange(len(pieces)), lens)
    pos = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
    out[row, pos] = ids
    return out
