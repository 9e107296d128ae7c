"""The model's weights, made from ``--seed`` on the device in a few large
calls.

A class of tables (``spec.ColumnClass``) is one ``[total_rows, dim]``
tensor, its tables one after another, drawn N(0, 1/dim) in chunks of at
most 2^28 values, each chunk from a ``torch.Generator`` of its own seeded
by (seed, class, chunk); the tower's layers as its module draws them
(``towers/<arch>.py``: He-normal weights and zero biases), a generator a
layer.  So the same seed on the same device gives the same
values, and the reference draws them again instead of holding a copy.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import numpy as np
import torch

from recbench import spec

CHUNK_VALUES = 1 << 28


def _seed(seed: int, *keys) -> int:
    words = ",".join(str(w) for w in spec.seed_words(seed, *[
        k if isinstance(k, int) else int.from_bytes(
            hashlib.blake2b(str(k).encode(), digest_size=4).digest(), "little")
        for k in keys]))
    digest = hashlib.blake2b(words.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _chunks(cls: "spec.ColumnClass") -> List[tuple]:
    """(first table, end table) of each generator call: whole tables, at
    most ``CHUNK_VALUES`` values a call unless one table holds more."""
    out, start, values = [], 0, 0
    for i, rows in enumerate(cls.rows):
        v = int(rows) * cls.dim
        if i > start and values + v > CHUNK_VALUES:
            out.append((start, i))
            start, values = i, 0
        values += v
    out.append((start, cls.count))
    return out


def class_table(cfg: Dict, index: int, seed: int, device) -> torch.Tensor:
    """The tables of column class ``index`` as one ``[total_rows, dim]`` f32
    tensor on ``device``."""
    cls = spec.classes(cfg)[index]
    out = torch.empty((cls.total_rows, cls.dim), dtype=torch.float32,
                      device=device)
    for j, (a, b) in enumerate(_chunks(cls)):
        lo = int(cls.offsets[a])
        hi = int(cls.offsets[b]) if b < cls.count else cls.total_rows
        gen = torch.Generator(device=device)
        gen.manual_seed(_seed(seed, "table", index, j))
        view = out[lo:hi]
        torch.randn(view.shape, generator=gen, device=device, out=view)
        view.mul_(1.0 / math.sqrt(cls.dim))
    return out


def tower(cfg: Dict, seed: int, device) -> Dict[str, List[Dict]]:
    """{part: [{key: leaf}, ...]} f32 on ``device``: each layer of the
    tower's ``layers`` drawn by its module (``towers/<arch>.py``) from a
    generator of its own."""
    arch = spec.tower(cfg)
    out: Dict[str, List[Dict]] = {}
    for part, layers in arch.layers(cfg).items():
        out[part] = []
        for i, layer in enumerate(layers):
            gen = torch.Generator(device=device)
            gen.manual_seed(_seed(seed, "tower", part, i))
            out[part].append(arch.draw(layer, gen, device))
    return out


def program_params(cfg: Dict, seed: int, device) -> Dict:
    """The portable numpy tree the program takes as ``params=``: each table
    a view into its class's host array, and the tower (a part with no
    layers left out)."""
    tables: Dict[str, np.ndarray] = {}
    for ci, cls in enumerate(spec.classes(cfg)):
        host = class_table(cfg, ci, seed, device).cpu().numpy()
        for name, off, rows in zip(cls.tables, cls.offsets, cls.rows):
            tables[name] = host[off:off + rows]
    tw = {part: [{k: v.cpu().numpy() for k, v in layer.items()}
                 for layer in layers]
          for part, layers in tower(cfg, seed, device).items() if layers}
    return {"tables": tables, "tower": tw}
