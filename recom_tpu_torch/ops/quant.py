"""Quantized embedding-table storage (the port of recom_tpu/ops/quant.py).

Embedding lookup is bound by the bytes of the rows it reads, so the stored
width is the traffic.  Besides f32 tables the Engine stores:

  bfloat16  -- half the row bytes; rows upcast to f32 after the load, in
               registers (exact: a bf16 is the top half of an f32)
  int8      -- a quarter of the row bytes: symmetric per-row scales (scale
               = max|row| / 127), dequantized after the load as
               f32(q) * scale[row], one rounded product

Per-row scales matter for embeddings: row norms in trained tables span
orders of magnitude (frequent ids get large rows), so a per-table scale
would crush rare-id rows to zero.

Exactness contract: quantization is lossy by definition, so the bit-exact
oracle comparison is against the dequantized table (``dequantize_table``,
which ``runtime/checkpoint.export_params`` applies) -- the lookup and the
pooling themselves stay exact.  ``quantize_rows_int8`` and
``dequantize_table`` are numpy copies of the reference's;
``quantize_rows_chunked`` gives ``quantize_rows_int8``'s bits in less
memory.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class QuantizedTable(NamedTuple):
    """An int8 row-quantized table: two tensors on one device."""

    q: torch.Tensor        # [R, d] int8
    scale: torch.Tensor    # [R] f32, 0.0 for all-zero rows


def quantize_rows_int8(table: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization (numpy, build time)."""
    table = np.asarray(table, np.float32)
    amax = np.abs(table).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 0.0).astype(np.float32)
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    q = np.clip(np.rint(table * inv[:, None]), -127, 127).astype(np.int8)
    return q, scale


def quantize_rows_chunked(table: np.ndarray, rows: int = 1 << 20):
    """``quantize_rows_int8`` a block of rows at a time: the same bits
    (every row is quantized on its own), without the whole table's f64
    temporaries (model E's 41.9 M-row group would need about 30 GB)."""
    q = np.empty(table.shape, np.int8)
    scale = np.empty(table.shape[0], np.float32)
    for r in range(0, table.shape[0], rows):
        q[r: r + rows], scale[r: r + rows] = quantize_rows_int8(
            table[r: r + rows])
    return q, scale


def dequantize_rows(q_rows: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """int8 rows [..., d] + per-row scales [...] -> f32 rows."""
    return q_rows.float() * scales[..., None]


def dequantize_table(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Full-table dequant (numpy) -- the oracle-comparison reference."""
    return np.asarray(q, np.float32) * np.asarray(scale, np.float32)[:, None]
