"""The operations and bytes that a forward or a training step needs, and
the hand kernels' work in them, from the configuration's shapes and a
batch's ids.

They count what these inputs need, not what an implementation happens to
move: each input byte read once, each output byte written once, a table
row once however many ids name it, intermediates that a fused program
could keep on chip not at all.  So a program that moves less reads higher
against the same count, and one that reads over 100% has found a fault in
the count or in the timing.

* forward: the tower's operations as its module counts them
  (``towers/<arch>.py``, ``ops``: 2 a multiply-add of its layers and of
  DLRM's dot interaction, its strict upper triangle), a pooling add an
  item and element; bytes: the inputs (4 an id, or the raw bytes of a
  string hashed on the device, 4 a dense value), the distinct rows
  touched, the tower's params, the output.
* training step: the tower's step operations (its module's: the products
  three times, forward and the gradients of inputs and weights), pooling
  and its scatter, and the update rule's operations
  (``reference/rules/<rule>.py``, ``OPS``) a tower param and an element of
  each touched row; bytes: the touched rows and their state
  read and written once, the tower's params, gradients and state read and
  written once, the inputs and labels.
* the kernels' work, whichever kernel does it (``counts/kernels/<id>.json``
  names each kernel's): "lookup", the lookups (ids, or the raw floats of a
  column bucketized on the device, read; the distinct rows read; the
  pooled output written); "hash", the strings hashed on the device (the
  raw bytes read, the ids written, 64 integer operations a hashed piece
  and one a byte); "lookup_grad", the lookups' backward (the cotangent and
  the ids read, the distinct rows' gradients written).  The partition the
  backward launches needs nothing of its own: its time counts against
  "lookup_grad".
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from recbench import spec
from recbench.reference import ids as ref_ids
from recbench.reference import rules

F32 = 4
HASH_OPS = 64
WORK = ("lookup", "hash", "lookup_grad")


def device_hashed(cfg: Dict, cls) -> bool:
    """Whether the card hashes the class's columns (its kind's
    ``DEVICE_HASHED``)."""
    return (cfg["engine_config"]["device_hash"] and cls.transform == "hash"
            and cls.kind_module.DEVICE_HASHED)


def _raw_bytes(cls, batch: Dict) -> int:
    return int(sum(cls.kind_module.raw_bytes(batch[f]) for f in cls.fields))


def _leaf_shapes(cfg: Dict) -> List[Tuple[int, ...]]:
    return [shape for layers in spec.tower_layers(cfg).values()
            for layer in layers for shape in layer.values()]


def _tower_update(cfg: Dict) -> Dict[str, float]:
    """The update's operations and bytes over the tower's params (params
    and gradients read and written, the rule's state read and written; a
    leaf that is not 2-D keeps its state an element)."""
    rule = rules.load(cfg["optimizer"]["tower"]["rule"])
    ops = nbytes = 0.0
    for shape in _leaf_shapes(cfg):
        size = math.prod(shape)
        ops += rule.OPS * size
        nbytes += F32 * size * (4 + 2 * rule.state_per_value(
            len(shape) != 2, shape[-1]))
    return {"ops": ops, "bytes": nbytes}


def batch_counts(cfg: Dict, batch: Dict) -> Dict[str, Dict[str, float]]:
    """{name: {"ops": n, "bytes": n}} of one batch for "forward", "step"
    and each work of the kernels."""
    b = len(batch[spec.dense_fields(cfg)[0]])
    tower_ops = spec.tower(cfg).ops(cfg)
    params = sum(math.prod(shape) for shape in _leaf_shapes(cfg))
    tab_rule = rules.load(cfg["optimizer"]["tables"]["rule"])
    out: Dict[str, Dict[str, float]] = {
        k: {"ops": 0.0, "bytes": 0.0} for k in ("forward", "step") + WORK}
    fwd, step = out["forward"], out["step"]
    update = _tower_update(cfg)
    fwd["ops"] += b * tower_ops["forward"]
    step["ops"] += b * tower_ops["step"] + update["ops"]
    n_dense = cfg["dense"]["count"]
    inputs = F32 * b * n_dense
    fwd["bytes"] += F32 * params + F32 * b
    step["bytes"] += update["bytes"]
    for cls in spec.classes(cfg):
        ids = ref_ids.flat_ids(cls, ref_ids.class_ids(cls, batch))
        cols = ids.reshape(ids.shape[0], cls.count, -1)
        items = (cols >= 0).sum(axis=(0, 2))
        distinct = np.asarray([len(np.unique(c[c >= 0]))
                               for c in cols.transpose(1, 0, 2)])
        row_bytes = F32 * cls.dim * distinct
        pooled = F32 * b * cls.dim
        if device_hashed(cfg, cls):
            raw = _raw_bytes(cls, batch)
            out["hash"]["bytes"] += raw + F32 * int(items.sum())
            out["hash"]["ops"] += HASH_OPS * int(items.sum()) + raw
            inputs += raw
        else:
            inputs += F32 * int(items.sum())
        need = F32 * int(items.sum()) + int(row_bytes.sum()) + pooled * \
            cls.count
        out["lookup"]["bytes"] += need
        out["lookup_grad"]["bytes"] += need
        fwd["ops"] += int(items.sum()) * cls.dim
        fwd["bytes"] += int(row_bytes.sum())
        state = np.asarray([tab_rule.state_per_value(bool(e), cls.dim)
                            for e in cls.per_element])
        step["ops"] += (2 * int(items.sum()) * cls.dim
                        + tab_rule.OPS * int(distinct.sum()) * cls.dim)
        step["bytes"] += 2 * int(row_bytes.sum()) + 2 * float(
            (state * row_bytes).sum())
    fwd["bytes"] += inputs
    step["bytes"] += inputs + F32 * b
    return out


def pool_counts(cfg: Dict, pool) -> Dict[str, Dict[str, float]]:
    """``batch_counts`` averaged over the batches of a pool."""
    each = [batch_counts(cfg, batch) for batch in pool]
    return {k: {m: float(np.mean([e[k][m] for e in each]))
                for m in ("ops", "bytes")} for k in each[0]}


def bound_s(entry: Dict[str, float], flops: float, bytes_per_s: float,
            ops_per_s: float = None) -> float:
    """The least time of a count: its bytes at the memory's rate or its
    operations at ``flops`` (``ops_per_s`` for integer work), the
    larger."""
    rate = flops if ops_per_s is None else ops_per_s
    return max(entry["bytes"] / bytes_per_s, entry["ops"] / rate)
