"""Raw request batches, drawn from the seed, for a configuration's columns.

The value distributions follow RECom's own generator
(``make_random_batch``, after the RECom artifact's ``examples/python/
dlrm.py:49-53`` and ``microbenchmark.py:67``): numbers as whole values in
a range, strings of 8 letters and digits, lists of 1 to 10 items joined by
the column's delimiter.  A mix's ``values`` set the ranges (Criteo's
uniform 32-bit category tokens and log(1 + x) counts, after the port's
``chip_smoke.criteo_batch``).  Written in bulk with numpy: model E's 2048
rows take tens of milliseconds, not seconds.

Batch ``k`` of seed ``s`` draws from its own ``SeedSequence([s, k])``, so a
pool is the same for the same seed whatever its size.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from recbench import spec


def make_batch(cfg: Dict, values: Dict, batch: int, seed: int,
               k: int) -> Dict[str, np.ndarray]:
    """Batch ``k`` of ``seed``: every field of ``cfg``'s columns (as their
    kinds draw them, ``kinds/<kind>.py``, class by class) and dense
    features, ``batch`` rows."""
    rng = np.random.default_rng(spec.seed_words(seed, k))
    out: Dict[str, np.ndarray] = {}
    for cls in spec.classes(cfg):
        cols = cls.kind_module.make(rng, cls, values, batch)
        for name, col in zip(cls.fields, cols):
            out[name] = col
    lo, hi = values["dense_float"]
    dense = rng.integers(lo, hi, (cfg["dense"]["count"], batch)).astype(
        np.float32)
    if values.get("dense_float_log1p"):
        dense = np.log1p(dense).astype(np.float32)
    for name, col in zip(spec.dense_fields(cfg), dense):
        out[name] = col
    return out


def make_labels(mix: Dict, seed: int, k: int) -> np.ndarray:
    """0/1 labels of batch ``k``, each 1 with ``label_p``."""
    rng = np.random.default_rng(spec.seed_words(seed, k, 1))
    return (rng.random(mix["batch"]) < mix["label_p"]).astype(np.float32)


def make_pool(cfg: Dict, mix: Dict, seed: int) -> List[Dict]:
    """The mix's ``pool`` distinct batches of ``batch`` rows."""
    return [make_batch(cfg, mix["values"], mix["batch"], seed, k)
            for k in range(mix["pool"])]
