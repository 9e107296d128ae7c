"""Cells at a size the CPU runs in seconds: the configurations' column
classes and bottom MLP cut down (the top MLP kept, so that a product in
TF32 shows as it does at full size), with the program's builder given the
same sizes, and the mixes at 64 rows."""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Tuple

from recbench import spec

CRITEO_VOCABS = [3, 155, 976, 2209, 5000, 20000] * 4 + [10, 91]


def config(name: str) -> Dict:
    cfg = copy.deepcopy(spec.config(name))
    if name == "model_e":
        counts = [6, 2, 2, 2, 1]
        for c, n in zip(cfg["columns"], counts):
            c["count"] = n
        cfg["columns"][4]["rows"] = 20000
        cfg["dense"]["count"] = 4
        cfg["tower"]["bottom"] = [8]
        cfg["builder"] = "make_dlrm_model"
        cfg["builder_args"] = dict(
            bucketize_num=6, hash_int_num=2, hash_str_num=2, sparse_str_num=2,
            large_sparse_num=1, dense_num=4, bot_units=[8],
            top_units=cfg["tower"]["top"][:-1],
            name="mini", large_rows=20000)
    else:
        cfg["columns"][0]["rows"] = CRITEO_VOCABS
        cfg["builder_args"] = {**cfg["builder_args"],
                               "vocabs": CRITEO_VOCABS}
    return cfg


def mix(name: str) -> Dict:
    m = spec.mix(name)
    m.update(batch=64, pool=4)
    if m["kind"] == "closed_loop":
        m.update(clients=2, prep_workers=2, max_inflight=2)
    return m


def held_cells() -> List[str]:
    """Cells whose files are kept but that ``BENCHMARK.json`` holds back
    (``held_back`` in the cell's file: why, and the entries of the metrics
    it would report)."""
    names = [f[:-5] for f in os.listdir(os.path.join(spec.PKG, "workloads"))]
    return sorted(n for n in names if "held_back" in spec.workload(n))


def benchmark(name: str) -> Dict:
    """``BENCHMARK.json``, with a held-back cell's entry and metrics put
    back in."""
    bench = spec.benchmark()
    work = spec.workload(name)
    held = work.get("held_back")
    if held:
        bench["workloads"].append({"name": name, **{
            k: work[k] for k in ("config", "traffic", "chips", "why")}})
        bench["end_to_end"] += held["end_to_end"]
        bench["per_layer"] += held["per_layer"]
    return bench


def cell(name: str) -> Tuple[Dict, Dict, Dict]:
    """(workload, configuration, mix) of a cell, cut down."""
    work = spec.workload(name)
    return work, config(work["config"]), mix(work["traffic"])
