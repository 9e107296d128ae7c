"""Cells at a size the CPU runs in seconds: each configuration with the
overrides of its CPU sizes file (``configs/<name>.cpu.json``: column
classes, dense features and bottom MLP cut down, the top MLP kept so that a
product in TF32 shows as it does at full size, the program's builder given
the same sizes), and the mixes at 64 rows."""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Tuple

from recbench import spec


def merge(base, over):
    """``over`` laid on ``base``: a dict key by key, a list of dicts entry
    by entry (as many as ``base`` has), anything else replaced."""
    if isinstance(base, dict) and isinstance(over, dict):
        return {**base, **{k: merge(base.get(k), v) for k, v in over.items()}}
    if isinstance(base, list) and isinstance(over, list) and over and all(
            isinstance(o, dict) for o in over):
        if len(base) != len(over):
            raise ValueError(f"{len(over)} entries laid on {len(base)}")
        return [merge(b, o) for b, o in zip(base, over)]
    return copy.deepcopy(over)


def cpu_sizes(name: str) -> Dict:
    return spec.load_json(os.path.join(spec.PKG, "configs",
                                       f"{name}.cpu.json"))


def config(name: str) -> Dict:
    return merge(spec.config(name), cpu_sizes(name)["overrides"])


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
