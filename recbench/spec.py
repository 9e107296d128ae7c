"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root and the
files under ``recbench/`` that it names.  Every cell, configuration,
traffic mix and metric is a file found by its name, so a later change adds
files and edits none (README.md).

A configuration's ``columns`` describe the model in plain terms (each entry
a class of ``count`` columns alike: field and table names, kind, transform,
rows, width, combiner), which both the program's builder and the plain
reference follow; ``tests/test_recbench_layout.py`` holds the two to each
other.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

import numpy as np

from recbench import kinds, towers

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> Dict:
    return load_json(os.path.join(PKG, "workloads", f"{name}.json"))


def config(name: str) -> Dict:
    return load_json(os.path.join(PKG, "configs", f"{name}.json"))


def mix(name: str) -> Dict:
    return load_json(os.path.join(PKG, "traffic", f"{name}.json"))


def metric_reader(name: str):
    """The module ``recbench/metrics/<name>.py``; its ``read(run)`` gives
    the metric's value, or None where the run has nothing to read."""
    path = os.path.join(PKG, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"recbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's metrics: its end-to-end ones, or with ``trace`` its
    per-layer ones; a metric with a ``workloads`` key belongs to the cells
    it lists."""
    metrics = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in metrics if cell in m.get("workloads", [cell])]


class ColumnClass:
    """``count`` columns alike: fields ``<field>0..``, tables ``<table>0..``
    of ``rows`` rows each (one number for all, or one a table), ``dim``
    wide; ``kind_module`` is the module of its kind (``kinds/<kind>.py``),
    which draws its columns and gives their ids."""

    def __init__(self, entry: Dict, onehot_limit: int):
        self.field = entry["field"]
        self.count = int(entry["count"])
        self.kind = entry["kind"]
        self.kind_module = kinds.load(self.kind)
        self.transform = entry["transform"]
        self.table = entry["table"]
        rows = entry["rows"]
        self.rows = np.asarray(
            rows if isinstance(rows, list) else [rows] * self.count, np.int64)
        if len(self.rows) != self.count:
            raise ValueError(f"{self.field}: {len(self.rows)} row counts "
                             f"for {self.count} tables")
        self.dim = int(entry["dim"])
        self.combiner = entry["combiner"]
        self.delimiter = entry.get("delimiter")
        b = entry.get("boundaries")
        self.boundaries = (None if b is None else
                           b["start"] + b["step"] * np.arange(
                               b["count"], dtype=np.float64))
        self.offsets = np.concatenate([[0], np.cumsum(self.rows)[:-1]])
        self.total_rows = int(self.rows.sum())
        self.single = self.kind_module.SINGLE
        # tables the program stacks for its one-hot path (single-valued,
        # unweighted, at most ``onehot_vocab_limit`` rows) into one 3-D
        # leaf, on which a row-wise rule keeps its state an element
        self.per_element = self.single & (self.rows <= onehot_limit)

    @property
    def fields(self) -> List[str]:
        return [f"{self.field}{i}" for i in range(self.count)]

    @property
    def tables(self) -> List[str]:
        return [f"{self.table}{i}" for i in range(self.count)]


def classes(cfg: Dict) -> List[ColumnClass]:
    limit = cfg["engine_config"]["onehot_vocab_limit"]
    return [ColumnClass(e, limit) for e in cfg["columns"]]


def dense_fields(cfg: Dict) -> List[str]:
    d = cfg["dense"]
    return [f"{d['field']}{i}" for i in range(d["count"])]


def tower(cfg: Dict):
    """The module of the configuration's tower (``towers/<arch>.py``)."""
    return towers.load(cfg["tower"]["arch"])


def tower_layers(cfg: Dict) -> Dict[str, List[Dict]]:
    """{part: [{key: shape}, ...]}: the tower's leaves, layer by layer."""
    return tower(cfg).layers(cfg)


def seed_words(seed: int, *keys) -> List[int]:
    """Words for numpy's SeedSequence from ``seed`` (any whole number) and
    further keys."""
    return [int(seed) % (1 << 64)] + [int(k) for k in keys]

