"""Every cell, configuration, mix and metric is a file found by its name,
and each configuration's plain description is the model its builder
makes."""

import importlib
import os
import types

import pytest

from recbench import spec
from recbench.tests import tiny

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
HELD_METRICS = [m["name"] for c in tiny.held_cells()
                for part in ("end_to_end", "per_layer")
                for m in spec.workload(c)["held_back"][part]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    work = spec.workload(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert work[key] == entry[key]
    cfg = spec.config(work["config"])
    assert cfg["name"] == work["config"]
    mix = spec.mix(work["traffic"])
    kind = importlib.import_module(f"recbench.traffic.{mix['kind']}")
    assert kind.Cell.kind in ("serve", "train")
    assert work["limits"]
    for m in spec.cell_metrics(BENCH, cell, False):
        assert spec.metric_reader(m["name"]).read
    names = {m["name"] for m in spec.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in names and len(names) >= 2
    assert spec.cell_metrics(BENCH, cell, True)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"recbench/configs/{name}.json"
    cfg = spec.config(name)
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]


@pytest.mark.parametrize("name", METRICS + HELD_METRICS)
def test_metric_reader(name):
    """Found by name, and silent on a run that has nothing to read."""
    reader = spec.metric_reader(name)
    empty = types.SimpleNamespace(kind="none", setup_s=1.0, e2e={},
                                  trace=None, spans=None, forwards=0,
                                  counts=None, peaks=None)
    value = reader.read(empty)
    assert value is None or name == "setup_s"


def test_every_file_is_named():
    """No cell, configuration, mix or reader that BENCHMARK.json, or a
    held-back cell's file, does not reach, beside the generators' code."""
    held = tiny.held_cells()
    assert not set(held) & set(CELLS)
    cells = {f[:-5] for f in os.listdir(os.path.join(spec.PKG, "workloads"))}
    assert cells == set(CELLS) | set(held)
    files = os.listdir(os.path.join(spec.PKG, "configs"))
    configs = {f[:-5] for f in files if not f.endswith(".cpu.json")}
    assert configs == {c["name"] for c in BENCH["configs"]}
    # each configuration's CPU sizes (tests/tiny.py), and no others
    assert {f[:-9] for f in files if f.endswith(".cpu.json")} == configs
    mixes = {f[:-5] for f in os.listdir(os.path.join(spec.PKG, "traffic"))
             if f.endswith(".json")}
    assert mixes == {spec.workload(c)["traffic"] for c in cells}
    readers = {f[:-3] for f in os.listdir(os.path.join(spec.PKG, "metrics"))
               if f.endswith(".py")}
    assert readers == set(METRICS) | set(HELD_METRICS)
    for c in held:
        bench = tiny.benchmark(c)
        assert {m["name"] for m in spec.cell_metrics(bench, c, False)} >= {
            "setup_s"}
        assert spec.cell_metrics(bench, c, True)


@pytest.mark.parametrize("name", ["model_e", "criteo_dlrm"])
def test_config_is_the_builders_model(name):
    """The column classes, tables, transforms and tower of the plain
    description are those of the program's builder."""
    from recbench import port
    from recom_tpu_torch.ir.spec import Bucketize, Combiner, HashBucket

    cfg = spec.config(name)
    model = port.model(cfg)
    cols = model.embedding_columns
    want = [(f, t, int(r), c.dim, c) for c in spec.classes(cfg)
            for f, t, r in zip(c.fields, c.tables, c.rows)]
    assert [c.name for c in cols] == [w[0] for w in want]
    for col, (field, table, rows, dim, cls) in zip(cols, want):
        assert col.source.field == field
        assert col.source.kind.name.lower() == cls.kind
        assert col.source.delimiter == cls.delimiter
        assert col.lookup.table == table
        assert col.lookup.combiner == Combiner[cls.combiner.upper()]
        assert col.lookup.weight_field is None
        assert (model.tables[table].vocab_size,
                model.tables[table].dim) == (rows, dim)
        (t,) = col.transforms
        if cls.transform == "bucketize":
            assert isinstance(t, Bucketize)
            assert list(t.boundaries) == list(cls.boundaries)
        else:
            assert isinstance(t, HashBucket) and t.num_buckets == rows
    assert [c.source.field for c in model.dense_columns] == \
        spec.dense_fields(cfg)
    tower = model.tower
    assert tower.arch == cfg["tower"]["arch"]
    assert list(tower.bottom_mlp) == cfg["tower"]["bottom"]
    assert list(tower.top_mlp) == cfg["tower"]["top"]
    assert tower.activation == cfg["tower"]["activation"]
    assert tower.final_activation == cfg["tower"]["final_activation"]
    engine_config = port.engine_config(cfg)
    for k, v in cfg["engine_config"].items():
        assert getattr(engine_config, k) == v


def test_optimizer_is_the_programs():
    """The optimizer the harness builds from each configuration's rules is
    what the program's dlrm_optimizer makes for the same rates."""
    import torch

    from recbench import port
    from recom_tpu_torch.train import dlrm_optimizer

    params = {"stacked": {"0": torch.zeros(2, 2), "1": torch.zeros(2, 3, 2)},
              "tower": {"top": [{"w": torch.zeros(2, 1),
                                 "b": torch.zeros(1)}]}}
    for name in ("model_e", "criteo_dlrm"):
        cfg = spec.config(name)
        opt = cfg["optimizer"]
        made = port.optimizer(cfg)(params)
        want = dlrm_optimizer(opt["tables"]["lr"], opt["tower"]["lr"])(params)
        assert len(made.param_groups) == len(want.param_groups) == 2
        for got, ref in zip(made.param_groups, want.param_groups):
            assert [id(p) for p in got["params"]] == \
                [id(p) for p in ref["params"]]
            assert {k: v for k, v in got.items() if k != "params"} == \
                {k: v for k, v in ref.items() if k != "params"}
