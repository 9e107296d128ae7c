"""The plain reference against the program's CPU path, at a size the CPU
runs in seconds: every cell driven end to end by the harness, with the
reference's numbers within the cell's limits; and the reference's pieces
against the program's own oracle."""

import numpy as np
import pytest

from recbench import run, spec
from recbench.reference.hashing import (decimal_bytes, farmhash64,
                                        farmhash64_array)
from recbench.tests import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]] + \
    tiny.held_cells()
SEED = 2**31 + 77


def run_tiny(cell, seed=SEED, trace=False):
    work, cfg, mix = tiny.cell(cell)
    return run.run_cell(cell, work, cfg, mix, tiny.benchmark(cell), seed,
                        0.5, trace, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_cpu_is_correct(cell):
    result = run_tiny(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    names = {m["name"] for m in spec.cell_metrics(tiny.benchmark(cell),
                                                  cell, False)}
    assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"


def test_farmhash_matches_the_programs_oracle():
    from recom_tpu_torch.oracle.hashing import farmhash64 as oracle

    rng = np.random.default_rng(0)
    vals = np.array([bytes(rng.integers(33, 127, int(n)).astype(np.uint8))
                     for n in rng.integers(0, 70, 2000)], dtype=np.bytes_)
    want = np.array([oracle(bytes(v)) for v in vals], np.uint64)
    np.testing.assert_array_equal(farmhash64_array(vals), want)
    assert all(farmhash64(bytes(v)) == int(w) for v, w in zip(vals, want))
    ints = rng.integers(-3, 2**32, 500)
    np.testing.assert_array_equal(
        farmhash64_array(decimal_bytes(ints)),
        np.array([oracle(str(int(i))) for i in ints], np.uint64))


@pytest.mark.parametrize("name", ["model_e", "criteo_dlrm"])
def test_ids_match_the_programs_oracle(name):
    """The reference's ids of every column are the program's oracle's."""
    from recbench import port
    from recbench.reference import ids as ref_ids
    from recbench.traffic import batches
    from recom_tpu_torch.oracle.reference import OracleModel

    cfg = tiny.config(name)
    mix = tiny.mix({"model_e": "closed_c4_b2048",
                    "criteo_dlrm": "criteo_steps_b2048"}[name])
    batch = batches.make_batch(cfg, mix["values"], 64, SEED, 0)
    model = port.model(cfg)
    oracle = OracleModel(model, params={"tables": {}, "tower": {}})
    by_name = {c.name: c for c in model.embedding_columns}
    for cls in spec.classes(cfg):
        ids = ref_ids.class_ids(cls, batch)
        for j, field in enumerate(cls.fields):
            sp = oracle.column_ids(by_name[field], batch)
            got = ids[:, j].reshape(64, -1)
            rows = [got[b][got[b] >= 0].tolist() for b in range(64)]
            want = [[] for _ in range(64)]
            for r, v in zip(sp.row_ids, np.asarray(sp.values)):
                want[r].append(int(v))
            assert rows == want, field
