"""The mesh half of tests/test_fuzz_config.py's sweep through the port:
random models (tests/test_fuzz.py's generator) under random mesh configs
(``chip_smoke.random_config`` with a mesh: its axes, ``shard_comm`` and
``shard_rows_above`` drawn; the shapes (2, 2), (1, 4) and (4, 1) in turn)
served in one gloo world of 4 CPU ranks (tests/torch_mesh_world.py).
``run_config_seed``'s gates: pooled ``==`` the oracle, within rtol / atol
1e-6 on the psum path where a group is striped; the concat ``==``, or
within 1e-6 with post ops or psum; bf16 / int8 against the oracle on the
engine's own ``export_params``.  Every rank returns the whole result, and
all of them are held to each other with ``==``."""

import numpy as np
import pytest

import chip_smoke
import test_fuzz
from recom_tpu.ir.serde import model_to_json
from recom_tpu.oracle import OracleModel
from recom_tpu.utils.params import init_model_params

from test_torch_sharding import _same
from torch_mesh_world import World

SHAPES = ((2, 2), (1, 4), (4, 1))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("fuzz_world"))
    yield w
    w.close()


@pytest.mark.parametrize("seed", range(6))
def test_random_mesh_configs_match_oracle(world, seed):
    rng = np.random.default_rng(7_100_000 + seed)
    model = test_fuzz.random_model(rng, n_cols=int(rng.integers(3, 9)))
    kw = chip_smoke.random_config(rng, mesh_shapes=(SHAPES[seed % 3],))
    batch = test_fuzz.random_batch(rng, model,
                                   batch=int(rng.integers(5, 40)))
    params = init_model_params(model)
    quantized = kw["table_dtype"] != "float32"
    res = world.run("serve", shape=kw["mesh_shape"],
                    model_json=model_to_json(model), cfg=kw, params=params,
                    batches=[batch], concat=True, export=quantized)
    for r in res[1:]:
        _same(r, res[0])
    res = res[0]
    out = res["outs"][0]
    ref = OracleModel(model, params=res["params"] if quantized
                      else params).forward(batch)
    psum = kw["shard_comm"] == "psum" and bool(res["sharded"])
    ctx = f"seed={seed} {kw} striped={res['sharded']}"
    assert set(out["pooled"]) == set(ref["pooled"])
    for c, r in ref["pooled"].items():
        if psum:
            np.testing.assert_allclose(out["pooled"][c], r, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{ctx} col={c}")
        else:
            np.testing.assert_array_equal(out["pooled"][c], r,
                                          err_msg=f"{ctx} col={c}")
    if any(c.post for c in model.columns) or psum:
        np.testing.assert_allclose(out["concat"], ref["concat"], rtol=1e-6,
                                   atol=1e-6, err_msg=ctx)
    else:
        np.testing.assert_array_equal(out["concat"], ref["concat"],
                                      err_msg=ctx)
