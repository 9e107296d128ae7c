"""The port's serving on a mesh (recom_tpu_torch.parallel and the Engine's
mesh path), mirroring the serving tests of tests/test_sharding.py.

Each case runs in a gloo world of 4 CPU processes, spawned once for the
module (tests/torch_mesh_world.py; a FileStore under a temporary directory,
so test workers never race for a port), on mesh shapes (2, 2), (1, 4) and
(4, 1).  Each is held against the JAX mesh Engine (or the JAX op) on the
same shape over the virtual CPU devices of tests/conftest.py, with
``use_pallas=False`` as in test_sharding.py, and against the oracle, with
test_sharding.py's gates: pooled ``==`` under the all-to-all exchange
(chunks 1 and 2, weighted, dedup), column splits and pure data
parallelism; within 1e-6 under psum; outputs within rtol 1e-4 / atol
1e-5; the overflow count equal to JAX's; and the "recompute" / "warn" /
"raise" policies through ``predict`` and ``ServingPipeline``.  Every rank
returns the whole result, and all of them are held to each other with
``==``.  The ``cuda`` case runs a world of 2 ranks that share one card
over gloo (skipped without one).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.ir.serde import model_to_json
from recom_tpu.ir.spec import Combiner
from recom_tpu.models import make_random_batch
from recom_tpu.models.synthetic import make_dlrm_model
from recom_tpu.oracle import OracleModel
from recom_tpu.ops import lookup_xla
from recom_tpu.parallel import (
    all_to_all_group_pooled as j_a2a,
    make_mesh as j_make_mesh,
    sharded_group_pooled as j_psum,
)
from recom_tpu.parallel.sharded_lookup import pad_rows_to_multiple, stripe_rows
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig
from recom_tpu_torch.ir.serde import model_from_json
from recom_tpu_torch.parallel.all_to_all_lookup import (
    a2a_capacity,
    a2a_chunks,
    chunked_positions,
)
from recom_tpu_torch.parallel.mesh import mesh_shape
from recom_tpu_torch.parallel.sharded_lookup import (
    member_stripe,
    stripe_rows as t_stripe_rows,
    unstripe_rows as t_unstripe_rows,
)
from recom_tpu_torch.runtime.checkpoint import export_params

from torch_mesh_world import World

needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("mesh_world"))
    yield w
    w.close()


def _one(results):
    """The result every rank returned, after holding the ranks' results to
    rank 0's with ``==``."""
    for r in results[1:]:
        _same(r, results[0])
    return results[0]


def _same(a, b, path="result"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _data_shards(results, shape):
    """[B, C, d] from the ranks' [b_loc, C, d] data shards: the model ranks
    of one data index agree with ``==``; shards concatenate in data order."""
    d_ax, m_ax = shape
    shards = []
    for r in range(d_ax):
        row = results[r * m_ax:(r + 1) * m_ax]
        for x in row[1:]:
            np.testing.assert_array_equal(x[0], row[0][0])
            assert x[1] == row[0][1]
        shards.append(row[0][0])
    return np.concatenate(shards), results[0][1]


def _assert_pooled(got, want, exact=True):
    assert set(got) == set(want)
    for c, r in want.items():
        if exact:
            np.testing.assert_array_equal(got[c], r, err_msg=c)
        else:
            np.testing.assert_allclose(got[c], r, atol=1e-6, rtol=1e-6,
                                       err_msg=c)


def _cfg(**kw):
    return dict(use_pallas=False, **kw)


def _jax_engine(model, cfg, params):
    return JEngine(model, JConfig(**cfg), params=params)


# --- pure functions --------------------------------------------------------


@pytest.mark.parametrize("shape,world_size,want", [
    (None, 4, (4, 1)), ((-1, 2), 4, (2, 2)), ((1, -1), 4, (1, 4)),
    ((2, 1), 4, (2, 1)),
])
def test_mesh_shape_parses_as_jax(shape, world_size, want):
    assert mesh_shape(shape, world_size) == want


def test_mesh_shape_needing_more_ranks_raises():
    with pytest.raises(ValueError, match="needs 8 ranks, have 4"):
        mesh_shape((2, 4), 4)


@pytest.mark.parametrize("rows,m", [(12, 4), (13, 4), (1, 2), (100, 3)])
def test_member_stripe_places_each_row_on_its_stripe(rows, m):
    """member_stripe puts each of a member's rows, at any row offset, where
    stripe_rows (the JAX package's) puts it, and the copies of the helpers
    match their sources."""
    from recom_tpu.parallel.sharded_lookup import unstripe_rows

    for offset in (0, 1, 5):
        total = offset + rows
        logical = np.arange(total, dtype=np.float32)[:, None]
        phys = stripe_rows(pad_rows_to_multiple(logical, m), m)
        np.testing.assert_array_equal(
            t_stripe_rows(pad_rows_to_multiple(logical, m), m), phys)
        np.testing.assert_array_equal(t_unstripe_rows(phys, m),
                                      unstripe_rows(phys, m))
        per = phys.shape[0] // m
        for k in range(m):
            first, count, start = member_stripe(rows, offset, m, k)
            got = phys[k * per + start: k * per + start + count, 0]
            np.testing.assert_array_equal(
                got, np.arange(offset + first, total, m, dtype=np.float32))


def test_a2a_capacity_and_chunk_positions():
    from recom_tpu.parallel.all_to_all_lookup import a2a_capacity as j_cap

    for n, m, f in ((10, 4, 2.0), (2048, 4, 0.1), (61440, 2, 2.0),
                    (8, 2, 0.01)):
        assert a2a_capacity(n, m, f) == j_cap(n, m, f)
    assert a2a_chunks(24, 5) == 4 and a2a_chunks(8, 3) == 2
    # chunked positions: chunk ck of [m, capc] slots at row ck * m * capc
    m, cap, chunks = 2, 8, 2
    pos = torch.tensor([0, 3, 4, 7, 8, 11, 12, 15, 16, -1])
    got = chunked_positions(pos, m, cap, chunks)
    np.testing.assert_array_equal(
        got.numpy(), [0, 3, 8, 11, 4, 7, 12, 15, 16, -1])


# --- the mesh's collectives ---------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_mesh_collectives_over_each_axis(world, shape):
    res = world.run("collectives", shape=shape)
    d_ax, m_ax = shape
    base = np.arange(6, dtype=np.float32)
    for r, out in enumerate(res):
        assert out["coords"] == (r // m_ax, r % m_ax)
        row = [r // m_ax * m_ax + k for k in range(m_ax)]
        col = [i * m_ax + r % m_ax for i in range(d_ax)]
        for axis, ranks in (("model", row), ("data", col),
                            (None, list(range(4)))):
            np.testing.assert_array_equal(
                out[f"reduce/{axis}"], len(ranks) * base + 10 * sum(ranks))
            np.testing.assert_array_equal(
                out[f"gather/{axis}"],
                np.stack([base[:3] + 10 * q for q in ranks]))
        # slice j of the all_to_all came from model rank j
        want = np.stack([np.arange(2) + 2 * (r % m_ax) + 100 * q
                         for q in row])
        np.testing.assert_array_equal(out["a2a"], want)


# --- op level: psum and all-to-all (test_sharding.py :25-196, :452) --------


def _op_case(seed, C, V, d, B, L, missing, weighted=False, pool=None):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((C * V, d)).astype(np.float32)
    if pool is None:
        ids = rng.integers(0, V, size=(B, C, L)).astype(np.int32)
    else:
        ids = pool[rng.integers(0, len(pool), size=(B, C, L))]
    ids[rng.random((B, C, L)) < missing] = -1
    w = rng.random((B, C, L)).astype(np.float32) if weighted else None
    offs = (np.arange(C) * V).astype(np.int32)
    return table, ids, w, offs


@needs_8
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_group_pooled_matches_single_device(world, shape):
    table, ids, _, offs = _op_case(0, 3, 100, 8, 16, 4, 0.3)
    code = np.array([0, 1, 2], np.int32)
    m = shape[1]
    tp = stripe_rows(pad_rows_to_multiple(table, m), m)
    got, _ = _data_shards(world.run(
        "op_lookup", shape=shape, kind="psum", table=table, ids=ids,
        offs=offs, code=code), shape)
    jmesh = j_make_mesh(shape)
    jout = np.asarray(jax.jit(
        lambda t, i: j_psum(jmesh, t, i, offs, code))(jnp.asarray(tp),
                                                      jnp.asarray(ids)))
    out_1d = np.asarray(lookup_xla.group_pooled(
        jnp.asarray(table), jnp.asarray(ids), offs, code))
    np.testing.assert_allclose(got, jout, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, out_1d, atol=1e-6, rtol=1e-6)


def _a2a_both(world, shape, table, ids, offs, code, w=None, **kw):
    m = shape[1]
    tp = stripe_rows(pad_rows_to_multiple(table, m), m)
    got, ov = _data_shards(world.run(
        "op_lookup", shape=shape, kind="a2a", table=table, ids=ids,
        offs=offs, code=code, weights=w, **kw), shape)
    jmesh = j_make_mesh(shape)
    args = [jnp.asarray(tp), jnp.asarray(ids)]
    if w is not None:
        args.append(jnp.asarray(w))
    jout, jov = jax.jit(lambda t, i, *ww: j_a2a(
        jmesh, t, i, offs, code, weights=ww[0] if ww else None,
        **kw))(*args)
    return got, ov, np.asarray(jout), int(jov)


@needs_8
def test_all_to_all_group_pooled_bitexact_vs_single_device(world):
    table, ids, _, offs = _op_case(1, 3, 128, 8, 32, 4, 0.3)
    code = np.array([0, 1, 2], np.int32)
    got, ov, jout, jov = _a2a_both(world, (2, 2), table, ids, offs, code)
    assert ov == jov == 0
    out_1d = lookup_xla.group_pooled(jnp.asarray(table), jnp.asarray(ids),
                                     offs, code)
    np.testing.assert_array_equal(got, jout)
    np.testing.assert_array_equal(got, np.asarray(out_1d))


@needs_8
def test_all_to_all_weighted_bitexact(world):
    table, ids, w, offs = _op_case(4, 2, 64, 4, 16, 3, 0.4, weighted=True)
    code = np.array([1, 2], np.int32)
    got, ov, jout, jov = _a2a_both(world, (1, 4), table, ids, offs, code, w)
    assert ov == jov == 0
    out_1d = lookup_xla.group_pooled(jnp.asarray(table), jnp.asarray(ids),
                                     offs, code, jnp.asarray(w))
    np.testing.assert_array_equal(got, jout)
    np.testing.assert_array_equal(got, np.asarray(out_1d))


@needs_8
def test_all_to_all_dedup_fits_heavy_duplication_in_tiny_capacity(world):
    """2048 id slots over 8 distinct ids fit a 0.1 capacity factor with the
    dedup, bit-exact; without it the same batch overflows, by the count the
    JAX path reports."""
    rng = np.random.default_rng(9)
    pool = rng.choice(64, size=8, replace=False).astype(np.int32)
    table, ids, _, offs = _op_case(9, 4, 64, 8, 64, 8, 0.2, pool=pool)
    code = np.array([0, 1, 2, 0], np.int32)
    got, ov, jout, jov = _a2a_both(world, (1, 4), table, ids, offs, code,
                                   capacity_factor=0.1, dedup=True)
    assert ov == jov == 0
    np.testing.assert_array_equal(got, jout)
    _, ov_nd, _, jov_nd = _a2a_both(world, (1, 4), table, ids, offs, code,
                                    capacity_factor=0.1, dedup=False)
    assert ov_nd == jov_nd > 0


@needs_8
@pytest.mark.parametrize("code", [[0], [1]])
def test_all_to_all_overflow_counted_and_rows_zeroed(world, code):
    """Every id on model rank 0 past a 0.5 capacity factor: the overflow
    count equals JAX's, and the degraded pooled rows equal JAX's bit for
    bit: an overflowed entry pools as a zero row that still counts in the
    MEAN divisor."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((64, 4)).astype(np.float32)
    ids = (rng.integers(0, 16, size=(64, 1, 4)) * 4).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    offs = np.zeros((1,), np.int32)
    got, ov, jout, jov = _a2a_both(world, (1, 4), table, ids, offs,
                                   np.array(code, np.int32),
                                   capacity_factor=0.5)
    assert ov == jov > 0
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, jout)


@needs_8
def test_a2a_chunked_return_bitexact(world):
    """chunks > 1 returns the rows in capacity slices: bit-identical to one
    exchange and to the single-device pooling, chunk counts that do not
    divide the capacity included."""
    table, ids, _, offs = _op_case(3, 3, 128, 8, 16, 5, 0.3)
    code = np.array([0, 1, 2], np.int32)
    out_1d = np.asarray(lookup_xla.group_pooled(
        jnp.asarray(table), jnp.asarray(ids), offs, code))
    for chunks in (1, 2, 3):
        got, ov, jout, jov = _a2a_both(world, (2, 2), table, ids, offs,
                                       code, chunks=chunks)
        assert ov == jov == 0
        np.testing.assert_array_equal(got, jout)
        np.testing.assert_array_equal(got, out_1d)


# --- the Engine on a mesh (test_sharding.py :200-448) ----------------------


def _serve(world, shape, model, cfg, params, batches, **kw):
    return _one(world.run("serve", shape=shape,
                          model_json=model_to_json(model),
                          cfg=cfg, params=params, batches=batches, **kw))


@needs_8
@pytest.mark.parametrize("chunks", [1, 2])
def test_engine_all_to_all_bitexact_vs_oracle(world, chunks):
    m = make_dlrm_model(4, 2, 2, 2, 1, 4, [8], [16], name="sharda2a",
                        large_rows=4096)
    cfg = _cfg(mesh_shape=(2, 2), shard_rows_above=2048,
               batch_buckets=(32, 64), shard_comm="all_to_all",
               a2a_chunks=chunks)
    params = init_model_params(m)
    b = make_random_batch(m, 32, seed=2)
    res = _serve(world, (2, 2), m, cfg, params, [b])
    assert res["sharded"]
    assert res["stats"].get("a2a_overflow", 0) == 0
    assert "all_to_all/model" in res["collectives"]
    out = res["outs"][0]
    ref = OracleModel(m, params=params).forward(b)
    _assert_pooled(out["pooled"], ref["pooled"])
    jout = _jax_engine(m, cfg, params).predict(b, return_pooled=True)
    _assert_pooled(out["pooled"], jout["pooled"])
    np.testing.assert_allclose(out["output"], jout["output"], atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(out["output"], ref["output"], atol=1e-5,
                               rtol=1e-4)


@needs_8
@pytest.mark.parametrize("comm", ["auto", "psum"])
def test_sharded_engine_matches_oracle(world, comm):
    m = make_dlrm_model(4, 2, 2, 2, 1, 4, [8], [16], name="shard",
                        large_rows=4096)
    cfg = _cfg(mesh_shape=(2, 2), shard_rows_above=2048,
               batch_buckets=(32, 64), shard_comm=comm)
    params = init_model_params(m)
    b = make_random_batch(m, 30, seed=2)
    res = _serve(world, (2, 2), m, cfg, params, [b])
    assert res["sharded"], "expected sharded groups"
    if comm == "psum":
        assert "all_reduce/model" in res["collectives"]
    out = res["outs"][0]
    ref = OracleModel(m, params=params).forward(b)
    _assert_pooled(out["pooled"], ref["pooled"], exact=False)
    jout = _jax_engine(m, cfg, params).predict(b, return_pooled=True)
    _assert_pooled(out["pooled"], jout["pooled"], exact=False)
    for want in (ref["output"], jout["output"]):
        np.testing.assert_allclose(out["output"], want, atol=1e-5, rtol=1e-4)


@needs_8
def test_pure_data_parallel_unsharded_tables_bitexact(world):
    m = make_dlrm_model(4, 2, 2, 1, 0, 2, [4], [8], name="dp")
    cfg = _cfg(mesh_shape=(4, 1), batch_buckets=(32, 64))
    params = init_model_params(m)
    b = make_random_batch(m, 32, seed=3)
    res = _serve(world, (4, 1), m, cfg, params, [b], concat=True)
    assert not res["sharded"]
    assert set(l for l, _ in res["layouts"].values()) == {"replicated"}
    out = res["outs"][0]
    ref = OracleModel(m, params=params).forward(b)
    _assert_pooled(out["pooled"], ref["pooled"])
    jout = _jax_engine(m, cfg, params).predict(b, return_pooled=True,
                                               return_concat=True)
    _assert_pooled(out["pooled"], jout["pooled"])
    np.testing.assert_allclose(out["concat"], jout["concat"], atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(out["output"], jout["output"], atol=1e-5,
                               rtol=1e-4)


@needs_8
def test_dim_sharded_tensor_parallel_bitexact(world):
    m = make_dlrm_model(0, 2, 2, 2, 0, 2, [4], [8], name="dimshard", dim=8)
    cfg = _cfg(mesh_shape=(1, 4), dim_shard_above=4, batch_buckets=(32,))
    params = init_model_params(m)
    b = make_random_batch(m, 32, seed=7)
    res = _serve(world, (1, 4), m, cfg, params, [b])
    assert res["dim_sharded"], "expected dim-sharded groups"
    assert not res["sharded"]
    assert "all_gather/model" in res["collectives"]
    out = res["outs"][0]
    ref = OracleModel(m, params=params).forward(b)
    _assert_pooled(out["pooled"], ref["pooled"])
    jeng = _jax_engine(m, cfg, params)
    assert sorted(jeng._dim_sharded_gids) == res["dim_sharded"]
    jout = jeng.predict(b, return_pooled=True)
    _assert_pooled(out["pooled"], jout["pooled"])
    np.testing.assert_allclose(out["output"], jout["output"], atol=1e-5,
                               rtol=1e-4)


OVF = (0, 0, 0, 0, 1, 2, [4], [8])


def _ovf_setup(name):
    m = make_dlrm_model(*OVF, name=name, large_rows=4096)
    base = _cfg(mesh_shape=(2, 2), shard_rows_above=2048,
                batch_buckets=(32,), shard_comm="all_to_all",
                a2a_capacity_factor=0.01)
    return m, base, make_random_batch(m, 32, seed=3, max_list_len=16), \
        init_model_params(m)


@needs_8
def test_a2a_overflow_policy_recompute_warn_raise(world):
    """An overflowing step: "recompute" re-runs it losslessly (pooled ==
    the oracle), "warn" keeps the degraded result (== JAX's, with JAX's
    count), "raise" raises on every rank."""
    m, base, b, params = _ovf_setup("ovf")
    ref = OracleModel(m, params=params).forward(b)
    jw = _jax_engine(m, dict(base, a2a_overflow_policy="warn"), params)
    jout_w = jw.predict(b, return_pooled=True)
    assert jout_w["a2a_overflow"] > 0

    res = _serve(world, (2, 2), m, base, params, [b])
    out = res["outs"][0]
    assert res["stats"]["a2a_recomputes"] == 1
    assert res["stats"]["a2a_overflow"] == jout_w["a2a_overflow"]
    assert out["a2a_overflow"] == 0
    _assert_pooled(out["pooled"], ref["pooled"])

    res_w = _serve(world, (2, 2), m, dict(base, a2a_overflow_policy="warn"),
                   params, [b])
    out_w = res_w["outs"][0]
    assert out_w["a2a_overflow"] == jout_w["a2a_overflow"]
    assert "a2a_recomputes" not in res_w["stats"]
    _assert_pooled(out_w["pooled"], jout_w["pooled"])
    np.testing.assert_allclose(out_w["output"], jout_w["output"], atol=1e-5,
                               rtol=1e-4)

    res_r = world.run("serve", shape=(2, 2), model_json=model_to_json(m),
                      cfg=dict(base, a2a_overflow_policy="raise"),
                      params=params, batches=[b])
    for r in res_r:
        assert "overflow" in r["outs"][0]["raised"]
        assert r["stats"]["a2a_overflow"] == jout_w["a2a_overflow"]


@needs_8
def test_sharded_softmax_combiner_bitexact(world):
    """Combiner.SOFTMAX on a row-sharded (a2a) group: the host softmaxes
    the staged scores, the exchange pools them as a weighted SUM."""
    from recom_tpu.ir.spec import (
        FeatureColumn, FeatureKind, FeatureSource, LookupSpec, ModelSpec,
        NumToId, TableSpec, TowerSpec,
    )

    V = 4096
    m = ModelSpec(
        "shsmx",
        {"big": TableSpec("big", V, 4), "small": TableSpec("small", 32, 4)},
        [
            FeatureColumn(
                "sm", FeatureSource("sm", FeatureKind.INT_LIST),
                (NumToId(V),),
                LookupSpec("big", Combiner.SOFTMAX, weight_field="w"),
            ),
            FeatureColumn(
                "pl", FeatureSource("pl", FeatureKind.INT_LIST),
                (NumToId(32),), LookupSpec("small", Combiner.MEAN),
            ),
        ],
        TowerSpec(arch="mlp", top_mlp=(), final_activation=None),
    )
    rng = np.random.default_rng(6)
    lens = rng.integers(0, 6, 24)
    batch = {
        "sm": [list(rng.integers(-1, V, int(n))) for n in lens],
        "pl": [list(rng.integers(0, 32, 3)) for _ in lens],
    }
    batch["w"] = [list((rng.standard_normal(len(r)) * 2).astype(np.float32))
                  for r in batch["sm"]]
    cfg = _cfg(mesh_shape=(1, 4), shard_rows_above=2048,
               batch_buckets=(24,), shard_comm="all_to_all")
    params = init_model_params(m)
    res = _serve(world, (1, 4), m, cfg, params, [batch])
    assert res["sharded"]
    out = res["outs"][0]
    ref = OracleModel(m, params=params).forward(batch)
    _assert_pooled(out["pooled"], ref["pooled"])
    jout = _jax_engine(m, cfg, params).predict(batch, return_pooled=True)
    _assert_pooled(out["pooled"], jout["pooled"])


@needs_8
def test_serving_pipeline_applies_a2a_overflow_policy(world):
    """The pipeline applies the policy as predict does: "recompute" serves
    the lossless output (== sequential predict, == JAX's within the tower
    tolerance) and counts it; "raise" fails each request's Future."""
    m, base, b, params = _ovf_setup("povf")
    batches = [b, make_random_batch(m, 32, seed=4, max_list_len=16)]
    res = _one(world.run("pipeline", shape=(2, 2),
                         model_json=model_to_json(m), cfg=base,
                         params=params, batches=batches, prep_workers=1,
                         max_inflight=1))
    for g, w in zip(res["got"], res["want"]):
        np.testing.assert_array_equal(g, w)
    assert res["pipe_stats"]["a2a_recomputes"] >= 1
    assert res["stats"]["a2a_recomputes"] > \
        res["stats_before"]["a2a_recomputes"]
    jeng = _jax_engine(m, base, params)
    for g, bt in zip(res["got"], batches):
        np.testing.assert_allclose(g, jeng.predict(bt)["output"], atol=1e-5,
                                   rtol=1e-4)

    res_r = _one(world.run("pipeline", shape=(2, 2),
                           model_json=model_to_json(m),
                           cfg=dict(base, a2a_overflow_policy="raise"),
                           params=params, batches=batches[:1],
                           prep_workers=1, max_inflight=1, retries=0))
    assert "overflow" in res_r["got"][0]["raised"]


def test_serving_pipeline_on_a_mesh_dispatches_in_submission_order(world):
    """Several prep workers and batches of three sizes (so preps end out of
    order): each rank dispatches in submission order, so every output ==
    sequential predict, on every rank."""
    m = make_dlrm_model(4, 2, 2, 2, 1, 4, [8], [16], name="pipe",
                        large_rows=4096)
    cfg = _cfg(mesh_shape=(2, 2), shard_rows_above=2048,
               batch_buckets=(8, 32, 128), shard_comm="all_to_all",
               dim_shard_above=4)
    params = init_model_params(m)
    sizes = [128, 8, 32, 128, 8, 8, 32, 128, 16, 8]
    batches = [make_random_batch(m, s, seed=50 + i)
               for i, s in enumerate(sizes)]
    res = _one(world.run("pipeline", shape=(2, 2),
                         model_json=model_to_json(m), cfg=cfg,
                         params=params, batches=batches, prep_workers=4,
                         max_inflight=6))
    for g, w in zip(res["got"], res["want"]):
        np.testing.assert_array_equal(g, w)
    assert res["pipe_stats"]["completed"] == len(batches)


@pytest.mark.parametrize("dim_shard", [None, 4])
def test_mesh_engine_with_pallas_matches_oracle_and_one_device(world,
                                                               dim_shard):
    """``use_pallas=True`` on the port's side (K1's plain version on the
    CPU for the one-hot groups, on each rank's data slice): pooled == the
    oracle and == the port's single-device Engine, outputs == it too (a
    row's tower result does not depend on the batch it rides in)."""
    # the 2 x 10 000-row string groups stay under shard_rows_above, so
    # dim_shard_above splits them; the 2^15-row list group is striped
    m = make_dlrm_model(4, 2, 2, 2, 1, 4, [8], [16], name="pal",
                        large_rows=1 << 15)
    cfg = dict(use_pallas=True, mesh_shape=(2, 2), shard_rows_above=25_000,
               batch_buckets=(32,), shard_comm="all_to_all",
               dim_shard_above=dim_shard)
    params = init_model_params(m)
    b = make_random_batch(m, 32, seed=11)
    res = _serve(world, (2, 2), m, cfg, params, [b], concat=True)
    assert res["sharded"]
    assert any(k.startswith("onehot") for _, k in res["layouts"].values())
    assert bool(res["dim_sharded"]) == (dim_shard is not None)
    out = res["outs"][0]
    ref = OracleModel(m, params=params).forward(b)
    _assert_pooled(out["pooled"], ref["pooled"])
    one = dict(cfg, mesh_shape=None)
    tm = model_from_json(model_to_json(m))
    sout = Engine(tm, EngineConfig(**one), params=params,
                  device="cpu").predict(b, return_pooled=True,
                                        return_concat=True)
    _assert_pooled(out["pooled"], sout["pooled"])
    np.testing.assert_array_equal(out["concat"], sout["concat"])
    np.testing.assert_array_equal(out["output"], sout["output"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mesh_export_update_and_reload(world, dtype):
    """export_params of a mesh Engine == the single-device Engine's, bit for
    bit, in every stored dtype; update_table_rows on a striped row and on a
    column-split row is read back by predict on every rank (pooled == the
    single-device Engine's after the same updates) and by export_params;
    reload_params re-stripes."""
    m = make_dlrm_model(4, 2, 2, 2, 1, 4, [8], [16], name="life",
                        large_rows=1 << 15)
    cfg = _cfg(mesh_shape=(2, 2), shard_rows_above=25_000, dim_shard_above=4,
               batch_buckets=(32,), shard_comm="all_to_all",
               table_dtype=dtype)
    params = init_model_params(m)
    rng = np.random.default_rng(12)
    b = make_random_batch(m, 32, seed=12)
    ids_big = np.array([0, 5, (1 << 15) - 1, 5, 1234])
    ids_str = np.array([3, 9999, 0])
    updates = [
        ("emb_large_sparse0", ids_big,
         rng.standard_normal((5, 32)).astype(np.float32)),
        ("emb_sparse0", ids_str,
         rng.standard_normal((3, 8)).astype(np.float32)),
    ]
    res = _one(world.run("lifecycle", shape=(2, 2),
                         model_json=model_to_json(m), cfg=cfg,
                         params=params, batch=b, updates=updates))
    shapes = res["leaf_shapes"]
    one = Engine(model_from_json(model_to_json(m)),
                 EngineConfig(**dict(cfg, mesh_shape=None)), params=params,
                 device="cpu")
    _same(res["before"], export_params(one))
    want0 = one.predict(b, return_pooled=True)
    assert res["hits"] == [one.update_table_rows(*u) for u in updates]
    want = one.predict(b, return_pooled=True)
    _same(res["after"], export_params(one))
    _assert_pooled(res["out"]["pooled"], want["pooled"])
    _assert_pooled(res["reloaded"]["pooled"], want0["pooled"])
    # the striped leaf holds half the rows, the split ones half the columns
    big = [g for g in one.compiled.groups if g.dim == 32][0]
    assert shapes[str(big.gid)][0] == big.stacked_rows // 2
    assert any(s[1] == 4 for s in shapes.values())


# --- the card: a world of 2 ranks sharing one card over gloo ----------------


@pytest.mark.cuda
def test_mesh_on_one_card_matches_single_device(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = make_dlrm_model(4, 2, 2, 2, 1, 4, [8], [16], name="card",
                        large_rows=4096)
    params = init_model_params(m)
    b = make_random_batch(m, 64, seed=21)
    tm = model_from_json(model_to_json(m))
    single = Engine(tm, EngineConfig(batch_buckets=(64,)), params=params,
                    device="cuda").predict(b, return_pooled=True)
    w = World(2, tmp_path, device="cuda:0")
    try:
        for comm in ("all_to_all", "psum"):
            cfg = dict(mesh_shape=(1, 2), shard_rows_above=2048,
                       batch_buckets=(64,), shard_comm=comm,
                       dim_shard_above=4)
            res = _one(w.run("serve", shape=(1, 2),
                             model_json=model_to_json(m), cfg=cfg,
                             params=params, batches=[b]))
            out = res["outs"][0]
            _assert_pooled(out["pooled"], single["pooled"],
                           exact=comm != "psum")
            np.testing.assert_allclose(out["output"], single["output"],
                                       atol=1e-5, rtol=1e-4)
    finally:
        w.close()
