"""The port's parameter lifecycle on the CPU (every kernel's plain version),
mirroring every non-mesh test of tests/test_update.py: after
``update_table_rows`` or ``reload_params`` the Engine serves what a fresh
Engine on the updated params serves (pooled `==` the JAX oracle), and its
``export_params`` is `==` the JAX Engine's after the same calls, on every
single-device layout (stacked gather rows, one-hot planes, bf16, int8).
Besides: updates and reloads write the live tensors in place (a Trainer's
params and optimizer state stay the same objects and keep stepping), and a
request served during updates sees, per column, the old table or the new
one, never a mix."""

import copy
import sys
import threading

import numpy as np
import pytest
import torch

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.ir import spec as js
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.oracle import OracleModel
from recom_tpu.runtime.checkpoint import export_params as j_export
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig, Trainer
from recom_tpu_torch.ir import spec as ts
from recom_tpu_torch.models import make_dlrm_model as t_make_dlrm
from recom_tpu_torch.ops.quant import dequantize_table, quantize_rows_int8
from recom_tpu_torch.runtime.checkpoint import export_params
from recom_tpu_torch.train import dlrm_optimizer, param_leaves


def _pair(shape, name, params=None, **cfg):
    """The JAX and the port's Engine of one model on the same params."""
    jm = j_make_dlrm(*shape, name=name)
    tm = t_make_dlrm(*shape, name=name)
    params = init_model_params(jm) if params is None else params
    jcfg = dict(cfg)
    if jcfg.get("use_pallas", True):
        jcfg["interpret"] = True
    return (jm, params, JEngine(jm, JConfig(**jcfg), params=params),
            Engine(tm, EngineConfig(**cfg), params=params, device="cpu"))


def _updated(np_params, table, rows, vals):
    upd = copy.deepcopy(np_params)
    upd["tables"][table][rows] = vals
    return upd


def _assert_exports_equal(eng, jeng):
    ours, theirs = export_params(eng), j_export(jeng)
    assert set(ours["tables"]) == set(theirs["tables"])
    for t, arr in theirs["tables"].items():
        np.testing.assert_array_equal(ours["tables"][t], arr, err_msg=t)
    for key, layers in theirs["tower"].items():
        for a, b in zip(ours["tower"][key], layers):
            np.testing.assert_array_equal(a["w"], b["w"])
            np.testing.assert_array_equal(a["b"], b["b"])


def _assert_pooled(out, ref):
    for c, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][c], r, err_msg=c)


def test_update_plain_xla_bitexact_vs_oracle():
    m, np_params, jeng, eng = _pair((3, 1, 1, 1, 0, 2, [4], [8, 1]),
                                    "upd_plain", use_pallas=False,
                                    batch_buckets=(16,))
    b = make_random_batch(m, 16, seed=0)
    base = eng.predict(b, return_pooled=True)

    rng = np.random.default_rng(1)
    upd = copy.deepcopy(np_params)
    for t in ("emb_bucketize0", "emb_hash_str0", "emb_sparse0"):
        vocab = m.tables[t].vocab_size
        # every row, in shuffled order: unsorted indices must land
        rows = rng.permutation(vocab)
        vals = rng.standard_normal((rows.size, m.tables[t].dim)).astype(
            np.float32)
        assert eng.update_table_rows(t, rows, vals) == 1
        assert jeng.update_table_rows(t, rows, vals) == 1
        upd["tables"][t][rows] = vals
        _assert_exports_equal(eng, jeng)

    out = eng.predict(b, return_pooled=True)
    _assert_pooled(out, OracleModel(m, params=upd).forward(b))
    assert any(not np.array_equal(base["pooled"][c], out["pooled"][c])
               for c in base["pooled"])
    exported = export_params(eng)
    for t in ("emb_bucketize0", "emb_hash_str0", "emb_sparse0"):
        np.testing.assert_array_equal(exported["tables"][t],
                                      upd["tables"][t], err_msg=t)


def test_update_onehot_layout():
    m, np_params, jeng, eng = _pair((4, 0, 0, 0, 0, 1, [4], [8, 1]),
                                    "upd_pl", batch_buckets=(16,))
    assert any(g.pallas_vocab is not None for g in eng.compiled.groups), \
        "model was expected to take the one-hot layout"
    t = "emb_bucketize2"
    rng = np.random.default_rng(2)
    rows = rng.choice(m.tables[t].vocab_size, size=9, replace=False)
    vals = rng.standard_normal((9, m.tables[t].dim)).astype(np.float32)
    assert eng.update_table_rows(t, rows, vals) == 1
    jeng.update_table_rows(t, rows, vals)
    _assert_exports_equal(eng, jeng)

    b = make_random_batch(m, 16, seed=3)
    out = eng.predict(b, return_pooled=True)
    _assert_pooled(out, OracleModel(
        m, params=_updated(np_params, t, rows, vals)).forward(b))
    np.testing.assert_array_equal(export_params(eng)["tables"][t][rows],
                                  vals)
    # the plane's padding rows past the vocab stay zero
    gid = next(g.gid for g in eng.compiled.groups
               if any(mm.table == t for mm in g.members))
    t3 = eng.device_params["stacked"][str(gid)]
    assert not t3[:, m.tables[t].vocab_size:].any()


def test_update_quantized_int8_requantizes_rows():
    m, np_params, jeng, eng = _pair((2, 1, 1, 1, 0, 2, [4], [8, 1]),
                                    "upd_q", table_dtype="int8",
                                    use_pallas=False, batch_buckets=(16,))
    t = "emb_hash_str0"
    rng = np.random.default_rng(8)
    rows = rng.choice(m.tables[t].vocab_size, size=11, replace=False)
    # rows with very different magnitudes: per-row scales must refresh
    vals = (rng.standard_normal((11, m.tables[t].dim))
            * np.exp(rng.uniform(-4, 4, size=(11, 1)))).astype(np.float32)
    eng.update_table_rows(t, rows, vals)
    jeng.update_table_rows(t, rows, vals)
    _assert_exports_equal(eng, jeng)

    deq = export_params(eng)
    # the reference's rule: the rows re-quantized from the values
    q, s = quantize_rows_int8(vals)
    np.testing.assert_array_equal(deq["tables"][t][rows],
                                  dequantize_table(q, s))
    amax = np.abs(vals).max(axis=1, keepdims=True)
    assert (np.abs(deq["tables"][t][rows] - vals)
            <= amax / 127.0 * 0.5 + 1e-12).all()
    b = make_random_batch(m, 16, seed=9)
    out = eng.predict(b, return_pooled=True)
    _assert_pooled(out, OracleModel(m, params=deq).forward(b))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_update_bf16_rounds_to_nearest_even(use_pallas):
    m, np_params, jeng, eng = _pair((3, 1, 1, 1, 0, 2, [4], [8, 1]),
                                    "upd_bf", table_dtype="bfloat16",
                                    use_pallas=use_pallas,
                                    batch_buckets=(16,))
    rng = np.random.default_rng(12)
    for t in ("emb_bucketize0", "emb_hash_str0"):
        rows = rng.choice(m.tables[t].vocab_size, size=13, replace=False)
        # values with low bits set, ties at the rounding point included
        vals = rng.standard_normal((13, m.tables[t].dim)).astype(np.float32)
        vals.view(np.uint32)[:, 0] = (vals.view(np.uint32)[:, 0]
                                      & 0xFFFF0000) | 0x8000
        eng.update_table_rows(t, rows, vals)
        jeng.update_table_rows(t, rows, vals)
        want = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(export_params(eng)["tables"][t][rows],
                                      want)
    _assert_exports_equal(eng, jeng)
    b = make_random_batch(m, 16, seed=13)
    _assert_pooled(eng.predict(b, return_pooled=True),
                   OracleModel(m, params=export_params(eng)).forward(b))


def test_update_shared_table_updates_every_slot():
    """Two columns sharing one table: a single update is visible through
    BOTH columns."""

    def model(S):
        t = S.TableSpec("shared_t", 64, 4)
        cols = [
            S.FeatureColumn(
                "ca", S.FeatureSource("fa", S.FeatureKind.STRING),
                (S.HashBucket(64),), S.LookupSpec("shared_t",
                                                  S.Combiner.MEAN)),
            S.FeatureColumn(
                "cb", S.FeatureSource("fb", S.FeatureKind.STRING_LIST,
                                      delimiter=","),
                (S.HashBucket(64),), S.LookupSpec("shared_t",
                                                  S.Combiner.SUM)),
        ]
        return S.ModelSpec("upd_shared", {"shared_t": t}, cols,
                           S.TowerSpec(arch="mlp", top_mlp=(8, 1),
                                       final_activation=None))

    jm, tm = model(js), model(ts)
    np_params = init_model_params(jm)
    cfg = dict(use_pallas=False, batch_buckets=(8,))
    jeng = JEngine(jm, JConfig(**cfg), params=np_params)
    eng = Engine(tm, EngineConfig(**cfg), params=np_params, device="cpu")
    rng = np.random.default_rng(10)
    rows = np.arange(64)
    vals = rng.standard_normal((64, 4)).astype(np.float32)
    hits = eng.update_table_rows("shared_t", rows, vals)
    assert hits == jeng.update_table_rows("shared_t", rows, vals) >= 1
    assert hits == sum(mm.table == "shared_t" for g in eng.compiled.groups
                       for mm in g.members)
    _assert_exports_equal(eng, jeng)

    b = {
        "fa": np.asarray([f"s{i}" for i in range(8)]),
        "fb": np.asarray([f"a{i},b{i},c{i}" for i in range(8)]),
    }
    out = eng.predict(b, return_pooled=True)
    ref = OracleModel(jm, params=_updated(np_params, "shared_t", rows,
                                          vals)).forward(b)
    for c in ("ca", "cb"):
        np.testing.assert_array_equal(out["pooled"][c], ref["pooled"][c],
                                      err_msg=c)


def test_update_validation_errors():
    tm = t_make_dlrm(1, 1, 0, 0, 0, 1, [4], [8, 1], name="upd_err")
    eng = Engine(tm, EngineConfig(use_pallas=False, batch_buckets=(8,)),
                 device="cpu")
    before = export_params(eng)
    with pytest.raises(KeyError):
        eng.update_table_rows("nope", [0], np.zeros((1, 8), np.float32))
    with pytest.raises(ValueError):
        eng.update_table_rows("emb_hash_int0", [10 ** 9],
                              np.zeros((1, 8), np.float32))
    with pytest.raises(ValueError):
        eng.update_table_rows("emb_hash_int0", [-1],
                              np.zeros((1, 8), np.float32))
    with pytest.raises(ValueError):  # wrong dim
        eng.update_table_rows("emb_hash_int0", [0],
                              np.zeros((1, 5), np.float32))
    with pytest.raises(ValueError):  # misaligned n
        eng.update_table_rows("emb_hash_int0", [0, 1],
                              np.zeros((1, 8), np.float32))
    # a refused call writes nothing
    after = export_params(eng)
    for t, arr in before["tables"].items():
        np.testing.assert_array_equal(after["tables"][t], arr)
    # reload: a pytree whose shapes differ is refused before any write
    bad = copy.deepcopy(before)
    bad["tables"]["emb_hash_int0"] = bad["tables"]["emb_hash_int0"][:-1]
    with pytest.raises(ValueError, match="emb_hash_int0"):
        eng.reload_params(bad)
    bad = copy.deepcopy(before)
    bad["tower"]["top"][1]["w"] = bad["tower"]["top"][1]["w"][:, :0]
    bad["tables"]["emb_hash_int0"] = bad["tables"]["emb_hash_int0"] + 1
    with pytest.raises(ValueError, match="top"):
        eng.reload_params(bad)
    np.testing.assert_array_equal(
        export_params(eng)["tables"]["emb_hash_int0"],
        before["tables"]["emb_hash_int0"])


def test_reload_params_hot_swap_without_recompile():
    """reload_params writes a whole model's weights into the live engine:
    outputs match the oracle on the new params BIT-exactly (pooled), no
    new program, every tensor written in place."""
    m, p1, jeng, eng = _pair((2, 1, 1, 1, 0, 2, [4], [8, 1]), "reload",
                             use_pallas=False, batch_buckets=(16,))
    b = make_random_batch(m, 16, seed=20)
    out1 = eng.predict(b, return_pooled=True)
    compiles = eng.stats["compiles"]
    ptrs = [t.data_ptr() for t in param_leaves(eng.device_params)]

    p2 = init_model_params(m)
    rng = np.random.default_rng(21)
    for t in p2["tables"]:
        p2["tables"][t] = rng.standard_normal(
            p2["tables"][t].shape).astype(np.float32)
    for layers in p2["tower"].values():
        for layer in layers:
            layer["w"] = rng.standard_normal(layer["w"].shape).astype(
                np.float32)
    eng.reload_params(p2)
    jeng.reload_params(p2)
    out2 = eng.predict(b, return_pooled=True)
    assert eng.stats["compiles"] == compiles, "reload must not recompile"
    assert [t.data_ptr() for t in param_leaves(eng.device_params)] == ptrs

    ref = OracleModel(m, params=p2).forward(b)
    _assert_pooled(out2, ref)
    np.testing.assert_allclose(out2["output"], ref["output"], rtol=1e-4,
                               atol=1e-5)
    # a fresh engine on the new params serves the same bits
    fresh = Engine(t_make_dlrm(2, 1, 1, 1, 0, 2, [4], [8, 1], name="reload"),
                   EngineConfig(use_pallas=False, batch_buckets=(16,)),
                   params=p2, device="cpu")
    np.testing.assert_array_equal(out2["output"], fresh.predict(b)["output"])
    assert any(not np.array_equal(out1["pooled"][c], out2["pooled"][c])
               for c in out1["pooled"])
    _assert_exports_equal(eng, jeng)
    exported = export_params(eng)
    for t in p2["tables"]:
        np.testing.assert_array_equal(exported["tables"][t],
                                      p2["tables"][t], err_msg=t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_reload_params_in_every_stored_dtype(dtype):
    m, p1, jeng, eng = _pair((3, 1, 1, 1, 0, 2, [4], [8, 1]), "reload_dt",
                             table_dtype=dtype, batch_buckets=(16,))
    p2 = copy.deepcopy(p1)
    rng = np.random.default_rng(22)
    for t in p2["tables"]:
        p2["tables"][t] = rng.standard_normal(
            p2["tables"][t].shape).astype(np.float32)
    eng.reload_params(p2)
    jeng.reload_params(p2)
    _assert_exports_equal(eng, jeng)
    fresh = Engine(t_make_dlrm(3, 1, 1, 1, 0, 2, [4], [8, 1],
                               name="reload_dt"),
                   EngineConfig(table_dtype=dtype, batch_buckets=(16,)),
                   params=p2, device="cpu")
    b = make_random_batch(m, 16, seed=23)
    out, want = (e.predict(b, return_pooled=True) for e in (eng, fresh))
    np.testing.assert_array_equal(out["output"], want["output"])
    for c in want["pooled"]:
        np.testing.assert_array_equal(out["pooled"][c], want["pooled"][c])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_update_duplicate_rows_last_wins(dtype):
    """Duplicate row_ids resolve LAST-wins; an int8 row takes its q and
    its scale from the same occurrence."""
    m, np_params, jeng, eng = _pair((1, 1, 0, 0, 0, 1, [4], [8, 1]),
                                    f"dup_{dtype}", table_dtype=dtype,
                                    use_pallas=False, batch_buckets=(8,))
    t = "emb_hash_int0"
    dim = m.tables[t].dim
    # row 7 twice: huge magnitude first, tiny last -- a torn int8 row (q of
    # one, scale of the other) would be wildly off both
    rows = np.array([7, 3, 7])
    vals = np.stack([
        np.full(dim, 1000.0, np.float32),
        np.arange(dim, dtype=np.float32),
        np.full(dim, 1e-3, np.float32),
    ])
    eng.update_table_rows(t, rows, vals)
    jeng.update_table_rows(t, rows, vals)
    _assert_exports_equal(eng, jeng)
    got = export_params(eng)["tables"][t]
    np.testing.assert_allclose(got[7], vals[2], rtol=1 / 127, atol=1e-9,
                               err_msg=dtype)
    np.testing.assert_allclose(got[3], vals[1], rtol=1 / 127, atol=1e-9,
                               err_msg=dtype)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_update_concurrent_with_serving_never_tears(dtype):
    """Requests racing update_table_rows each serve, per column, the OLD or
    the NEW table, never a mix; here the updates flip every table between
    two versions for many rounds, with a short switch interval."""
    shape = (2, 1, 1, 1, 0, 1, [4], [8, 1])
    m, np_params, _, eng = _pair(shape, "upd_race", table_dtype=dtype,
                                 use_pallas=False, batch_buckets=(16,))
    b = make_random_batch(m, 16, seed=30)
    rng = np.random.default_rng(31)
    new_tables = {
        t: rng.standard_normal((spec.vocab_size, spec.dim)).astype(
            np.float32)
        for t, spec in m.tables.items()
    }
    upd = copy.deepcopy(np_params)
    upd["tables"].update(new_tables)
    versions = []
    for p in (np_params, upd):
        fresh = Engine(t_make_dlrm(*shape, name="upd_race"),
                       EngineConfig(table_dtype=dtype, use_pallas=False,
                                    batch_buckets=(16,)),
                       params=p, device="cpu")
        versions.append(fresh.predict(b, return_pooled=True)["pooled"])
    old_tables = {t: np_params["tables"][t] for t in new_tables}

    outs = []
    stop = threading.Event()

    def serve():
        while not stop.is_set() or len(outs) < 8:
            outs.append(eng.predict(b, return_pooled=True)["pooled"])
            if len(outs) > 400:
                break

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    th = threading.Thread(target=serve)
    th.start()
    try:
        for r in range(12):
            for t in new_tables:
                vals = (new_tables if r % 2 == 0 else old_tables)[t]
                eng.update_table_rows(t, np.arange(vals.shape[0]), vals)
    finally:
        stop.set()
        th.join(timeout=120)
        sys.setswitchinterval(interval)
    assert not th.is_alive()

    for pooled in outs:
        for c in pooled:
            assert any(np.array_equal(pooled[c], v[c]) for v in versions), \
                f"torn output in column {c}"
    # the last round wrote the old tables: a request now serves them
    final = eng.predict(b, return_pooled=True)["pooled"]
    for c, r in versions[0].items():
        np.testing.assert_array_equal(final[c], r, err_msg=c)


def test_trainer_keeps_its_tensors_through_reload_and_update():
    """A Trainer's params and optimizer state are the same objects after
    reload_params and update_table_rows, which write in place; the next
    step's loss is a fresh Trainer's first loss on the new params."""
    shape = (6, 2, 2, 2, 1, 4, [8], [16])
    tm = t_make_dlrm(*shape, name="mini", large_rows=20_000)
    jm = j_make_dlrm(*shape, name="mini", large_rows=20_000)
    p1 = init_model_params(jm)
    tr = Trainer(tm, EngineConfig(), optimizer=dlrm_optimizer(),
                 params=p1, device="cpu")
    batch = make_random_batch(jm, 50, seed=3)
    labels = [0, 1] * 25
    tr.step(batch, labels)
    leaves = param_leaves(tr.params)
    ptrs = [x.data_ptr() for x in leaves]
    opt_params = [p for g in tr.optimizer.param_groups for p in g["params"]]
    state = [tr.optimizer.state[p] for p in opt_params]

    p2 = init_model_params(jm)
    rng = np.random.default_rng(5)
    for t in p2["tables"]:
        p2["tables"][t] = rng.standard_normal(
            p2["tables"][t].shape).astype(np.float32) * 0.1
    tr.engine.reload_params(p2)
    now = param_leaves(tr.params)
    assert all(a is b for a, b in zip(now, leaves))
    assert [x.data_ptr() for x in now] == ptrs
    assert all(x.requires_grad for x in now)
    assert [p for g in tr.optimizer.param_groups
            for p in g["params"]] == opt_params
    assert all(tr.optimizer.state[p] is s
               for p, s in zip(opt_params, state))

    fresh = Trainer(tm, EngineConfig(), optimizer=dlrm_optimizer(),
                    params=p2, device="cpu")
    loss = tr.step(batch, labels)
    np.testing.assert_allclose(loss, fresh.step(batch, labels), rtol=1e-6)

    # an update after the step: still the same tensors, and the engine
    # serves the written rows
    vals = rng.standard_normal((4, 8)).astype(np.float32)
    tr.engine.update_table_rows("emb_sparse0", [0, 5, 9, 2], vals)
    assert all(a is b for a, b in zip(param_leaves(tr.params), leaves))
    np.testing.assert_array_equal(
        export_params(tr.engine)["tables"]["emb_sparse0"][[0, 5, 9, 2]],
        vals)
    tr.step(batch, labels)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_update_and_reload_on_card(dtype):
    """On the card: updates and reloads land in place, the exports are the
    CPU engine's after the same calls, and the engine serves a fresh
    engine's pooled outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape = (4, 1, 1, 1, 1, 2, [4], [8, 1])
    jm = j_make_dlrm(*shape, name="upd_card", large_rows=20_000)
    params = init_model_params(jm)
    cfg = EngineConfig(table_dtype=dtype, batch_buckets=(16,))
    engines = [Engine(t_make_dlrm(*shape, name="upd_card",
                                  large_rows=20_000), cfg, params=params,
                      device=d) for d in ("cuda", "cpu")]
    rng = np.random.default_rng(3)

    def ptrs(eng):      # an int8 table is a QuantizedTable: rows, scales
        return [x.data_ptr() for t in param_leaves(eng.device_params)
                for x in (t if isinstance(t, tuple) else (t,))]

    before = ptrs(engines[0])
    p2 = copy.deepcopy(params)
    for t in p2["tables"]:
        p2["tables"][t] = rng.standard_normal(
            p2["tables"][t].shape).astype(np.float32)
    rows = np.array([5, 1, 5, 19_999, 0])
    vals = rng.standard_normal((5, 32)).astype(np.float32)
    for eng in engines:
        eng.reload_params(p2)
        eng.update_table_rows("emb_large_sparse0", rows, vals)
        eng.update_table_rows("emb_bucketize1", [3], vals[:1, :8])
    assert ptrs(engines[0]) == before
    card, cpu = (export_params(e) for e in engines)
    for t, arr in cpu["tables"].items():
        np.testing.assert_array_equal(card["tables"][t], arr, err_msg=t)
    fresh = Engine(t_make_dlrm(*shape, name="upd_card", large_rows=20_000),
                   cfg, params=card, device="cuda")
    b = make_random_batch(jm, 16, seed=4)
    out, want = (e.predict(b, return_pooled=True) for e in (engines[0], fresh))
    for c in want["pooled"]:
        np.testing.assert_array_equal(out["pooled"][c], want["pooled"][c])
