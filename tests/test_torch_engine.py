"""The port's Engine end to end on the CPU (every kernel's plain version)
against the JAX Engine and the JAX NumPy oracle, on mini model E with the
params carried across from the JAX engine via export_params.  Pooled
outputs are held exactly (``==``) for every column; the tower output at
rtol 1e-4 / atol 1e-5 (the towers sum in different orders), the tolerance
of tests/test_engine.py."""

import numpy as np
import pytest
import torch

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.ir import spec as js
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.oracle import OracleModel
from recom_tpu.runtime.checkpoint import export_params
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig
from recom_tpu_torch.ir import spec as ts
from recom_tpu_torch.models import make_dlrm_model as t_make_dlrm
from recom_tpu_torch.models import make_random_batch as t_make_batch
from recom_tpu_torch.ops import kernels

torch.set_num_threads(1)

MINI_E = (6, 2, 2, 2, 1, 4, [8], [16])
CONFIGS = {
    "default": {},
    "no_pallas": {"use_pallas": False},
    "structured": {"wire_pack": False, "device_hash": False},
}


def _assert_matches(out, jout, ref, atol=1e-5):
    assert set(out["pooled"]) == set(ref["pooled"])
    for col, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], r, err_msg=col)
        np.testing.assert_array_equal(out["pooled"][col], jout["pooled"][col],
                                      err_msg=col)
    np.testing.assert_allclose(out["output"], ref["output"], rtol=1e-4,
                               atol=atol)
    np.testing.assert_allclose(out["output"], jout["output"], rtol=1e-4,
                               atol=atol)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mini_model_e_matches_jax_engine_and_oracle(name):
    kw = CONFIGS[name]
    jm = j_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    batch = make_random_batch(jm, 70, seed=2)
    jeng = JEngine(jm, JConfig(**kw))
    params = export_params(jeng)
    eng = Engine(tm, EngineConfig(**kw), params=params, device="cpu")
    assert eng.device.type == "cpu"
    onehot = [g for g in eng.compiled.groups if g.pallas_vocab is not None]
    assert bool(onehot) == (name != "no_pallas")
    out = eng.predict(batch, return_pooled=True, return_concat=True)
    jout = jeng.predict(batch, return_pooled=True, return_concat=True)
    ref = OracleModel(jm, params).forward(batch)
    _assert_matches(out, jout, ref)
    np.testing.assert_array_equal(out["concat"][:, :4], ref["concat"][:, :4])
    np.testing.assert_array_equal(out["concat"], jout["concat"])
    assert out["output"].shape == (70, 1)
    assert eng.stats["calls"] == 1


def _clamp_model(S):
    """HashBucket(1000) over a vocab-100 table (admitted with a warning):
    ids >= 100 clamp to row 99 of THAT member (tests/test_clamp.py)."""
    tables = {"a": S.TableSpec("a", 100, 4), "b": S.TableSpec("b", 100, 4)}
    K, C = S.FeatureKind, S.Combiner
    cols = [
        S.FeatureColumn("a", S.FeatureSource("a", K.DENSE_INT),
                        (S.HashBucket(1000),), S.LookupSpec("a", C.MEAN)),
        S.FeatureColumn("b", S.FeatureSource("b", K.DENSE_INT),
                        (S.HashBucket(50),), S.LookupSpec("b", C.MEAN)),
        S.FeatureColumn("l", S.FeatureSource("l", K.INT_LIST),
                        (S.NumToId(1000),), S.LookupSpec("b", C.SUM)),
    ]
    tower = S.TowerSpec(arch="mlp", bottom_mlp=(), top_mlp=(4, 1),
                        final_activation=None)
    return S.ModelSpec("clamp", tables, cols, tower)


@pytest.mark.parametrize("name", ["default", "structured"])
def test_overrange_ids_clamp_to_member_like_jax(name):
    kw = dict(CONFIGS[name], batch_buckets=(64,))
    jm, tm = _clamp_model(js), _clamp_model(ts)
    params = init_model_params(jm)
    rng = np.random.default_rng(0)
    batch = {
        "a": np.arange(64, dtype=np.int64) * 7 + 1,
        "b": np.arange(64, dtype=np.int64),
        "l": [list(rng.integers(0, 1000, int(n)))
              for n in rng.integers(0, 5, 64)],
    }
    jout = JEngine(jm, JConfig(**kw), params=params).predict(
        batch, return_pooled=True)
    out = Engine(tm, EngineConfig(**kw), params=params,
                 device="cpu").predict(batch, return_pooled=True)
    for k in jout["pooled"]:
        np.testing.assert_array_equal(out["pooled"][k], jout["pooled"][k],
                                      err_msg=k)
    np.testing.assert_allclose(out["output"], jout["output"], rtol=1e-4,
                               atol=1e-5)


def _weighted_model(S):
    """Weighted MEAN, SOFTMAX and SQRTN columns beside the main-path kinds."""
    K, C = S.FeatureKind, S.Combiner
    tables = {
        "t_w": S.TableSpec("t_w", 120, 8),
        "t_sm": S.TableSpec("t_sm", 64, 8),
        "t_sp": S.TableSpec("t_sp", 5000, 8),
        "t_bz": S.TableSpec("t_bz", 11, 8),
    }
    cols = [
        S.FeatureColumn("w", S.FeatureSource("w", K.INT_LIST),
                        (S.NumToId(120, default_id=0),),
                        S.LookupSpec("t_w", C.MEAN, weight_field="w_wt")),
        S.FeatureColumn("sm", S.FeatureSource("sm", K.INT_LIST),
                        (S.NumToId(64, default_id=0),),
                        S.LookupSpec("t_sm", C.SOFTMAX,
                                     weight_field="sm_wt")),
        S.FeatureColumn("sp", S.FeatureSource("sp", K.STRING_LIST,
                                              delimiter=";"),
                        (S.HashBucket(5000),), S.LookupSpec("t_sp", C.SQRTN)),
        S.FeatureColumn("bz", S.FeatureSource("bz", K.DENSE_FLOAT),
                        (S.Bucketize(list(range(0, 50, 5))),),
                        S.LookupSpec("t_bz", C.MEAN)),
        S.FeatureColumn("d0", S.FeatureSource("d0", K.DENSE_FLOAT)),
    ]
    tower = S.TowerSpec(arch="mlp", bottom_mlp=(4,), top_mlp=(8, 1))
    return S.ModelSpec("wsink", tables, cols, tower)


def test_weighted_combiners_match_jax_and_oracle():
    jm, tm = _weighted_model(js), _weighted_model(ts)
    params = init_model_params(jm)
    batch = make_random_batch(jm, 29, seed=5)
    jout = JEngine(jm, JConfig(), params=params).predict(
        batch, return_pooled=True)
    out = Engine(tm, EngineConfig(), params=params, device="cpu").predict(
        batch, return_pooled=True)
    ref = OracleModel(jm, params).forward(batch)
    _assert_matches(out, jout, ref)


def test_engine_defaults_to_cuda_and_never_falls_back():
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    if torch.cuda.is_available():
        assert Engine(tm).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(tm)


def test_unported_features_raise():
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    # a mesh serves (tests/test_torch_sharding.py) over an initialised
    # torch.distributed world, and refuses to start without one
    with pytest.raises(RuntimeError, match="process group"):
        Engine(tm, EngineConfig(mesh_shape=(1, 2)), device="cpu")
    # bf16 and int8 tables serve (tests/test_torch_quant.py), and the
    # parameter lifecycle (item 10) is ported in every stored dtype
    # (tests/test_torch_update.py): it refuses bad input, not the feature
    from recom_tpu_torch.runtime.checkpoint import export_params

    for dtype in ("float32", "bfloat16", "int8"):
        eng = Engine(tm, EngineConfig(table_dtype=dtype), device="cpu")
        with pytest.raises(ValueError, match="no table"):
            eng.reload_params({"tables": {}, "tower": {}})
        assert eng.update_table_rows("emb_sparse0", [0],
                                     np.zeros((1, 8))) == 1
        eng.reload_params(export_params(eng))


def test_cpu_path_launches_no_kernel():
    """On CPU tensors every wrapper takes its plain version: no launch."""
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    eng = Engine(tm, device="cpu")
    before = dict(kernels.launches)
    eng.predict(t_make_batch(tm, 9, seed=1))
    assert kernels.launches == before


@pytest.mark.cuda
def test_mini_model_e_on_card_matches_oracle_and_launches_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jm = j_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    params = init_model_params(jm)
    batch = make_random_batch(jm, 70, seed=2)
    eng = Engine(tm, EngineConfig(), params=params, device="cuda")
    kernels.reset_launches()
    out = eng.predict(batch, return_pooled=True)
    # the default path's kernels; K2 runs only where raw floats reach a
    # pure-bucketize group (tests/test_torch_bucketize.py)
    launched = kernels.launches
    assert all(launched[k] > 0 for k in ("K1", "X1", "X2")), launched
    assert launched["K2"] == 0, launched
    ref = OracleModel(jm, params).forward(batch)
    for col, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], r, err_msg=col)
    np.testing.assert_allclose(out["output"], ref["output"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("arch,top,folds", [("mlp", (16, 1), True),
                                            ("dlrm_dot", (16, 1), False),
                                            ("mlp", (), False)])
def test_emb_perm_folds_only_into_an_mlp_tower(arch, top, folds):
    """The reference's rule (recom_tpu/runtime/executor.py:163-167): the
    permutation folds into an MLP tower with top layers, never into the
    order-sensitive dlrm_dot tower or an identity tower."""
    from recom_tpu_torch.runtime.executor import folds_emb_perm

    tower = ts.TowerSpec(arch=arch, bottom_mlp=(8,), top_mlp=top)
    assert folds_emb_perm(tower, 40) is folds
    assert folds_emb_perm(tower, 0) is False
    if arch == "mlp":
        tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
        tm.tower = tower
        assert Engine(tm, device="cpu")._fold_emb_perm is folds


def test_return_concat_builds_its_permutation_once(monkeypatch):
    """``_model_order`` reads the Engine's device copy of emb_perm: no
    index tensor is built from numpy per forward, and the concat stays
    what it was (== the JAX engine on model E at scale 0.02, == the
    oracle on micro-1000, whose identity tower always takes
    _model_order)."""
    from recom_tpu.models.synthetic import make_microbenchmark_model as j_micro
    from recom_tpu.models.synthetic import make_model_e as j_model_e
    from recom_tpu_torch.models import make_model_e as t_model_e
    from recom_tpu_torch.models.synthetic import (
        make_microbenchmark_model as t_micro,
    )

    real = torch.as_tensor
    for jm, tm, seed in ((j_model_e(scale=0.02), t_model_e(scale=0.02), 3),
                         (j_micro(1000, random_boundary=True, seed=0),
                          t_micro(1000, random_boundary=True, seed=0), 4)):
        batch = make_random_batch(jm, 33, seed=seed)
        jeng = JEngine(jm, JConfig())
        params = export_params(jeng)
        eng = Engine(tm, EngineConfig(), params=params, device="cpu")
        perm = eng.compiled.emb_perm
        built = []

        def counting(x, *a, **k):
            if x is perm:
                built.append(1)
            return real(x, *a, **k)

        monkeypatch.setattr(torch, "as_tensor", counting)
        outs = [eng.predict(batch, return_concat=True) for _ in range(2)]
        monkeypatch.setattr(torch, "as_tensor", real)
        assert built == []
        np.testing.assert_array_equal(outs[0]["concat"], outs[1]["concat"])
        if tm.tower.top_mlp:
            want = jeng.predict(batch, return_concat=True)["concat"]
        else:
            want = OracleModel(jm, params).forward(batch)["concat"]
        np.testing.assert_array_equal(outs[0]["concat"], want)
