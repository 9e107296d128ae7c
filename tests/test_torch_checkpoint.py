"""The port's load_checkpoint on the JAX package's checkpoints: where orbax
is installed the JAX ``save_checkpoint`` writes an orbax ``params/``
directory, which the port reads with tensorstore (orbax imports jax).  Every
leaf is `==` the JAX ``load_checkpoint``'s, table names with "/" and "."
included, and an Engine on it serves the JAX Engine's pooled outputs `==`
(the output at rtol 1e-4 / atol 1e-5)."""

import os
import sys

import numpy as np
import pytest

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.ir import spec as js
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.runtime.checkpoint import load_checkpoint as j_load
from recom_tpu.runtime.checkpoint import save_checkpoint as j_save
from recom_tpu_torch import Engine, EngineConfig
from recom_tpu_torch.runtime.checkpoint import (
    export_params,
    load_checkpoint,
    save_checkpoint,
)

CFG = dict(use_pallas=False, persistent_compilation_cache=False)


def _scoped_model(S):
    """Table names with a variable scope's "/" and a "."."""
    tables = {"scope/emb": S.TableSpec("scope/emb", 32, 4),
              "a.b": S.TableSpec("a.b", 16, 4)}
    cols = [
        S.FeatureColumn("c", S.FeatureSource("x", S.FeatureKind.DENSE_INT),
                        (S.HashBucket(32),),
                        S.LookupSpec("scope/emb", S.Combiner.MEAN)),
        S.FeatureColumn("c2", S.FeatureSource("y", S.FeatureKind.DENSE_INT),
                        (S.HashBucket(16),),
                        S.LookupSpec("a.b", S.Combiner.SUM)),
    ]
    return S.ModelSpec("slash", tables, cols,
                       S.TowerSpec(arch="mlp", bottom_mlp=(), top_mlp=(4, 1),
                                   final_activation=None))


def _assert_same_params(ours, theirs):
    assert set(ours["tables"]) == set(theirs["tables"])
    for t, arr in theirs["tables"].items():
        assert ours["tables"][t].dtype == np.asarray(arr).dtype
        np.testing.assert_array_equal(ours["tables"][t], arr, err_msg=t)
    assert set(ours["tower"]) == set(theirs["tower"])
    for key, layers in theirs["tower"].items():
        assert len(ours["tower"][key]) == len(layers)
        for a, b in zip(ours["tower"][key], layers):
            assert set(a) == set(b) == {"w", "b"}
            np.testing.assert_array_equal(a["w"], b["w"])
            np.testing.assert_array_equal(a["b"], b["b"])


@pytest.mark.parametrize("which", ["dlrm", "scoped"])
def test_port_reads_the_jax_orbax_checkpoint(tmp_path, which):
    if which == "dlrm":
        jm = j_make_dlrm(2, 1, 1, 1, 0, 2, [4], [8, 1], name="ck")
    else:
        jm = _scoped_model(js)
    jeng = JEngine(jm, JConfig(**CFG))
    path = str(tmp_path / "ckpt")
    j_save(path, jeng)
    assert os.path.isdir(os.path.join(path, "params"))   # orbax, not npz
    assert not os.path.exists(os.path.join(path, "params.npz"))

    model, params = load_checkpoint(path)
    jmodel, jparams = j_load(path)
    assert model.spec_hash() == jmodel.spec_hash()
    _assert_same_params(params, jparams)

    eng = Engine(model, EngineConfig(**CFG), params=params, device="cpu")
    b = make_random_batch(jm, 16, seed=1)
    out = eng.predict(b, return_pooled=True)
    jout = jeng.predict(b, return_pooled=True)
    for c, p in jout["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][c], p, err_msg=c)
    np.testing.assert_allclose(out["output"], jout["output"], rtol=1e-4,
                               atol=1e-5)
    # and back into a live engine
    eng.reload_params(params)
    _assert_same_params(export_params(eng), jparams)


def test_port_checkpoint_roundtrip_and_jax_reads_it(tmp_path):
    """The port writes npz, which both loaders read."""
    from recom_tpu_torch.models import make_dlrm_model

    tm = make_dlrm_model(2, 1, 1, 1, 0, 2, [4], [8, 1], name="ck")
    eng = Engine(tm, EngineConfig(**CFG), device="cpu")
    path = str(tmp_path / "ck")
    save_checkpoint(path, eng)
    assert os.path.exists(os.path.join(path, "params.npz"))
    _, params = load_checkpoint(path)
    _, jparams = j_load(path)
    _assert_same_params(params, jparams)
    _assert_same_params(params, export_params(eng))


def test_orbax_checkpoint_without_tensorstore_names_item_10(tmp_path,
                                                            monkeypatch):
    jeng = JEngine(_scoped_model(js), JConfig(**CFG))
    path = str(tmp_path / "ck")
    j_save(path, jeng)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    # the message names the package it needs (item 10 of ROADMAP, which
    # it named before, is done)
    with pytest.raises(ImportError, match="tensorstore") as err:
        load_checkpoint(path)
    assert "npz" in str(err.value)
