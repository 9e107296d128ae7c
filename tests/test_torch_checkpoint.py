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


# ---------------------------------------------------------------------------
# an empty tower layer list through a checkpoint
# ---------------------------------------------------------------------------


def _numtab_model(S):
    """tests/test_engine.py:322-331: all-numeric table names and an empty
    ``top_mlp`` (params ``tower: {"top": []}``)."""
    tables = {"0": S.TableSpec("0", 10, 4), "7": S.TableSpec("7", 12, 4)}
    cols = [
        S.FeatureColumn("a", S.FeatureSource("x", S.FeatureKind.INT_LIST),
                        (S.NumToId(10),), S.LookupSpec("0", S.Combiner.SUM)),
        S.FeatureColumn("b", S.FeatureSource("y", S.FeatureKind.INT_LIST),
                        (S.NumToId(12),), S.LookupSpec("7", S.Combiner.MEAN)),
    ]
    return S.ModelSpec("numtab", tables, cols,
                       S.TowerSpec(arch="mlp", top_mlp=(),
                                   final_activation=None))


NUMTAB_BATCH = {"x": [[1], [2], [3, 4]], "y": [[3], [4], [11]]}


def test_numeric_table_names_and_empty_top_through_a_checkpoint(tmp_path):
    """tests/test_engine.py:314-346 on the port: a ``top_mlp=()`` model with
    all-numeric table names saved and loaded serves what it served."""
    from recom_tpu_torch.ir import spec as ts

    eng = Engine(_numtab_model(ts), EngineConfig(**CFG), device="cpu")
    path = str(tmp_path / "ck")
    save_checkpoint(path, eng)
    m2, params2 = load_checkpoint(path)
    assert isinstance(params2["tables"], dict)
    assert set(params2["tables"]) == {"0", "7"}
    assert params2["tower"] == {"top": []}
    eng2 = Engine(m2, EngineConfig(**CFG), params=params2, device="cpu")
    np.testing.assert_array_equal(eng.predict(NUMTAB_BATCH)["output"],
                                  eng2.predict(NUMTAB_BATCH)["output"])


def _empty_top_saved(tmp_path, saved_by):
    """(the JAX Engine of the empty-top model, the path of a training
    checkpoint of it that ``saved_by`` wrote after one step, the step's
    batch and labels)."""
    from recom_tpu.train import Trainer as JTrainer
    from recom_tpu.train import dlrm_optimizer as j_dlrm
    from recom_tpu_torch import Trainer
    from recom_tpu_torch.ir import spec as ts
    from recom_tpu_torch.train import dlrm_optimizer

    jm = _numtab_model(js)
    labels = np.array([1.0, 0.0, 1.0], np.float32)
    path = str(tmp_path / saved_by)
    if saved_by == "jax":
        jtr = JTrainer(jm, JConfig(**CFG), optimizer=j_dlrm())
        jtr.step(NUMTAB_BATCH, labels)
        jtr.save(path)
        assert os.path.isdir(os.path.join(path, "params"))     # orbax
        return jtr.engine, path, labels
    tr = Trainer(_numtab_model(ts), EngineConfig(**CFG),
                 optimizer=dlrm_optimizer(), device="cpu")
    tr.step(NUMTAB_BATCH, labels)
    tr.save(path)
    assert os.path.exists(os.path.join(path, "params.npz"))
    return JEngine(jm, JConfig(**CFG), params=export_params(tr.engine)), \
        path, labels


@pytest.mark.parametrize("into", ["engine", "reload", "restore"])
@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_empty_top_checkpoint_into_engine_reload_and_restore(tmp_path,
                                                             saved_by, into):
    """An empty tower layer list survives the port's npz and the JAX
    package's orbax checkpoint, into each place a checkpoint goes: a new
    Engine and ``reload_params`` serve the saving side's outputs, and
    ``Trainer.restore`` resumes the next step as a trainer that never
    stopped."""
    from recom_tpu_torch import Trainer
    from recom_tpu_torch.train import dlrm_optimizer

    jeng, path, labels = _empty_top_saved(tmp_path, saved_by)
    if into == "restore":
        tr = Trainer.restore(path, EngineConfig(**CFG),
                             optimizer=dlrm_optimizer(), device="cpu")
        assert tr.params["tower"] == {"top": []}
        # the next step == a trainer built from the saved params and
        # optimizer leaves
        model, params = load_checkpoint(path)
        twin = Trainer(model, EngineConfig(**CFG),
                       optimizer=dlrm_optimizer(), params=params,
                       device="cpu")
        with np.load(os.path.join(path, "opt_state.npz")) as data:
            twin.optimizer.load_state_leaves(
                [data[f"leaf{i}"] for i in range(len(data.files))])
        assert tr.step(NUMTAB_BATCH, labels) == \
            twin.step(NUMTAB_BATCH, labels)
        return
    model, params = load_checkpoint(path)
    if into == "engine":
        eng = Engine(model, EngineConfig(**CFG), params=params, device="cpu")
    else:
        # a live engine of the same model on other params
        eng = Engine(model, EngineConfig(**CFG), device="cpu")
        eng.reload_params(params)
    assert params["tower"] == {"top": []}
    want = jeng.predict(NUMTAB_BATCH, return_pooled=True)
    out = eng.predict(NUMTAB_BATCH, return_pooled=True)
    for c, p in want["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][c], p, err_msg=c)
    np.testing.assert_allclose(out["output"], want["output"], rtol=1e-4,
                               atol=1e-5)
