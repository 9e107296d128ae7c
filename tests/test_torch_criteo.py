"""The port's Criteo DLRM (recom_tpu_torch/models/criteo.py, the DLRM of
Naumov et al. 2019 with a ``dlrm_dot`` tower) on the CPU, where every
kernel runs its plain version, against the JAX Engine and Trainer and the
JAX NumPy oracle.  Pooled outputs are held exactly (``==``); outputs at
rtol 1e-4 / atol 1e-5 (tests/test_engine.py's test_dlrm_dot_tower); one
step's gradients at rtol 1e-4 / atol 1e-6 and three dlrm_optimizer losses
at rtol 1e-4 (tests/test_torch_train.py).  The d = 64 model's six vocabs
spread its columns over four one-hot groups (V_pad 128 + 256, 1024, 2304)
and one gather group, so the tower's Gram matrix reads the embeddings in
model order, not in group order."""

import dataclasses

import numpy as np
import pytest
import torch

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.ir import spec as jspec
from recom_tpu.models.criteo import make_criteo_dlrm as j_criteo
from recom_tpu.models.criteo import read_criteo_tsv as j_read_tsv
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.oracle import OracleModel
from recom_tpu.runtime.checkpoint import export_params as j_export
from recom_tpu.runtime.checkpoint import load_checkpoint as j_load
from recom_tpu.train import Trainer as JTrainer
from recom_tpu.train import dlrm_optimizer as j_dlrm
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig, Trainer
from recom_tpu_torch.models import make_criteo_dlrm as t_criteo
from recom_tpu_torch.models import read_criteo_tsv as t_read_tsv
from recom_tpu_torch.ir import spec as tspec
from recom_tpu_torch.ops import kernels
from recom_tpu_torch.runtime.checkpoint import export_params as t_export
from recom_tpu_torch.train import dlrm_optimizer
from test_torch_train import _close, _jax_value_and_grad, _labels

torch.set_num_threads(1)

# one-hot groups at V_pad 128 (3), 256 (155), 1024 (976) and 2304 (2209);
# 5000 and 20000 take the gather group
D64 = dict(embedding_dim=64, bottom_mlp=(32, 64), top_mlp=(32, 1),
           vocabs=(5000, 3, 2209, 155, 20000, 976))
CFG = {"batch_buckets": (64,)}


def _batch(model, bs, seed):
    """make_random_batch with each cat id drawn over 32 bits, as the TSV's
    hex tokens, so that HashBucket spreads a column's ids over its whole
    vocab (make_random_batch's ints reach 100 rows at most)."""
    batch = make_random_batch(model, bs, seed=seed)
    rng = np.random.default_rng(seed)
    for i in range(sum(k.startswith("cat") for k in batch)):
        batch[f"cat{i}"] = rng.integers(0, 2**32, bs, dtype=np.int64)
    return batch


def _assert_matches(out, want, what):
    for col, r in want["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], r,
                                      err_msg=f"{what}: {col}")
    np.testing.assert_allclose(out["output"], want["output"], rtol=1e-4,
                               atol=1e-5, err_msg=what)


def test_dlrm_dot_tower():
    """tests/test_engine.py::test_dlrm_dot_tower on the port."""
    kw = dict(embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 1),
              vocabs=(100,) * 5)
    jm, tm = j_criteo(**kw), t_criteo(**kw)
    batch = make_random_batch(jm, 32, seed=3)
    params = init_model_params(jm)
    eng = Engine(tm, EngineConfig(use_pallas=False), params=params,
                 device="cpu")
    assert not eng._fold_emb_perm
    out = eng.predict(batch, return_pooled=True, return_concat=True)
    ref = OracleModel(jm, params).forward(batch)
    _assert_matches(out, ref, "oracle")
    jout = JEngine(jm, JConfig(use_pallas=False), params=params).predict(
        batch, return_pooled=True, return_concat=True)
    _assert_matches(out, jout, "JAX engine")
    # the concat's front is the raw dense inputs, as in the reference
    np.testing.assert_array_equal(out["concat"], jout["concat"])
    np.testing.assert_array_equal(out["concat"][:, :13], ref["dense"])


def _hidden(model, S):
    """``model`` with its column cat2 hidden (in_concat=False), built
    with spec module ``S``."""
    cols = [dataclasses.replace(c, in_concat=False) if c.name == "cat2"
            else c for c in model.columns]
    return S.ModelSpec(model.name, model.tables, cols, model.tower)


def test_dlrm_dot_with_hidden_column_raises_as_reference():
    """The spec allows a hidden column under dlrm_dot, but the reference's
    tower counts every embedding column (n_emb) and its reshape of the
    concat fails; the port's Engine and Trainer fail there too, rather
    than serving a smaller Gram matrix."""
    kw = dict(embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 1),
              vocabs=(100,) * 5)
    jm, tm = _hidden(j_criteo(**kw), jspec), _hidden(t_criteo(**kw), tspec)
    batch = make_random_batch(jm, 16, seed=3)
    params = init_model_params(jm)
    with pytest.raises(TypeError, match="reshape"):
        JEngine(jm, JConfig(use_pallas=False), params=params).predict(batch)
    eng = Engine(tm, EngineConfig(use_pallas=False), params=params,
                 device="cpu")
    with pytest.raises(RuntimeError, match="shape"):
        eng.predict(batch)
    tr = Trainer(tm, EngineConfig(use_pallas=False), params=params,
                 device="cpu")
    with pytest.raises(RuntimeError, match="shape"):
        tr.step(batch, _labels(16, 1))


def test_criteo_at_d64_matches_oracle_and_jax_engine():
    jm, tm = j_criteo(**D64), t_criteo(**D64)
    params = init_model_params(jm)
    eng = Engine(tm, EngineConfig(**CFG), params=params, device="cpu")
    onehot = [g for g in eng.compiled.groups if g.pallas_vocab is not None]
    gather = [g for g in eng.compiled.groups if g.pallas_vocab is None]
    assert sorted(g.pallas_vocab for g in onehot) == [128, 256, 1024, 2304]
    assert len(gather) == 1 and gather[0].num_columns == 2
    assert all(g.dim == 64 for g in eng.compiled.groups)
    perm = np.asarray(eng.compiled.emb_perm)
    assert (perm != np.arange(perm.size)).any()
    batch = _batch(jm, 50, seed=7)
    out = eng.predict(batch, return_pooled=True, return_concat=True)
    assert out["output"].shape == (50, 1)
    _assert_matches(out, OracleModel(jm, params).forward(batch), "oracle")
    jout = JEngine(jm, JConfig(**CFG), params=params).predict(
        batch, return_pooled=True, return_concat=True)
    _assert_matches(out, jout, "JAX engine")
    np.testing.assert_array_equal(out["concat"], jout["concat"])


def test_criteo_at_d64_trainer_matches_jax():
    jm, tm = j_criteo(**D64), t_criteo(**D64)
    jtr = JTrainer(jm, JConfig(**CFG), optimizer=j_dlrm())
    tr = Trainer(tm, EngineConfig(**CFG), optimizer=dlrm_optimizer(),
                 params=j_export(jtr.engine), device="cpu")
    batch = _batch(jm, 50, seed=3)
    labels = _labels(50, 1)
    jloss, jgrads = _jax_value_and_grad(jtr, batch, labels)
    loss, grads = tr.value_and_grad(batch, labels)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert set(grads["stacked"]) == set(jgrads["stacked"])
    for gid, g in grads["stacked"].items():
        _close(g.numpy(), jgrads["stacked"][gid], 1e-4, 1e-6, f"table {gid}")
    assert set(grads["tower"]) == {"bottom", "top"}
    for key, layers in grads["tower"].items():
        for i, layer in enumerate(layers):
            for wb in ("w", "b"):
                _close(layer[wb].numpy(), jgrads["tower"][key][i][wb], 1e-4,
                       1e-6, f"tower {key}[{i}].{wb}")
    batches = [_batch(jm, 50, seed=10 + i) for i in range(3)]
    labs = [_labels(50, 20 + i) for i in range(3)]
    jl = [jtr.step(b, lab) for b, lab in zip(batches, labs)]
    tl = [tr.step(b, lab) for b, lab in zip(batches, labs)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_jax_params_load_into_the_port_and_back(tmp_path):
    """The JAX make_criteo_dlrm's params, after a training step, exported
    with export_params, serve the same outputs from the port; the port's
    checkpoint of its own step (the dlrm_dot tower's bottom and top, no
    emb-perm unfold) serves the same outputs from the JAX package."""
    jm, tm = j_criteo(**D64), t_criteo(**D64)
    jtr = JTrainer(jm, JConfig(**CFG), optimizer=j_dlrm())
    jtr.step(_batch(jm, 40, seed=1), _labels(40, 1))
    params = j_export(jtr.engine)
    batch = _batch(jm, 40, seed=2)
    eng = Engine(tm, EngineConfig(**CFG), params=params, device="cpu")
    out = eng.predict(batch, return_pooled=True)
    _assert_matches(out, jtr.engine.predict(batch, return_pooled=True),
                    "JAX params")

    tr = Trainer(tm, EngineConfig(**CFG), optimizer=dlrm_optimizer(),
                 params=params, device="cpu")
    tr.step(_batch(jm, 40, seed=3), _labels(40, 2))
    tr.save(str(tmp_path))
    model, saved = j_load(str(tmp_path))
    assert set(saved["tower"]) == {"bottom", "top"}
    jout = JEngine(model, JConfig(**CFG), params=saved).predict(
        batch, return_pooled=True)
    _assert_matches(tr.engine.predict(batch, return_pooled=True), jout,
                    "port checkpoint")


def _write_tsv(path, n, seed):
    """n Criteo-format lines: label, 13 ints, 26 hex ids, about a fifth of
    the fields empty."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        dense = [str(rng.integers(0, 100)) if rng.random() > 0.2 else ""
                 for _ in range(13)]
        cats = [format(int(rng.integers(0, 2**32)), "x")
                if rng.random() > 0.2 else "" for _ in range(26)]
        lines.append("\t".join([str(rng.integers(0, 2))] + dense + cats))
    path.write_text("\n".join(lines) + "\n")


def test_criteo_tsv_reader_end_to_end(tmp_path):
    """tests/test_engine.py::test_criteo_tsv_reader_end_to_end on the port:
    both packages' readers give identical batches of a TSV the test
    writes, and the port serves them == the oracle's pooled outputs."""
    p = tmp_path / "criteo.tsv"
    _write_tsv(p, 70, 0)
    kw = dict(embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 1),
              vocabs=(100,) * 26)
    jm, tm = j_criteo(**kw), t_criteo(**kw)
    eng = Engine(tm, EngineConfig(use_pallas=False, batch_buckets=(32, 64)),
                 device="cpu")
    ref_o = OracleModel(jm, t_export(eng))
    total = 0
    pairs = zip(t_read_tsv(str(p), 32), j_read_tsv(str(p), 32))
    for (batch, labels), (jbatch, jlabels) in pairs:
        assert set(batch) == set(jbatch)
        for k in batch:
            assert batch[k].dtype == jbatch[k].dtype, k
            np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
        np.testing.assert_array_equal(labels, jlabels)
        out = eng.predict(batch, return_pooled=True)
        for c, r in ref_o.forward(batch)["pooled"].items():
            np.testing.assert_array_equal(out["pooled"][c], r, err_msg=c)
        total += len(labels)
    assert total == 70


@pytest.mark.cuda
def test_criteo_at_d64_on_card_matches_oracle_and_launches_kernels():
    """The d = 64 model on the card: K1 once for every one-hot group and X1
    once a forward; a training step adds K3a once for every one-hot group
    and X1b once, after the forward's one partition launch (Part: at d =
    64 every one-hot vocab is cut into tiles of 64 rows, and X1b's group
    is listed too); outputs and losses against the oracle and the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jm, tm = j_criteo(**D64), t_criteo(**D64)
    params = init_model_params(jm)
    eng = Engine(tm, EngineConfig(**CFG), params=params)
    batch = _batch(jm, 50, seed=7)
    kernels.reset_launches()
    out = eng.predict(batch, return_pooled=True)
    counts = dict(kernels.launches)
    assert counts["K1"] == 1 and counts["X1"] == 1, counts
    assert counts["X2"] == counts["K2"] == 0, counts
    _assert_matches(out, OracleModel(jm, params).forward(batch), "oracle")
    labels = _labels(50, 1)
    cpu = Trainer(tm, EngineConfig(**CFG), optimizer=dlrm_optimizer(),
                  params=params, device="cpu")
    card = Trainer(tm, EngineConfig(**CFG), optimizer=dlrm_optimizer(),
                   params=params)
    kernels.reset_launches()
    got = [card.step(batch, labels)]
    counts = dict(kernels.launches)
    assert counts["K3a"] == 1 and counts["X1b"] == 1, counts
    assert counts["Part"] == 1, counts
    got += [card.step(batch, labels) for _ in range(2)]
    want = [cpu.step(batch, labels) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
