"""The port's post-lookup ops (PostPool) and hidden columns on the CPU
(every kernel's plain version), against the JAX Engine in interpret mode
and the JAX NumPy oracle: mirrors of tests/test_postlookup.py, with the
same params on both sides.  Pooled outputs (before the post ops) are held
exactly (``==``); the concat at rtol 1e-6 / atol 1e-6 and the output at
rtol 1e-5 / atol 1e-6, the tolerances tests/test_postlookup.py holds the
JAX engine to (softmax, reduce_mean and matmul are not bit-exact ops).
A Trainer test holds one step's gradients and three losses against the
JAX Trainer at tests/test_torch_train.py's tolerances, for a model with
every post op and hidden operands in a one-hot and a gather group."""

import numpy as np
import pytest
import torch

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.ir import spec as js
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.oracle import OracleModel
from recom_tpu.runtime.checkpoint import export_params as j_export
from recom_tpu.train import Trainer as JTrainer
from recom_tpu.train import dlrm_optimizer as j_dlrm
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig, Trainer
from recom_tpu_torch.ir import spec as ts
from recom_tpu_torch.models import (
    make_every_post_model,
    make_matmul_model,
    make_post_model,
    make_softmax_mul_model,
)
from recom_tpu_torch.train import dlrm_optimizer
from test_torch_train import _close, _jax_value_and_grad, _labels

torch.set_num_threads(1)


def _serve_both(make, kw, bs, seed, bucket):
    jm, tm = make(js), make(ts)
    batch = make_random_batch(jm, bs, seed=seed)
    params = init_model_params(jm)
    cfg = dict(kw, batch_buckets=(bucket,))
    jout = JEngine(jm, JConfig(interpret=True, **cfg), params=params).predict(
        batch, return_pooled=True, return_concat=True)
    eng = Engine(tm, EngineConfig(**cfg), params=params, device="cpu")
    out = eng.predict(batch, return_pooled=True, return_concat=True)
    ref = OracleModel(jm, params=params).forward(batch)
    assert set(out["pooled"]) == set(ref["pooled"]) == set(jout["pooled"])
    for c, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][c], r, err_msg=c)
        np.testing.assert_array_equal(out["pooled"][c], jout["pooled"][c],
                                      err_msg=c)
    for want in (ref, jout):
        assert out["concat"].shape == want["concat"].shape
        np.testing.assert_allclose(out["concat"], want["concat"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(out["output"], want["output"], rtol=1e-5,
                                   atol=1e-6)
    return eng, out, ref


@pytest.mark.parametrize("use_pallas", [True, False])
def test_post_model_matches_jax_and_oracle(use_pallas):
    eng, out, _ = _serve_both(make_post_model, {"use_pallas": use_pallas},
                              33, 4, 64)
    assert any(g.pallas_vocab is not None
               for g in eng.compiled.groups) is use_pallas
    # concat: dense 1 + rb 1 + rh 1 + ra 8 + keep 4
    assert out["concat"].shape == (33, 15)


@pytest.mark.parametrize("wire", [True, False])
def test_softmax_and_mul_column_match_jax_and_oracle(wire):
    eng, out, ref = _serve_both(make_softmax_mul_model, {"wire_pack": wire},
                                29, 9, 32)
    # the hidden operand pools (return_pooled has it) but takes no slot:
    # dense 1 + a 8 + sp 8 + sm 4
    assert "b_hidden" in out["pooled"]
    assert out["concat"].shape == (29, 21)
    a_gid = eng.compiled.column_slot["a"][0]
    assert eng.compiled.column_slot["sp"][0] != a_gid   # across groups
    want = ref["pooled"]["a"] * ref["pooled"]["b_hidden"]
    np.testing.assert_allclose(out["concat"][:, 1:9], want, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(out["concat"][:, 17:21].sum(axis=1), 1.0,
                               rtol=1e-5)


def test_matmul_chain_matches_jax_and_oracle():
    eng, out, _ = _serve_both(make_matmul_model, {}, 21, 3, 32)
    # dense 1 + pa 5 + pb 1
    assert out["concat"].shape == (21, 7)


def test_every_post_op_and_hidden_operands_match_jax_and_oracle():
    eng, out, _ = _serve_both(make_every_post_model, {}, 40, 6, 64)
    kinds = {eng.compiled.column_slot[c][0]: c
             for c in ("h_onehot", "h_gather")}
    groups = {g.gid: g for g in eng.compiled.groups}
    assert len(kinds) == 2
    assert groups[eng.compiled.column_slot["h_onehot"][0]].pallas_vocab
    assert groups[eng.compiled.column_slot["h_gather"][0]].pallas_vocab is None
    # dense 2 -> bottom 4, a 8, sp 6, r 1, m 1
    assert out["concat"].shape == (40, 20)


def test_post_constants_are_device_tensors_made_once(monkeypatch):
    """The frozen matmul weights and affine scales and biases become device
    tensors when the Engine is built: never leaves, and the forward
    multiplies by those very tensors instead of making new ones."""
    from recom_tpu_torch.train import param_leaves

    tm = make_every_post_model(ts)
    eng = Engine(tm, EngineConfig(batch_buckets=(64,)), device="cpu")
    consts = [t for c in eng._post_consts.values() for t in c.values()]
    assert len(consts) == 3           # a's scale and bias, sp's weight
    assert not any(t.requires_grad for t in consts)
    leaves = {id(t) for t in param_leaves(eng.device_params)}
    assert not any(id(t) in leaves for t in consts)
    (weight,) = [c["weight"] for c in eng._post_consts.values()
                 if "weight" in c]
    batch = make_random_batch(make_every_post_model(js), 20, seed=1)
    seen = []
    # the projection is a row-wise product (executor.row_linear, whose rows
    # do not depend on the batch): spy on the weight it is handed
    from recom_tpu_torch.runtime import executor

    real = executor.row_linear
    monkeypatch.setattr(executor, "row_linear",
                        lambda a, b, *r: seen.append(b) or real(a, b, *r))
    for _ in range(2):
        eng.predict(batch)
    monkeypatch.setattr(executor, "row_linear", real)
    projections = [b for b in seen if tuple(b.shape) == (8, 6)]
    assert len(projections) == 2 and all(b is weight for b in projections)


@pytest.mark.parametrize("make", [make_every_post_model,
                                  make_softmax_mul_model])
def test_trainer_matches_jax_with_post_ops_and_hidden_columns(make):
    jm, tm = make(js), make(ts)
    cfg = {"batch_buckets": (64,)}
    jtr = JTrainer(jm, JConfig(**cfg), optimizer=j_dlrm())
    tr = Trainer(tm, EngineConfig(**cfg), optimizer=dlrm_optimizer(),
                 params=j_export(jtr.engine), device="cpu")
    batch = make_random_batch(jm, 50, seed=3)
    labels = _labels(50, 1)
    jloss, jgrads = _jax_value_and_grad(jtr, batch, labels)
    loss, grads = tr.value_and_grad(batch, labels)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert set(grads["stacked"]) == set(jgrads["stacked"])
    for gid, g in grads["stacked"].items():
        _close(g.numpy(), jgrads["stacked"][gid], 1e-4, 1e-6, f"table {gid}")
    for key, layers in grads["tower"].items():
        for i, layer in enumerate(layers):
            for wb in ("w", "b"):
                _close(layer[wb].numpy(), jgrads["tower"][key][i][wb], 1e-4,
                       1e-6, f"tower {key}[{i}].{wb}")
    # a hidden operand's table gets its gradient through mul_column alone
    groups = {g.gid: g for g in tr.engine.compiled.groups}
    for col in [c.name for c in tm.embedding_columns if not c.in_concat]:
        gid, idx = tr.engine.compiled.column_slot[col]
        g, m = grads["stacked"][str(gid)], groups[gid].members[idx]
        g = (g[idx] if g.dim() == 3
             else g[m.row_offset: m.row_offset + m.vocab_size])
        assert bool((g != 0).any()), col
    batches = [make_random_batch(jm, 50, seed=10 + i) for i in range(3)]
    labs = [_labels(50, 20 + i) for i in range(3)]
    jl = [jtr.step(b, lab) for b, lab in zip(batches, labs)]
    tl = [tr.step(b, lab) for b, lab in zip(batches, labs)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    # the frozen constants took no step and hold no optimizer state
    held = {id(p) for grp in tr.optimizer.param_groups for p in grp["params"]}
    consts = [t for c in tr.engine._post_consts.values() for t in c.values()]
    assert not any(id(t) in held for t in consts)
