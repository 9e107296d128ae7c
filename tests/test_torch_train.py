"""The port's Trainer against the JAX package's (recom_tpu/train.py) on the
CPU, where every kernel runs its plain version: mini model E (params
carried across with export_params) in the default config and with
use_pallas=False, and a pure-bucketize model under host_bucketize=False
(K2 and K3b).  One step's table and tower gradients are held at rtol 1e-4
/ atol 1e-6 and three dlrm_optimizer losses at rtol 1e-4 (the towers'
matmuls and their transposes sum in other orders than XLA's); the
optimizers alone against optax on identical gradients at rtol 1e-5 / atol
1e-8 (XLA may contract or reorder their few f32 operations).  Mirrors of
tests/test_training.py: learnability, updates reaching serving, row-wise
state, bit-exact resume; and training checkpoints resumed across the
packages, each way, under every optimizer."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.runtime.checkpoint import export_params as j_export
from recom_tpu.runtime.checkpoint import load_checkpoint as j_load
from recom_tpu.train import Trainer as JTrainer
from recom_tpu.train import dlrm_optimizer as j_dlrm
from recom_tpu.train import forward_logits as j_forward_logits
from recom_tpu.train import rowwise_adagrad as j_rowwise
from recom_tpu_torch import EngineConfig, Trainer
from recom_tpu_torch.ir import spec as ts
from recom_tpu_torch.models import make_dlrm_model as t_make_dlrm
from recom_tpu_torch.ops import kernels
from recom_tpu_torch.runtime.checkpoint import export_params, load_checkpoint
from recom_tpu_torch.train import (
    OptaxOptimizer,
    adam,
    dlrm_optimizer,
    rowwise_adagrad,
)

torch.set_num_threads(1)

MINI_E = (6, 2, 2, 2, 1, 4, [8], [16])
BZ = (6, 0, 0, 0, 0, 4, [8], [16])
CASES = {
    "default": (MINI_E, {}),
    "no_pallas": (MINI_E, {"use_pallas": False}),
    "device_bucketize": (BZ, {"host_bucketize": False}),
}


def _labels(n, seed):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.float32)


def _pair(name, optimizer=None, j_optimizer=None):
    shape, kw = CASES[name]
    jm = j_make_dlrm(*shape, name="mini", large_rows=20_000)
    tm = t_make_dlrm(*shape, name="mini", large_rows=20_000)
    cfg = dict(kw, batch_buckets=(64,))
    jtr = JTrainer(jm, JConfig(**cfg), optimizer=j_optimizer)
    params = j_export(jtr.engine)
    tr = Trainer(tm, EngineConfig(**cfg), optimizer=optimizer, params=params,
                 device="cpu")
    return jm, jtr, tr


def _jax_value_and_grad(jtr, batch, labels):
    eng = jtr.engine
    prepared = eng.prepare(batch)
    bp, b = prepared.batch_padded, prepared.batch_size
    lab = np.zeros(bp, np.float32)
    lab[:b] = labels
    mask = np.zeros(bp, np.float32)
    mask[:b] = 1.0
    arrays = eng.shard_batch_arrays(prepared.arrays)

    def loss_fn(params):
        logits = j_forward_logits(eng, params, arrays, prepared.signature)
        per = optax.sigmoid_binary_cross_entropy(logits[:, 0], lab)
        return (per * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    return jax.jit(jax.value_and_grad(loss_fn))(eng.device_params)


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_one_step_grads_and_three_losses_match_jax(name):
    jm, jtr, tr = _pair(name, dlrm_optimizer(), j_dlrm())
    if name == "device_bucketize":
        assert any(tr.engine._fused_bucketize(g)
                   for g in tr.engine.compiled.groups)
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
    batches = [make_random_batch(jm, 50, seed=10 + i) for i in range(3)]
    labs = [_labels(50, 20 + i) for i in range(3)]
    jl = [jtr.step(b, lab) for b, lab in zip(batches, labs)]
    tl = [tr.step(b, lab) for b, lab in zip(batches, labs)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def _opt_params(rng):
    """A params tree with a 2-D stacked table, a 3-D one-hot table and a
    two-layer tower."""
    return {
        "stacked": {"0": rng.standard_normal((7, 4)).astype(np.float32),
                    "1": rng.standard_normal((8, 128, 3)).astype(np.float32)},
        "tower": {"top": [
            {"w": rng.standard_normal((5, 6)).astype(np.float32),
             "b": rng.standard_normal(6).astype(np.float32)},
            {"w": rng.standard_normal((6, 1)).astype(np.float32),
             "b": rng.standard_normal(1).astype(np.float32)},
        ]},
    }


@pytest.mark.parametrize("which", ["adam", "rowwise_adagrad", "dlrm"])
def test_optimizers_match_optax_on_identical_grads(which):
    rng = np.random.default_rng(4)
    p_np = _opt_params(rng)
    t_opt, j_opt = {
        "adam": (adam(1e-2), optax.adam(1e-2)),
        "rowwise_adagrad": (rowwise_adagrad(0.05), j_rowwise(0.05)),
        "dlrm": (dlrm_optimizer(0.05, 1e-2), j_dlrm(0.05, 1e-2)),
    }[which]
    tp = jax.tree_util.tree_map(torch.tensor, p_np)     # copies
    opt = t_opt(tp)
    assert isinstance(opt, OptaxOptimizer)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    state = j_opt.init(jp)
    for step in range(3):
        g_np = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), p_np)
        for t, g in zip(jax.tree_util.tree_leaves(tp),
                        jax.tree_util.tree_leaves(g_np)):
            t.grad = torch.from_numpy(g)
        opt.step()
        upd, state = j_opt.update(jax.tree_util.tree_map(jnp.asarray, g_np),
                                  state, jp)
        jp = optax.apply_updates(jp, upd)
    for t, j in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(jp)):
        _close(t.numpy(), j, 1e-5, 1e-8, which)


def test_rowwise_adagrad_state_is_per_row_for_2d_tables_only():
    tm = t_make_dlrm(4, 2, 2, 1, 0, 2, [4], [8], name="rwag")
    tr = Trainer(tm, EngineConfig(batch_buckets=(32,)),
                 optimizer=dlrm_optimizer(table_lr=0.05), device="cpu")
    kinds = set()
    for g in tr.engine.compiled.groups:
        table = tr.params["stacked"][str(g.gid)]
        acc = tr.optimizer.state[table]["acc"]
        if table.dim() == 2:
            assert acc.shape == table.shape[:1]    # one per row
        else:
            assert acc.shape == table.shape        # the quirk: elementwise
        kinds.add(table.dim())
    assert kinds == {2, 3}
    b = make_random_batch(j_make_dlrm(4, 2, 2, 1, 0, 2, [4], [8],
                                      name="rwag"), 32, seed=7)
    losses = [tr.step(b, _labels(32, 0)) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def _learnable(S):
    tables = {"t": S.TableSpec("t", 32, 8)}
    cols = [
        S.FeatureColumn("ids", S.FeatureSource("ids", S.FeatureKind.INT_LIST),
                        (S.NumToId(32),), S.LookupSpec("t", S.Combiner.MEAN)),
        S.FeatureColumn("d0", S.FeatureSource("d0",
                                              S.FeatureKind.DENSE_FLOAT)),
    ]
    tower = S.TowerSpec(arch="mlp", bottom_mlp=(), top_mlp=(16, 1),
                        final_activation="sigmoid")
    return S.ModelSpec("learn", tables, cols, tower)


def _learn_data(rng, n):
    """tests/test_training.py's planted rule."""
    ids = [list(rng.integers(0, 32, size=int(k)))
           for k in rng.integers(1, 5, n)]
    d0 = rng.standard_normal(n).astype(np.float32)
    signal = np.array([np.mean(row) / 31.0 for row in ids]) + 0.3 * d0
    labels = (signal + 0.1 * rng.standard_normal(n) > 0.55).astype(
        np.float32)
    return {"ids": ids, "d0": d0}, labels


def _auc(labels, scores):
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def test_training_learns_signal_and_updates_reach_serving():
    rng = np.random.default_rng(0)
    cfg = EngineConfig(use_pallas=False, batch_buckets=(128,))
    tr = Trainer(_learnable(ts), cfg, device="cpu")
    batch, labels = _learn_data(rng, 128)
    before = tr.engine.predict(batch)["output"]
    losses = [tr.step(*_learn_data(rng, 128)) for _ in range(60)]
    after = tr.engine.predict(batch)["output"]
    assert not np.array_equal(before, after)      # the same Engine serves
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    auc_before, auc_after = _auc(labels, before[:, 0]), _auc(labels,
                                                             after[:, 0])
    assert auc_after > 0.8 and auc_after > auc_before + 0.1, (auc_before,
                                                              auc_after)


def test_predict_step_predict_on_one_engine():
    """tests/test_training.py::test_training_updates_reach_serving on mini
    model E's default path: predict caches device constants under
    inference mode, and the step after it must still run."""
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    jm = j_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    tr = Trainer(tm, EngineConfig(batch_buckets=(64,)),
                 optimizer=dlrm_optimizer(), device="cpu")
    batch = make_random_batch(jm, 40, seed=5)
    before = tr.engine.predict(batch)["output"]
    tr.step(batch, _labels(40, 5))
    after = tr.engine.predict(batch)["output"]
    assert not np.array_equal(before, after)


def test_checkpoint_resume_bitexact_and_jax_reads_it(tmp_path):
    """Trainer.save at step k, Trainer.restore, continue: the resumed run
    reproduces the uninterrupted one bit for bit; the JAX package's
    load_checkpoint reads the checkpoint and its Engine serves what the
    port's does."""
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    jm = j_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    cfg = EngineConfig(batch_buckets=(64,))
    batches = [make_random_batch(jm, 40, seed=30 + i) for i in range(5)]
    labs = [_labels(40, 40 + i) for i in range(5)]
    tr_a = Trainer(tm, cfg, optimizer=dlrm_optimizer(), device="cpu")
    for b, lab in zip(batches[:2], labs[:2]):
        tr_a.step(b, lab)
    path = str(tmp_path / "ck")
    tr_a.save(path)
    cont_a = [tr_a.step(b, lab) for b, lab in zip(batches[2:], labs[2:])]
    tr_b = Trainer.restore(path, cfg, optimizer=dlrm_optimizer(),
                           device="cpu")
    cont_b = [tr_b.step(b, lab) for b, lab in zip(batches[2:], labs[2:])]
    assert cont_a == cont_b
    ea, eb = export_params(tr_a.engine), export_params(tr_b.engine)
    for t in ea["tables"]:
        np.testing.assert_array_equal(ea["tables"][t], eb["tables"][t])
    for k in ea["tower"]:
        for la, lb in zip(ea["tower"][k], eb["tower"][k]):
            np.testing.assert_array_equal(la["w"], lb["w"])
            np.testing.assert_array_equal(la["b"], lb["b"])

    # the checkpoint holds tr_a's params at step 2: serve them from both
    model, params = j_load(path)
    jout = JEngine(model, JConfig(batch_buckets=(64,)),
                   params=params).predict(batches[0], return_pooled=True)
    out = Trainer.restore(path, cfg, optimizer=dlrm_optimizer(),
                          device="cpu").engine.predict(batches[0],
                                                       return_pooled=True)
    for col, r in jout["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], r, err_msg=col)
    np.testing.assert_allclose(out["output"], jout["output"], rtol=1e-4,
                               atol=1e-5)


# the cross-package checkpoint cases: (model, optimizer); "permuted" folds
# its embedding order into the first top layer's rows on both sides
RESUME_CASES = [("mini_e", "adam"), ("mini_e", "rowwise_adagrad"),
                ("mini_e", "dlrm_optimizer"), ("permuted", "dlrm_optimizer")]
OPTIMIZERS = {
    "adam": (lambda: adam(1e-3), lambda: optax.adam(1e-3)),
    "rowwise_adagrad": (rowwise_adagrad, j_rowwise),
    "dlrm_optimizer": (dlrm_optimizer, j_dlrm),
}


def _resume_setup(model: str):
    """(JAX model, port model, buckets, five batches, their labels)."""
    from recom_tpu.ir import spec as js

    if model == "permuted":
        jm, tm, n, bucket = _permuted(js), _permuted(ts), 29, 32
    else:
        jm = j_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
        tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
        n, bucket = 40, 64
    batches = [make_random_batch(jm, n, seed=30 + i) for i in range(5)]
    labs = [_labels(n, 40 + i) for i in range(5)]
    return jm, tm, (bucket,), batches, labs


def _saved_leaves(path):
    with np.load(str(path / "opt_state.npz")) as data:
        return [data[f"leaf{i}"] for i in range(len(data.files))]


@pytest.mark.parametrize("model,opt", RESUME_CASES)
def test_jax_checkpoint_resumes_in_the_port(tmp_path, model, opt):
    """A JAX Trainer.save after two steps, resumed by the port's
    Trainer.restore: the port's state leaves are the file's, in optax's
    order, and its next three losses are the JAX run's own continuation
    within rtol 1e-4."""
    jm, tm, buckets, batches, labs = _resume_setup(model)
    t_opt, j_opt = OPTIMIZERS[opt]
    jtr = JTrainer(jm, JConfig(batch_buckets=buckets), optimizer=j_opt())
    for b, lab in zip(batches[:2], labs[:2]):
        jtr.step(b, lab)
    jtr.save(str(tmp_path))
    want = [jtr.step(b, lab) for b, lab in zip(batches[2:], labs[2:])]
    tr = Trainer.restore(str(tmp_path), EngineConfig(batch_buckets=buckets),
                         optimizer=t_opt(), device="cpu")
    saved = _saved_leaves(tmp_path)
    got = tr.optimizer.state_leaves()
    assert len(got) == len(saved)
    for a, b in zip(got, saved):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    cont = [tr.step(b, lab) for b, lab in zip(batches[2:], labs[2:])]
    np.testing.assert_allclose(cont, want, rtol=1e-4)


@pytest.mark.parametrize("model,opt", RESUME_CASES)
def test_port_checkpoint_resumes_in_jax(tmp_path, model, opt):
    """The reverse: a port Trainer.save after two steps, resumed by the JAX
    Trainer.restore, whose leaves are the optax tree's in count and shape;
    its next three losses are the port run's continuation within rtol
    1e-4."""
    jm, tm, buckets, batches, labs = _resume_setup(model)
    t_opt, j_opt = OPTIMIZERS[opt]
    tr = Trainer(tm, EngineConfig(batch_buckets=buckets), optimizer=t_opt(),
                 device="cpu")
    for b, lab in zip(batches[:2], labs[:2]):
        tr.step(b, lab)
    tr.save(str(tmp_path))
    want = [tr.step(b, lab) for b, lab in zip(batches[2:], labs[2:])]
    jtr = JTrainer.restore(str(tmp_path), JConfig(batch_buckets=buckets),
                           optimizer=j_opt())
    jl = jax.tree_util.tree_leaves(jtr.opt_state)
    saved = _saved_leaves(tmp_path)
    assert [np.shape(x) for x in jl] == [x.shape for x in saved]
    cont = [jtr.step(b, lab) for b, lab in zip(batches[2:], labs[2:])]
    np.testing.assert_allclose(cont, want, rtol=1e-4)


def _old_layout(tr, opt):
    """The port's opt_state leaves as it wrote them before they followed
    optax: each group's params with the stacked tables in group order and
    each layer's w before its b, each param's state keys sorted, with a
    count beside every Adam param."""
    p = tr.params
    subtrees = ([{"stacked": p["stacked"]}, {"tower": p["tower"]}]
                if opt == "dlrm_optimizer" else [p])
    leaves = []
    for group, sub in zip(tr.optimizer.param_groups, subtrees):
        params = list(sub.get("stacked", {}).values()) + [
            layer[wb] for layers in sub.get("tower", {}).values()
            for layer in layers for wb in ("w", "b")]
        for x in params:
            st = tr.optimizer.state[x]
            if group["rule"] == "adam":
                leaves += [np.asarray(group["count"], np.int32),
                           st["mu"].numpy(), st["nu"].numpy()]
            else:
                leaves.append(st["acc"].numpy())
    return leaves


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_restore_refuses_the_earlier_port_layout(tmp_path, opt):
    """A file in the port's earlier layout is refused with ValueError:
    under adam and dlrm_optimizer by its leaf count, named in the message;
    under rowwise_adagrad, where the count is the same and only the order
    differs, by the first leaf whose shape is wrong."""
    _, tm, buckets, batches, labs = _resume_setup("mini_e")
    t_opt, _ = OPTIMIZERS[opt]
    tr = Trainer(tm, EngineConfig(batch_buckets=buckets), optimizer=t_opt(),
                 device="cpu")
    tr.step(batches[0], labs[0])
    tr.save(str(tmp_path))
    old = _old_layout(tr, opt)
    np.savez(str(tmp_path / "opt_state.npz"),
             **{f"leaf{i}": x for i, x in enumerate(old)})
    match = "shape" if opt == "rowwise_adagrad" else "earlier per-param"
    with pytest.raises(ValueError, match=match):
        Trainer.restore(str(tmp_path), EngineConfig(batch_buckets=buckets),
                        optimizer=t_opt(), device="cpu")


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_restore_refuses_a_mismatched_optimizer(tmp_path, saved_by):
    """A checkpoint saved under one optimizer and restored under another is
    refused with ValueError, whichever package saved it."""
    jm, tm, buckets, batches, labs = _resume_setup("mini_e")
    if saved_by == "jax":
        jtr = JTrainer(jm, JConfig(batch_buckets=buckets),
                       optimizer=optax.adam(1e-3))
        jtr.step(batches[0], labs[0])
        jtr.save(str(tmp_path))
    else:
        tr = Trainer(tm, EngineConfig(batch_buckets=buckets),
                     optimizer=adam(1e-3), device="cpu")
        tr.step(batches[0], labs[0])
        tr.save(str(tmp_path))
    for opt in (dlrm_optimizer, rowwise_adagrad):
        with pytest.raises(ValueError, match="leaf count mismatch"):
            Trainer.restore(str(tmp_path), EngineConfig(batch_buckets=buckets),
                            optimizer=opt(), device="cpu")
    with pytest.raises(ValueError, match="leaf count mismatch"):
        JTrainer.restore(str(tmp_path), JConfig(batch_buckets=buckets),
                         optimizer=j_dlrm())


def _permuted(S):
    """tests/test_torch_engine.py's weighted model: its grouped embedding
    order differs from the model order, so the first top matmul's rows are
    folded on the card."""
    K, C = S.FeatureKind, S.Combiner
    tables = {"t_w": S.TableSpec("t_w", 120, 8),
              "t_sm": S.TableSpec("t_sm", 64, 8),
              "t_sp": S.TableSpec("t_sp", 5000, 8),
              "t_bz": S.TableSpec("t_bz", 11, 8)}
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
    return S.ModelSpec("permuted", tables, cols, tower)


def test_checkpoint_unfolds_the_embedding_permutation(tmp_path):
    """Saved after a step, a model whose embedding order is permuted on the
    card serves the same output from the JAX package."""
    from recom_tpu.ir import spec as js

    tr = Trainer(_permuted(ts), EngineConfig(batch_buckets=(32,)),
                 device="cpu")
    perm = np.asarray(tr.engine.compiled.emb_perm)
    assert tr.engine._fold_emb_perm and (perm != np.arange(len(perm))).any()
    batch = make_random_batch(_permuted(js), 29, seed=5)
    tr.step(batch, _labels(29, 2))
    tr.save(str(tmp_path))
    model, params = j_load(str(tmp_path))
    jout = JEngine(model, JConfig(batch_buckets=(32,)),
                   params=params).predict(batch)
    np.testing.assert_allclose(tr.engine.predict(batch)["output"],
                               jout["output"], rtol=1e-4, atol=1e-5)


def test_trainer_defaults_to_cuda_and_rejects_unported(tmp_path):
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(tm, EngineConfig(), optimizer=dlrm_optimizer())
    with pytest.raises(ValueError, match="float32"):
        Trainer(tm, EngineConfig(table_dtype="bfloat16"), device="cpu")
    # a mesh trains over an initialised torch.distributed world
    # (tests/test_torch_mesh_train.py), and refuses to start without one
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(tm, EngineConfig(mesh_shape=(1, 2)), device="cpu")
    tr = Trainer(tm, EngineConfig(), device="cpu")
    tr.save(str(tmp_path))
    # an orbax params/ directory is read with tensorstore (item 10,
    # tests/test_torch_checkpoint.py); an empty one is no checkpoint
    (tmp_path / "params").mkdir()
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        load_checkpoint(str(tmp_path))


@pytest.mark.cuda
def test_training_on_card_launches_the_backward_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jm = j_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    params = j_export(JEngine(jm, JConfig()))
    batch = make_random_batch(jm, 50, seed=3)
    labels = _labels(50, 1)
    cpu = Trainer(tm, EngineConfig(), optimizer=dlrm_optimizer(),
                  params=params, device="cpu")
    card = Trainer(tm, EngineConfig(), optimizer=dlrm_optimizer(),
                   params=params)
    assert card.engine.device.type == "cuda"
    kernels.reset_launches()
    got = [card.step(batch, labels) for _ in range(3)]
    counts = dict(kernels.launches)
    for kid in ("K1", "X1", "X2", "K3a", "X1b"):
        assert counts[kid] > 0, counts
    assert counts["K2"] == counts["K3b"] == 0, counts
    want = [cpu.step(batch, labels) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
