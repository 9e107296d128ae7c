"""Randomized parity sweeps of the port (ROADMAP item 17) on the CPU, where
every kernel runs its plain version:

* ``test_random_models_match_jax_and_oracle``: tests/test_fuzz.py:240's
  sweep.  The model and batch come from tests/test_fuzz.py's generator
  from the same rng (1000 + seed) and reach the port as serde JSON;
  pooled ``==`` the oracle and the JAX Engine's (params carried by
  ``export_params``), the concat as the source holds it, the output
  within rtol 1e-4 / atol 1e-5 of the JAX Engine's, and the port's serde
  round trip keeps ``spec_hash``.
* ``test_random_configs_match_oracle``: the single-device half of
  tests/test_fuzz_config.py:63 ``run_config_seed`` with its rules of
  expected output, over ``chip_smoke.random_config`` (its axes, plus
  ``device_hash``): the port's Engine held to the JAX package's oracle
  (the model carried across as serde JSON) and to the port's, both on
  the engine's own ``export_params`` (bf16 / int8: the stored values).
* ``test_random_model_grads_match_jax``: ``Trainer.value_and_grad``
  against the JAX Trainer's, ``use_pallas`` and ``host_bucketize`` drawn.
* ``test_generator_copy_matches_test_fuzz``: ``chip_smoke``'s generator,
  at the JAX widths, gives tests/test_fuzz.py's model and batch.
* ``test_card_seeds_cover_every_kernel_and_axis``: ``chip_smoke``'s card
  seeds draw every config axis it asks of them and, by their lowering,
  launch every kernel of ``KERNEL_META``.
* ``test_card_seeds_on_cpu``: some of ``chip_smoke.fuzz_phases``' seeds
  at the card's widths through its ``fuzz_seed``, on the CPU, held to
  the JAX package's oracle.
* ``test_post_reductions_are_the_oracles_bits``: reduce_sum / reduce_mean
  post ops after an affine bias ``==`` the JAX package's oracle and the
  port's at d up to 200 (card seed 5 found the card's own sum order 1e-6
  off at d = 64).
* ``cuda`` cases: the first card seeds through ``chip_smoke.fuzz_seed``
  on the card, and seeds 5, 14 and 46, where its first runs failed (5:
  the card's post reductions; 14 and 46: a staged backward check that
  asked a cotangent whose exact value is 0 to be 0 bit for bit), held to
  the JAX package's oracle.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import test_fuzz
from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.ir import spec as js
from recom_tpu.ir.serde import model_from_json as j_from_json
from recom_tpu.ir.serde import model_to_json as j_to_json
from recom_tpu.oracle import OracleModel as JOracle
from recom_tpu.runtime.checkpoint import export_params as j_export
from recom_tpu.train import Trainer as JTrainer
from recom_tpu_torch import Engine, EngineConfig, Trainer
from recom_tpu_torch.ir import spec as ts
from recom_tpu_torch.ir.serde import model_from_json, model_to_json
from recom_tpu_torch.oracle import OracleModel
from recom_tpu_torch.runtime.checkpoint import export_params
from recom_tpu_torch.utils.params import init_model_params

from test_torch_train import _jax_value_and_grad

torch.set_num_threads(1)


def _assert_concat(got, want, model, ctx=""):
    """The concat: ``==``, or within rtol / atol 1e-6 with post ops
    (tests/test_fuzz.py:257)."""
    if any(c.post for c in model.columns):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=ctx)
    else:
        np.testing.assert_array_equal(got, want, err_msg=ctx)


def jax_oracle(model, params, batch):
    """The JAX package's oracle on the port's ``model``, carried across as
    serde JSON: ``chip_smoke.fuzz_seed``'s ``oracle``."""
    jm = j_from_json(model_to_json(model))
    assert jm.spec_hash() == model.spec_hash()
    return JOracle(jm, params).forward(batch)


@pytest.mark.parametrize("seed", range(16))
def test_random_models_match_jax_and_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    jm = test_fuzz.random_model(rng, n_cols=int(rng.integers(3, 9)))
    batch = test_fuzz.random_batch(rng, jm, batch=int(rng.integers(5, 40)))
    kw = dict(use_pallas=bool(seed % 2), batch_buckets=(64,))
    jeng = JEngine(jm, JConfig(interpret=True, **kw))
    jout = jeng.predict(batch, return_pooled=True, return_concat=True)
    params = j_export(jeng)
    tm = model_from_json(j_to_json(jm))
    assert tm.spec_hash() == jm.spec_hash()
    out = Engine(tm, EngineConfig(**kw), params=params,
                 device="cpu").predict(batch, return_pooled=True,
                                       return_concat=True)
    ref = JOracle(jm, params).forward(batch)
    assert set(out["pooled"]) == set(ref["pooled"])
    for c, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][c], r, err_msg=c)
        np.testing.assert_array_equal(out["pooled"][c], jout["pooled"][c],
                                      err_msg=c)
    _assert_concat(out["concat"], ref["concat"], jm)
    np.testing.assert_allclose(out["output"], jout["output"], rtol=1e-4,
                               atol=1e-5)
    m2 = model_from_json(model_to_json(tm))
    assert m2.spec_hash() == tm.spec_hash()
    assert model_to_json(m2) == j_to_json(jm)


def run_config_seed(seed: int) -> None:
    """The single-device half of tests/test_fuzz_config.py:63, on the
    port's generator copy (the same draws) and ``random_config``: the
    port's Engine held to the JAX package's oracle and to the port's, on
    the engine's own ``export_params``."""
    rng = np.random.default_rng(7_000_000 + seed)
    model = chip_smoke.random_model(rng, int(rng.integers(3, 9)))
    kw = chip_smoke.random_config(rng)
    batch = chip_smoke.random_batch(rng, model, int(rng.integers(5, 40)))
    eng = Engine(model, EngineConfig(**kw), device="cpu")
    out = eng.predict(batch, return_pooled=True, return_concat=True)
    params = export_params(eng)
    ctx = f"seed={seed} {kw}"
    for name, ref in (("jax oracle", jax_oracle(model, params, batch)),
                      ("port oracle",
                       OracleModel(model, params).forward(batch))):
        assert set(out["pooled"]) == set(ref["pooled"]), name
        for c, r in ref["pooled"].items():
            np.testing.assert_array_equal(out["pooled"][c], r,
                                          err_msg=f"{name} {ctx} col={c}")
        _assert_concat(out["concat"], ref["concat"], model,
                       f"{name} {ctx}")
        np.testing.assert_allclose(out["output"], ref["output"], rtol=1e-4,
                                   atol=1e-5, err_msg=f"{name} {ctx}")


@pytest.mark.parametrize("seed", range(24))
def test_random_configs_match_oracle(seed):
    run_config_seed(seed)


@pytest.mark.parametrize("seed", range(12))
def test_random_model_grads_match_jax(seed):
    rng = np.random.default_rng(17_000_000 + seed)
    jm = test_fuzz.random_model(rng, n_cols=int(rng.integers(3, 9)))
    batch = test_fuzz.random_batch(rng, jm, batch=int(rng.integers(5, 40)))
    labels = rng.integers(0, 2, len(batch[jm.columns[0].source.field]))
    kw = dict(use_pallas=bool(rng.integers(2)),
              host_bucketize=bool(rng.integers(2)), batch_buckets=(64,))
    jtr = JTrainer(jm, JConfig(interpret=True, **kw))
    params = j_export(jtr.engine)
    tr = Trainer(model_from_json(j_to_json(jm)), EngineConfig(**kw),
                 params=params, device="cpu")
    labels = labels.astype(np.float32)
    jloss, jgrads = _jax_value_and_grad(jtr, batch, labels)
    loss, grads = tr.value_and_grad(batch, labels)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert set(grads["stacked"]) == set(jgrads["stacked"])
    for gid, g in grads["stacked"].items():
        np.testing.assert_allclose(g.numpy(), np.asarray(
            jgrads["stacked"][gid]), rtol=1e-4, atol=1e-6,
            err_msg=f"table {gid}")
    assert set(grads["tower"]) == set(jgrads["tower"])
    for key, layers in grads["tower"].items():
        for i, layer in enumerate(layers):
            for wb in ("w", "b"):
                np.testing.assert_allclose(
                    layer[wb].numpy(), np.asarray(jgrads["tower"][key][i][wb]),
                    rtol=1e-4, atol=1e-6, err_msg=f"tower {key}[{i}].{wb}")


def _same_batch(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, list):
            assert len(x) == len(y)
            for rx, ry in zip(x, y):
                np.testing.assert_array_equal(np.asarray(rx), np.asarray(ry),
                                              err_msg=k)
        else:
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("seed", range(8))
def test_generator_copy_matches_test_fuzz(seed):
    a = np.random.default_rng(1000 + seed)
    b = np.random.default_rng(1000 + seed)
    jm = test_fuzz.random_model(a, int(a.integers(3, 9)))
    tm = chip_smoke.random_model(b, int(b.integers(3, 9)))
    assert model_to_json(tm) == j_to_json(jm)
    _same_batch(test_fuzz.random_batch(a, jm, int(a.integers(5, 40))),
                chip_smoke.random_batch(b, tm, int(b.integers(5, 40))))
    assert a.random() == b.random()      # the same number of draws


def test_card_seeds_cover_every_kernel_and_axis():
    """``chip_smoke.fuzz_phases`` fails unless each kernel launches and
    each config axis comes up in its seeds; this holds its seed list to
    that on the CPU, by the lowering (``fuzz_launches``) and the draws."""
    totals = dict.fromkeys(chip_smoke.KERNEL_META, 0)
    axes = set()
    for seed in range(chip_smoke.FUZZ_SEEDS):
        model, kw, batch, _ = chip_smoke.fuzz_case(seed)
        axes |= {kw["table_dtype"], ("pallas", kw["use_pallas"]),
                 ("dedup", kw["dedup_subcolumns"])}
        if not kw["host_bucketize"]:
            axes.add(("raw floats, wire", kw["wire_pack"]))
        cfg = EngineConfig(**kw)
        eng = Engine(model, cfg, device="cpu")
        counts = chip_smoke.fuzz_launches(
            eng.compiled, cfg, eng.prepare(batch),
            chip_smoke.fuzz_trains(seed, kw))
        for k, n in counts.items():
            totals[k] += n
    assert not [k for k, n in totals.items() if n == 0], totals
    want = {"float32", "bfloat16", "int8"} | {
        (a, v) for a in ("pallas", "dedup", "raw floats, wire")
        for v in (False, True)}
    assert want <= axes, want - axes


@pytest.mark.parametrize("seed", [0, 5, 14, 24, 31, 38, 46])
def test_card_seeds_on_cpu(seed):
    """Card seeds (card widths: dims 1-64, vocabs to 70 000, lists to 128,
    batches 1-2048) through ``chip_smoke.fuzz_seed`` with the "card" on
    the CPU: the oracle's gates and, on even f32 seeds, the staged
    training check (the CPU against itself: its shapes and bookkeeping).
    Seeds 5, 14, 46: where the first card runs failed; 24, 31, 38: batch
    1, K2-bf16 with X2, K3b."""
    rec = chip_smoke.fuzz_seed(torch, seed, device="cpu", oracle=jax_oracle)
    assert rec["err"] == 0.0
    assert ("loss" in rec) == chip_smoke.fuzz_trains(seed, rec["config"])


def _post_model(S, d):
    """A reduce_sum and a reduce_mean column at width ``d``, each after an
    affine whose bias makes the partial sums large against the result."""
    rng = np.random.default_rng(d)
    tables = {"t": S.TableSpec("t", 50, d, init_seed=d)}
    cols = []
    for op in ("reduce_sum", "reduce_mean"):
        cols.append(S.FeatureColumn(
            op, S.FeatureSource(op, S.FeatureKind.DENSE_INT),
            (S.HashBucket(50),), S.LookupSpec("t", S.Combiner.SUM),
            post=(S.PostPool("affine",
                             scale=tuple(rng.uniform(0.5, 2.0, d)),
                             bias=(float(rng.uniform(-1, 1)),)),
                  S.PostPool(op))))
    return S.ModelSpec("post", tables, cols, S.TowerSpec(
        arch="mlp", bottom_mlp=(), top_mlp=(4, 1), final_activation=None))


@pytest.mark.parametrize("d", [1, 3, 8, 12, 33, 64, 129, 200])
def test_post_reductions_are_the_oracles_bits(d):
    model = _post_model(ts, d)
    rng = np.random.default_rng(5)
    batch = {op: rng.integers(0, 10**6, 64)
             for op in ("reduce_sum", "reduce_mean")}
    params = init_model_params(model)
    out = Engine(model, EngineConfig(batch_buckets=(64,)), params=params,
                 device="cpu").predict(batch, return_concat=True)
    jref = JOracle(_post_model(js, d), params).forward(batch)
    np.testing.assert_array_equal(out["concat"], jref["concat"])
    ref = OracleModel(model, params).forward(batch)
    np.testing.assert_array_equal(out["concat"], ref["concat"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 4, 5, 14, 46])
def test_card_seed_on_card(cuda, seed):
    """``chip_smoke.fuzz_seed`` on the card: the oracle, the CPU Engine,
    exact launch counts and (even f32 seeds) a training step."""
    rec = chip_smoke.fuzz_seed(torch, seed, device="cuda",
                               oracle=jax_oracle)
    assert rec["seed"] == seed


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_random_model_on_card(cuda, seed):
    """tests/test_fuzz.py's first models served on the card: pooled ``==``
    the JAX package's oracle and the port's, the concat as the source
    holds it."""
    rng = np.random.default_rng(1000 + seed)
    model = chip_smoke.random_model(rng, int(rng.integers(3, 9)))
    batch = chip_smoke.random_batch(rng, model, int(rng.integers(5, 40)))
    params = init_model_params(model)
    out = Engine(model, EngineConfig(use_pallas=bool(seed % 2)),
                 params=params, device="cuda").predict(
        batch, return_pooled=True, return_concat=True)
    for ref in (jax_oracle(model, params, batch),
                OracleModel(model, params).forward(batch)):
        for c, r in ref["pooled"].items():
            np.testing.assert_array_equal(out["pooled"][c], r, err_msg=c)
        _assert_concat(out["concat"], ref["concat"], model)
