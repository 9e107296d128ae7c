"""The port's measurement tools (recom_tpu_torch/tools/) on the CPU, held
against the JAX package's tools (recom_tpu/tools/) on the same numpy data
from one seed: the naive arm's host prep (``==``) and forward (rtol 1e-4 /
atol 1e-5), the bw_breakdown model specs (serde JSON ``==``), the
embedding_bw pooled round and a ragged_bench rung (``==`` JAX
``group_pooled``; byte counts ``==``), the row keys of ae_sweep and
benchmark, the tf_baseline copy (``==`` where TF imports), and model F's
Engine.  Every tool runs on the card unless asked for the CPU, and raises
where there is none."""

import json
import os

import numpy as np
import pytest
import torch

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.models import make_random_batch
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig
from recom_tpu_torch.models import make_dlrm_model as t_make_dlrm

torch.set_num_threads(1)

NAIVE = (3, 2, 3, 2, 1, 2, [8], [16])
NAIVE_KW = dict(name="naive_t", small_rows=40, mid_rows=300,
                large_rows=1 << 14)
MINI = (6, 2, 2, 2, 1, 4, [8], [16])


def _mini(large_rows=20_000):
    jm = j_make_dlrm(*MINI, name="mini", large_rows=large_rows)
    tm = t_make_dlrm(*MINI, name="mini", large_rows=large_rows)
    return jm, tm, init_model_params(jm)


def _tiny_jax_model(name):
    """The JAX tools' ``_make_model`` in the key tests: the same tiny model
    for every name (row keys do not depend on the model)."""
    return j_make_dlrm(*MINI, name="mini", large_rows=2048)


# ---- naive_gpu --------------------------------------------------------------

def test_naive_prepare_matches_jax():
    from recom_tpu.tools.naive_tpu import naive_prepare as j_prepare
    from recom_tpu_torch.tools.naive_gpu import naive_prepare

    jm = j_make_dlrm(*NAIVE, **NAIVE_KW)
    tm = t_make_dlrm(*NAIVE, **NAIVE_KW)
    b = make_random_batch(jm, 32, seed=5)
    want, got = j_prepare(jm, b, 32), naive_prepare(tm, b, 32)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_naive_forward_fresh_content_and_agreement():
    """The port of test_tools.py's naive test: the device-step forward is
    finite, in the sigmoid's range and fresh per seed; the forward on host
    prepared arrays matches the JAX naive forward (rtol 1e-4 / atol 1e-5)
    and the port's Engine (atol 1e-4)."""
    from recom_tpu.tools.naive_tpu import build_naive_fn as j_build
    from recom_tpu.tools.naive_tpu import naive_prepare as j_prepare
    from recom_tpu_torch.tools.naive_gpu import (
        build_naive_device_fn,
        build_naive_fn,
        naive_params,
        naive_prepare,
    )

    jm = j_make_dlrm(*NAIVE, **NAIVE_KW)
    tm = t_make_dlrm(*NAIVE, **NAIVE_KW)
    np_params = init_model_params(jm)
    tables, tower = naive_params(np_params, "cpu")

    dev_fn = build_naive_device_fn(tm, 32)
    o1 = dev_fn(tables, tower, 1).numpy()
    o2 = dev_fn(tables, tower, 2).numpy()
    assert o1.shape == (32, 1) and np.isfinite(o1).all()
    assert (o1 > 0).all() and (o1 < 1).all()
    assert not np.array_equal(o1, o2), "seeds must yield fresh content"
    np.testing.assert_array_equal(dev_fn(tables, tower, 1).numpy(), o1)

    b = make_random_batch(jm, 32, seed=5)
    arrays = {k: torch.from_numpy(v)
              for k, v in naive_prepare(tm, b, 32).items()}
    out = build_naive_fn(tm)(tables, tower, arrays).numpy()
    jt = {k: np.asarray(v, np.float32)
          for k, v in np_params["tables"].items()}
    jout = np.asarray(j_build(jm)(jt, np_params["tower"],
                                  j_prepare(jm, b, 32)))
    np.testing.assert_allclose(out, jout, rtol=1e-4, atol=1e-5)
    eng_out = Engine(tm, EngineConfig(), params=np_params,
                     device="cpu").predict(b)["output"]
    np.testing.assert_allclose(out, eng_out, atol=1e-4)


def test_naive_measurements_on_cpu():
    from recom_tpu_torch.tools.naive_gpu import (
        measure_naive,
        measure_naive_device,
    )

    jm = j_make_dlrm(*NAIVE, **NAIVE_KW)
    tm = t_make_dlrm(*NAIVE, **NAIVE_KW)
    np_params = init_model_params(jm)
    bats = [make_random_batch(jm, 16, seed=40 + i) for i in range(3)]
    eng = Engine(tm, EngineConfig(), params=np_params, device="cpu")
    row = measure_naive(tm, np_params, bats, 16, sanity_engine=eng,
                        device="cpu")
    assert row["arm"] == "naive_gpu" and row["distinct_inputs"] == 2
    assert row["request_ms_async"] > 0 and row["host_prep_ms"] > 0
    drow = measure_naive_device(tm, np_params, 16, n=3, device="cpu")
    assert drow["arm"] == "naive_gpu_device_step"
    assert drow["device_step_ms"] > 0


# ---- bw_breakdown -------------------------------------------------------------

def test_bw_breakdown_specs_match_jax():
    from recom_tpu.ir.serde import model_to_json as j_json
    from recom_tpu.tools import bw_breakdown as jbw
    from recom_tpu_torch.ir.serde import model_to_json as t_json
    from recom_tpu_torch.tools import bw_breakdown as tbw

    jm, tm, _ = _mini()
    assert t_json(tbw._identity_tower(tm)) == j_json(jbw._identity_tower(jm))
    eng = Engine(tm, EngineConfig(), device="cpu")
    assert len(eng.compiled.groups) == 4
    for g in eng.compiled.groups:
        names = [m.column.name for m in g.members]
        assert t_json(tbw._single_group_model(tm, names)) == j_json(
            jbw._single_group_model(jm, names)), g.gid


def test_bw_breakdown_run_on_cpu():
    """Each group alone lowers to one group on the full model's backend
    (run asserts it); the keys of the JAX tool's output."""
    from recom_tpu_torch.tools import bw_breakdown as tbw

    _, tm, params = _mini()
    res = tbw.run(tm, 32, n_inputs=6, params=params, device="cpu")
    for k in ("model", "batch", "cmd", "protocol", "full_step_ms",
              "full_windows_ms", "emb_only_step_ms", "emb_only_windows_ms",
              "tower_ms", "groups", "sum_groups_ms", "fusion_residual_ms",
              "lookup_gbps_full", "lookup_gbps_emb_only", "hbm_peak_gbps"):
        assert k in res, k
    assert [g["kernel"] for g in res["groups"]] == [
        "onehot (K1)", "gather (X1)", "gather (X1)", "gather (X1)"]
    assert res["hbm_peak_gbps"] is None      # no card


# ---- embedding_bw and ragged_bench --------------------------------------------

def test_embedding_bw_pooled_round_and_bytes_match_jax():
    import jax.numpy as jnp

    from recom_tpu.ops import lookup_xla
    from recom_tpu.tools.embedding_bw import embedding_only_bench as j_bench
    from recom_tpu_torch.ops.lookup_gather import groups_pooled
    from recom_tpu_torch.tools import embedding_bw as tbw

    jm, tm, params = _mini()
    batch = make_random_batch(jm, 64, seed=3)
    eng = Engine(tm, EngineConfig(), params=params, device="cpu")
    gb = tbw.bench_group(eng, batch)
    table = gb["table"]
    for i in (0, 7, 1 << 20):
        ids = tbw.perturb(gb["ids0"], i, gb["rows"])
        assert int(ids.min()) >= 0 and int(ids.max()) < gb["rows"]
        ids32 = ids.to(torch.int32)
        got = groups_pooled([(table, ids32) + gb["x1_consts"]])[0]
        want = np.asarray(lookup_xla.group_pooled(
            jnp.asarray(table.numpy()),
            jnp.asarray(ids32.numpy().transpose(1, 0, 2)),
            gb["offsets"], gb["comb"]))
        np.testing.assert_array_equal(got.numpy(), want)
    res = tbw.embedding_only_bench(eng, batch, rounds=2, windows=1)
    assert res["detail"]["pooled_equals_plain"] is True
    jres = j_bench(JEngine(jm, JConfig(), params=params), batch, rounds=2,
                   windows=1)
    for k in ("table_rows", "table_dim", "table_bytes",
              "rows_gathered_per_step", "bytes_per_step", "group_gid"):
        assert res["detail"][k] == jres["detail"][k], k
    assert res["vs_baseline"] is None and res["detail"]["card"] is None


@pytest.mark.parametrize("L", [16, 128])
def test_ragged_rung_matches_jax(L):
    import jax.numpy as jnp

    from recom_tpu.ops import lookup_xla
    from recom_tpu_torch.ops.lookup_gather import groups_pooled
    from recom_tpu_torch.tools.ragged_bench import bench_rung, rung_inputs

    table, sets, offs, code = rung_inputs(L, 16, 6, 8, 2000, iters=1)
    # the reference tool's draws, in its order: the same numbers
    rng = np.random.default_rng(L)
    np.testing.assert_array_equal(
        table, rng.standard_normal((2000, 8)).astype(np.float32))
    ids_ref = rng.integers(0, 2000, size=(16, 6, L)).astype(np.int32)
    ids_ref[rng.random(ids_ref.shape) < 0.3] = -1
    np.testing.assert_array_equal(sets[0].transpose(1, 0, 2), ids_ref)
    for ids in sets:
        got = groups_pooled([(torch.from_numpy(table), torch.from_numpy(ids),
                              offs, code)])[0].numpy()
        want = np.asarray(lookup_xla.group_pooled(
            jnp.asarray(table), jnp.asarray(ids.transpose(1, 0, 2)), offs,
            code))
        np.testing.assert_array_equal(got, want)
    row = bench_rung(L, 16, 6, 8, 2000, iters=2, device="cpu")
    assert row["L"] == L and row["max_abs_err"] == 0.0
    assert row["library_max_abs_err"] < 1e-5 and row["bound_by"] == "bytes"


# ---- ae_sweep -----------------------------------------------------------------

def _keys(rows):
    return [sorted(r) for r in rows]


def test_sweep_model_rows_have_jax_keys(monkeypatch):
    from recom_tpu.tools import ae_sweep as jsweep
    from recom_tpu_torch.tools import ae_sweep as tsweep

    pytest.importorskip("tensorflow")     # both tools add TF's keys
    monkeypatch.setattr(jsweep, "_make_model", _tiny_jax_model)
    jrows, trows = [], []
    jsweep.sweep_model("E@0.05", [32, 64], 2, jrows, tf_iters=2)
    err = tsweep.sweep_model("E@0.05", [32, 64], 2, trows, tf_iters=2,
                             min_inputs=2, device="cpu")
    assert err is None                      # TF imports here
    assert _keys(trows) == _keys(jrows)
    assert [r["batch"] for r in trows[:2]] == [32, 64]
    assert trows[0]["model"] == "E@0.05" and trows[0]["tf_cpu_ms"] > 0


def test_sweep_model_records_a_missing_tf(monkeypatch):
    from recom_tpu_torch.tools import ae_sweep as tsweep

    def no_tf(model, params):
        return None, None, "TF baseline unavailable: ImportError('tf')"

    monkeypatch.setattr(tsweep, "tf_arm", no_tf)
    _, tm, params = _mini(2048)
    rows = []
    err = tsweep.sweep_model(tm, [32], 2, rows, params=params, min_inputs=2,
                             device="cpu", naive_arm=True)
    assert err.startswith("TF baseline unavailable")
    assert rows[0]["tf_cpu_ms"] is None and rows[0]["vs_tf_cpu"] is None
    for k in ("naive_device_step_ms", "vs_naive_gpu",
              "naive_request_ms_async", "vs_naive_gpu_e2e"):
        assert rows[0][k] > 0, k


def test_workers_sweep_rows_have_jax_keys(monkeypatch):
    from recom_tpu.tools import ae_sweep as jsweep
    from recom_tpu_torch.tools import ae_sweep as tsweep

    monkeypatch.setattr(jsweep, "_make_model", _tiny_jax_model)
    jrows, trows = [], []
    jsweep.workers_sweep("E", 32, 10, [2, 4], jrows)
    _, tm, params = _mini(2048)
    tsweep.workers_sweep(tm, 32, 10, [2, 4], trows, params=params,
                         device="cpu")
    assert _keys(trows) == _keys(jrows)
    assert [r["serve_workers"] for r in trows] == [2, 4]
    assert all(len(r["windows_ms"]) == 5 for r in trows)


# ---- benchmark ----------------------------------------------------------------

def test_run_benchmark_keys_and_profile(tmp_path):
    from recom_tpu.models import make_microbenchmark_model as j_micro
    from recom_tpu.tools.benchmark import run_benchmark as j_run
    from recom_tpu_torch.tools.benchmark import model_from_name, run_benchmark

    jres = j_run(j_micro(100), batch_size=32, num_iterations=2, warmup=1)
    res = run_benchmark(model_from_name("micro100"), batch_size=32,
                        num_iterations=2, serve_workers=2, warmup=1,
                        profile=True, profile_dir=str(tmp_path),
                        device="cpu")
    assert set(jres) <= set(res) and set(res) - set(jres) == {"profile"}
    assert set(res["latency_ms"]) == set(jres["latency_ms"])
    assert res["model"] == "micro100" and res["serve_workers"] == 2
    trace = res["profile"]["trace"]
    assert trace == os.path.join(str(tmp_path), "trace.json")
    with open(trace) as f:
        assert "traceEvents" in json.load(f)


def test_benchmark_mesh_raises_naming_item_13():
    """``--mesh`` serves on a world of ranks (tests/test_torch_mesh_train.py
    runs --mesh 1x2 --spawn 2); with neither torchrun's environment nor
    --spawn it raises, naming both."""
    from recom_tpu_torch.tools import benchmark

    with pytest.raises(RuntimeError, match="torchrun.*--spawn"):
        benchmark.main(["--model", "micro10", "--mesh", "2x4",
                        "--device", "cpu"])
    assert benchmark.config_for_mesh("1x1").mesh_shape is None
    assert benchmark.config_for_mesh("2x4").mesh_shape == (2, 4)


def test_benchmark_cli_embedding_only_on_cpu(capsys):
    from recom_tpu_torch.tools import benchmark

    res = benchmark.main(["--model", "micro20", "--batch-size", "16",
                          "--num-iterations", "2", "--embedding-only",
                          "--device", "cpu"])
    assert res["embedding_only"] and res["card"] is None
    assert json.loads(capsys.readouterr().out)["model"] == "micro20"


@pytest.mark.parametrize("tool", ["ae_sweep", "benchmark", "bw_breakdown",
                                  "embedding_bw", "ragged_bench",
                                  "naive_gpu"])
def test_tools_default_to_the_card(tool, monkeypatch):
    """Without ``--device`` every tool asks for CUDA, and raises where
    torch sees none: no tool falls back to the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"recom_tpu_torch.tools.{tool}")
    argv = {"ae_sweep": ["--models", "E@0.01", "--batches", "32"],
            "benchmark": ["--model", "micro10"],
            "bw_breakdown": ["--model", "E@0.01"],
            "embedding_bw": ["--model", "E@0.01"],
            "ragged_bench": ["--rungs", "16"],
            "naive_gpu": ["--model", "E@0.01", "--batches", "32"]}[tool]
    with pytest.raises(RuntimeError, match="is_available"):
        mod.main(argv)


# ---- tf_baseline (a copy) ------------------------------------------------------

def test_tf_baseline_copy_matches_jax_tool():
    pytest.importorskip("tensorflow")
    from recom_tpu.tools.tf_baseline import build_tf_baseline as j_build
    from recom_tpu_torch.tools.tf_baseline import build_tf_baseline

    jm, tm, params = _mini(2048)
    batch = make_random_batch(jm, 24, seed=9)
    jfn, jfeed = j_build(jm, params)
    tfn, tfeed = build_tf_baseline(tm, params)
    np.testing.assert_array_equal(np.asarray(tfn(tfeed(batch))),
                                  np.asarray(jfn(jfeed(batch))))


# ---- model F ------------------------------------------------------------------

def test_model_f_scaled_matches_jax_engine():
    from recom_tpu.models import make_model_f as j_make_f
    from recom_tpu_torch.models import make_model_f as t_make_f

    jm, tm = j_make_f(scale=0.05), t_make_f(scale=0.05)
    params = init_model_params(jm)
    batch = make_random_batch(jm, 48, seed=4)
    jout = JEngine(jm, JConfig(), params=params).predict(
        batch, return_pooled=True)
    eng = Engine(tm, EngineConfig(), params=params, device="cpu")
    out = eng.predict(batch, return_pooled=True)
    assert set(out["pooled"]) == set(jout["pooled"])
    for col, want in jout["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], want, err_msg=col)
    np.testing.assert_allclose(out["output"], jout["output"], rtol=1e-4,
                               atol=1e-5)
    # its tower's shapes give each row the same bits in every bucket
    full = out["output"]
    for n in (1, 20):
        sub = {k: v[:n] for k, v in batch.items()}
        np.testing.assert_array_equal(eng.predict(sub)["output"], full[:n])


# ---- tf_sweep, plot_ae and auc_parity -------------------------------------------

def test_tf_sweep_merges_tf_cells(tmp_path, monkeypatch):
    pytest.importorskip("tensorflow")
    from recom_tpu_torch.tools import ae_sweep as tsweep
    from recom_tpu_torch.tools import tf_sweep

    monkeypatch.setattr(tsweep, "_make_model", lambda name: t_make_dlrm(
        *MINI, name=name, large_rows=2048))
    art = tmp_path / "AE.json"
    art.write_text(json.dumps({"sweep": [
        {"model": "E", "batch": 32, "request_ms_async": 2.0},
        {"model": "E", "engine_build_s": 1.0}]}))
    tf_sweep.main(["--models", "E", "--batches", "32", "--iters", "2",
                   "--merge-into", str(art)])
    doc = json.loads(art.read_text())
    row = doc["sweep"][0]
    assert row["tf_cpu_ms"] > 0
    # both rounded to 2 decimals from the same unrounded TF time
    assert abs(row["vs_tf_cpu"] - row["tf_cpu_ms"] / 2.0) <= 0.01
    assert doc["baseline"].startswith("tf_cpu")


def test_plot_ae_copy_renders_artifacts(tmp_path):
    import subprocess
    import sys

    pytest.importorskip("matplotlib")
    sp, tp = tmp_path / "AE.json", tmp_path / "THR.json"
    sp.write_text(json.dumps({"sweep": [
        {"model": "E", "engine_build_s": 1.0},
        *[{"model": "E", "batch": b, "examples_per_s": b * 10.0,
           "request_ms_async": b / 100.0, "tf_cpu_ms": b / 2.0,
           "vs_tf_cpu": 50.0} for b in (32, 128, 512)]]}))
    tp.write_text(json.dumps({"throughput_sweep": [
        {"serve_workers": w, "examples_per_s": 1000.0 * w,
         "request_ms": 1.0} for w in (2, 4)]}))
    out = subprocess.run(
        [sys.executable, "-m", "recom_tpu_torch.tools.plot_ae",
         "--sweep", str(sp), "--throughput", str(tp),
         "--out-dir", str(tmp_path), "--tag", "t"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    for f in ("latency_t.png", "speedup_t.png", "throughput_t.png"):
        assert (tmp_path / f).stat().st_size > 1000, f


def test_auc_midranks_match_jax():
    from recom_tpu.tools.auc_parity import auc as j_auc
    from recom_tpu_torch.tools.auc_parity import auc

    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(5, 60))
        y = rng.integers(0, 2, n)
        s = rng.choice([0.0, 0.25, 0.5, 1.0], n)
        assert auc(y, s) == j_auc(y, s)
    assert auc(np.array([1, 0, 1, 0]), np.zeros(4)) == 0.5


def test_auc_parity_engine_side_matches_jax():
    """The engine side of auc_parity on the port's Trainer against the JAX
    Trainer: the same losses step by step (rtol 1e-5) and AUC."""
    from recom_tpu.tools import auc_parity as jap
    from recom_tpu_torch.tools import auc_parity as tap

    model_j, model_t = jap.make_model(), tap.make_model()
    params = init_model_params(model_j)
    stream = tap.batch_stream(100, 6, 64)
    eval_batch, eval_labels = tap.make_data(np.random.default_rng(999),
                                            tap.EVAL_N)
    a_t, l_t = tap.train_engine(model_t, params, stream, eval_batch,
                                eval_labels, 1e-3, device="cpu")
    a_j, l_j = jap.train_engine(model_j, params, stream, eval_batch,
                                eval_labels, 1e-3)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    assert abs(a_t - a_j) < 1e-3 and 0.0 <= a_t <= 1.0
