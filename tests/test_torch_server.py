"""The port's ServingPipeline, throughput_under_sla and Engine.dispatch on
the CPU (every kernel's plain version), mirroring tests/test_server.py:
the pipeline's outputs are `==` the same engine's sequential `predict`, in
FIFO order, from one or two submitting threads, and match the JAX pipeline
on the same params and batches (pooled `==`, the output at rtol 1e-4 /
atol 1e-5, the tower tolerance of tests/test_engine.py)."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.runtime.server import ServingPipeline as JPipeline
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig, ServingPipeline
from recom_tpu_torch.models import make_dlrm_model as t_make_dlrm
from recom_tpu_torch.runtime.server import throughput_under_sla

SRV = (6, 2, 2, 2, 1, 4, [8], [16, 1])


def _engines(buckets=(32,)):
    jm = j_make_dlrm(*SRV, name="srv", large_rows=2048)
    tm = t_make_dlrm(*SRV, name="srv", large_rows=2048)
    params = init_model_params(jm)
    cfg = dict(use_pallas=False, batch_buckets=buckets)
    return (jm, JEngine(jm, JConfig(**cfg), params=params),
            Engine(tm, EngineConfig(**cfg), params=params, device="cpu"))


def test_pipeline_matches_sequential_predict():
    jm, jeng, eng = _engines()
    batches = [make_random_batch(jm, 32, seed=100 + i) for i in range(6)]
    want = [eng.predict(b, return_pooled=True) for b in batches]
    with ServingPipeline(eng, prep_workers=3, max_inflight=3) as pipe:
        got = pipe.map_stream(batches)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w["output"])
    assert pipe.stats["completed"] == len(batches)
    # the JAX pipeline on the same params and batches
    with JPipeline(jeng, prep_workers=3, max_inflight=3) as jpipe:
        jgot = jpipe.map_stream(batches)
    for g, j, w, b in zip(got, jgot, want, batches):
        np.testing.assert_allclose(g, j, rtol=1e-4, atol=1e-5)
        jpooled = jeng.predict(b, return_pooled=True)["pooled"]
        for col, p in jpooled.items():
            np.testing.assert_array_equal(w["pooled"][col], p, err_msg=col)


def test_pipeline_two_submitting_threads_match_sequential_predict():
    jm, _, eng = _engines(buckets=(16, 32))
    sizes = [32, 16, 25, 32, 9, 30, 16, 32]
    batches = [make_random_batch(jm, bs, seed=700 + i)
               for i, bs in enumerate(sizes)]
    want = [eng.predict(b)["output"] for b in batches]
    got = [None] * len(batches)
    with ServingPipeline(eng, prep_workers=4, max_inflight=4) as pipe:
        def submitter(idx):
            futs = [(i, pipe.submit(batches[i]))
                    for i in range(idx, len(batches), 2)]
            for i, f in futs:
                got[i] = f.result(timeout=120)

        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert pipe.stats["completed"] == len(batches)


def test_completer_resolves_futures_in_fifo_order(monkeypatch):
    """One prep worker dispatches in submission order; the completer, held
    on its first wait until every dispatch has queued, resolves the
    futures in that order."""
    jm, _, eng = _engines()
    batches = [make_random_batch(jm, 32, seed=800 + i) for i in range(8)]
    want = [eng.predict(b)["output"] for b in batches]
    real = ServingPipeline._wait_batch
    first = []

    def slow_first(items):
        if not first:
            first.append(1)
            time.sleep(0.5)
        real(items)

    monkeypatch.setattr(ServingPipeline, "_wait_batch",
                        staticmethod(slow_first))
    order = []
    with ServingPipeline(eng, prep_workers=1, max_inflight=8) as pipe:
        futs = [pipe.submit(b) for b in batches]
        for i, f in enumerate(futs):
            f.add_done_callback(lambda _, i=i: order.append(i))
        got = [f.result(timeout=120) for f in futs]
    assert order == list(range(len(batches)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pipeline_mixed_batch_sizes_and_signatures():
    jm, _, eng = _engines(buckets=(16, 32))
    batches = [
        make_random_batch(jm, bs, seed=i)
        for i, bs in enumerate([16, 32, 25, 16, 30])
    ]
    with ServingPipeline(eng, prep_workers=2, max_inflight=2) as pipe:
        outs = pipe.map_stream(batches)
    for b, o, bt in zip([16, 32, 25, 16, 30], outs, batches):
        assert o.shape[0] == b
        assert np.isfinite(o).all()
        np.testing.assert_array_equal(o, eng.predict(bt)["output"])


def test_pipeline_fetch_outputs_false_returns_device_tensor():
    jm, _, eng = _engines()
    b = make_random_batch(jm, 30, seed=9)
    with ServingPipeline(eng, fetch_outputs=False) as pipe:
        out = pipe.submit(b).result(timeout=120)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), eng.predict(b)["output"])


def test_throughput_under_sla_reports_ladder():
    jm, _, eng = _engines()
    batches = [make_random_batch(jm, 32, seed=i) for i in range(2)]
    rep = throughput_under_sla(
        eng, batches, sla_ms=10_000.0, num_iterations=3,
        worker_ladder=(1, 2),
    )
    assert rep["best_under_sla"] is not None
    assert rep["best_under_sla"]["workers"] == 2
    assert all(r["meets_sla"] for r in rep["ladder"])
    # an impossible SLA stops the ladder at the first rung
    rep2 = throughput_under_sla(
        eng, batches, sla_ms=0.0, num_iterations=2, worker_ladder=(1, 2),
    )
    assert rep2["best_under_sla"] is None
    assert len(rep2["ladder"]) == 1
    # distinct content for every timed request
    made = []
    rep3 = throughput_under_sla(
        eng, batches, sla_ms=10_000.0, num_iterations=2,
        worker_ladder=(2,),
        batch_factory=lambda k: made.append(k) or make_random_batch(
            jm, 32, seed=900 + k),
    )
    assert sorted(made) == list(range(4))
    assert rep3["ladder"][0]["examples_per_s"] > 0


def test_pipeline_retries_transient_failures(monkeypatch):
    jm, _, eng = _engines()
    b = make_random_batch(jm, 32, seed=1)
    want = eng.predict(b)["output"]

    calls = {"n": 0}
    orig = ServingPipeline._dispatch

    def flaky(self, batch, batch_size):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return orig(self, batch, batch_size)

    monkeypatch.setattr(ServingPipeline, "_dispatch", flaky)
    with ServingPipeline(eng, retries=1) as pipe:
        out = pipe.submit(b).result()
        assert pipe.stats["retries"] == 1
    np.testing.assert_array_equal(out, want)
    # retries=0: the exception surfaces
    calls["n"] = 0
    with ServingPipeline(eng, retries=0) as pipe:
        fut = pipe.submit(b)
        with pytest.raises(RuntimeError, match="transient"):
            fut.result()


def test_pipeline_future_carries_a_failing_wait(monkeypatch):
    """An error the device reports (here: the wait raises, as an event
    synchronize does after a failed kernel) is retried, then carried by
    the future: never resolved as None."""
    jm, _, eng = _engines()
    b = make_random_batch(jm, 32, seed=2)

    def broken(items):
        raise RuntimeError("device fault")

    monkeypatch.setattr(ServingPipeline, "_wait_batch", staticmethod(broken))
    with ServingPipeline(eng, retries=2) as pipe:
        fut = pipe.submit(b)
        with pytest.raises(RuntimeError, match="device fault"):
            fut.result(timeout=120)
        assert pipe.stats["retries"] == 2
        assert pipe.stats["completed"] == 0


def test_prep_admission_cap():
    """ServingPipeline bounds concurrent host preps at cores + 1; an
    explicit small ask holds, and it still serves at over-subscribed
    offered load."""
    jm, _, eng = _engines()
    cores = len(os.sched_getaffinity(0)) or (os.cpu_count() or 1)
    with ServingPipeline(eng, prep_workers=64, max_inflight=64) as pipe:
        assert pipe.effective_prep_workers == min(64, cores + 1)
        assert pipe._pool._max_workers == pipe.effective_prep_workers
        batches = [make_random_batch(jm, 32, seed=500 + i) for i in range(6)]
        outs = [pipe.submit(b) for b in batches]
        for f, b in zip(outs, batches):
            np.testing.assert_array_equal(f.result(),
                                          eng.predict(b)["output"])
    with ServingPipeline(eng, prep_workers=2, max_inflight=2) as pipe:
        assert pipe.effective_prep_workers == 2   # explicit small asks hold


@pytest.mark.parametrize("mode", [(), ("pooled",), ("concat", "pooled")])
def test_dispatch_result_equals_predict_prepared(mode):
    jm, _, eng = _engines()
    b = make_random_batch(jm, 27, seed=3)
    prepared = eng.prepare(b)
    rec = eng.dispatch(prepared, mode)
    assert rec.event is None          # the CPU ran the forward in the call
    got = rec.result()
    want = eng.predict_prepared(prepared, return_pooled="pooled" in mode,
                                return_concat="concat" in mode)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["output"], want["output"])
    assert got["output"].shape == (27, 1) and got["a2a_overflow"] == 0
    if "concat" in mode:
        np.testing.assert_array_equal(got["concat"], want["concat"])
    if "pooled" in mode:
        for col, p in want["pooled"].items():
            np.testing.assert_array_equal(got["pooled"][col], p)
    with pytest.raises(RuntimeError, match="fetch=False"):
        eng.dispatch(prepared, fetch=False).result()
    assert "device_step" in eng.timers.summary()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pipeline_on_card_matches_sequential_predict(cuda):
    """On the card: dispatch returns with the forward queued (pinned copies,
    an event), the pipeline's outputs == sequential predict, and a warmed
    dispatch makes no host sync."""
    from recom_tpu_torch.ops import kernels

    jm = j_make_dlrm(*SRV, name="srv", large_rows=2048)
    tm = t_make_dlrm(*SRV, name="srv", large_rows=2048)
    eng = Engine(tm, EngineConfig(batch_buckets=(16, 32)),
                 params=init_model_params(jm), device=cuda)
    batches = [make_random_batch(jm, bs, seed=40 + i)
               for i, bs in enumerate([32, 16, 25, 32, 9, 30])]
    want = [eng.predict(b)["output"] for b in batches]
    kernels.reset_launches()
    with ServingPipeline(eng, prep_workers=3, max_inflight=3) as pipe:
        got = pipe.map_stream(batches)
    assert kernels.launches["X1"] == len(batches)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    prepared = eng.prepare(batches[0])
    rec = eng.dispatch(prepared, ("pooled",))
    assert rec.event is not None and rec.host["output"].is_pinned()
    warm = rec.result()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec = eng.dispatch(prepared, ("pooled",))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = rec.result()
    np.testing.assert_array_equal(out["output"], warm["output"])
    for col, p in warm["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], p)
