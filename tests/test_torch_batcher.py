"""The port's MicroBatcher (runtime/batcher.py, a copy of the reference's)
on the port's Engine on the CPU, mirroring tests/test_batcher.py: coalesced
requests serve bit-exactly (`==`) what each request gets alone, under real
threading.  Beyond the reference's single-bucket test, the cross-bucket
case: requests alone pad to one batch bucket and coalesced ones to a
larger one, through a tower whose first product has K >= 300, where a
plain `addmm` gives rows that depend on the row count (the Engine runs
every row-wise product on fixed row tiles, executor.row_linear)."""

import numpy as np
import pytest

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig, MicroBatcher
from recom_tpu_torch.runtime.batcher import merge_requests


def _engine(name, buckets=(32,), shape=(2, 1, 1, 1, 0, 2, [4], [8, 1])):
    jm = j_make_dlrm(*shape, name=name)
    tm = t_make(shape, name)
    params = init_model_params(jm)
    return jm, params, Engine(
        tm, EngineConfig(use_pallas=False, batch_buckets=buckets),
        params=params, device="cpu")


def t_make(shape, name):
    from recom_tpu_torch.models import make_dlrm_model

    return make_dlrm_model(*shape, name=name)


def test_microbatch_bitexact_vs_individual():
    m, params, eng = _engine("mb")
    rng = np.random.default_rng(0)
    reqs = [
        make_random_batch(m, int(rng.integers(1, 9)), seed=100 + i)
        for i in range(7)
    ]
    want = [np.asarray(eng.predict(r)["output"]) for r in reqs]

    with MicroBatcher(eng, max_delay_ms=30.0) as mb:
        futs = [mb.submit(r) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    # the whole burst coalesced into fewer device calls than requests
    assert mb.stats["flushes"] < len(reqs)
    assert mb.stats["requests"] == len(reqs)
    # and each request's rows are the JAX engine's, at the tower tolerance
    jeng = JEngine(m, JConfig(use_pallas=False, batch_buckets=(32,)),
                   params=params)
    for g, r in zip(got, reqs):
        np.testing.assert_allclose(g, jeng.predict(r)["output"], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("buckets,sizes", [
    ((32, 64), (10, 12, 9, 14, 11)),    # alone: 32 rows; coalesced: 64
    ((1, 64), (1,) * 8),                # alone: 1 row; coalesced: 64
])
def test_microbatch_bitexact_across_buckets(buckets, sizes):
    m, _, eng = _engine("mb_xb", buckets=buckets,
                        shape=(40, 2, 2, 2, 0, 4, [8], [16, 1]))
    top = eng.device_params["tower"]["top"][0]["w"]
    assert top.shape[0] >= 300          # the first product's K
    reqs = [make_random_batch(m, n, seed=300 + i)
            for i, n in enumerate(sizes)]
    want = [np.asarray(eng.predict(r)["output"]) for r in reqs]
    with MicroBatcher(eng, max_delay_ms=200.0) as mb:
        futs = [mb.submit(r) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert mb.stats["flushes"] < len(reqs)
    # both buckets were served: alone at the small one, coalesced at 64
    served = {sig[0] for sig, _ in eng._programs}
    assert served == set(buckets), served


def test_microbatch_flushes_on_max_batch():
    m, _, eng = _engine("mb_split", buckets=(8, 32))
    reqs = [make_random_batch(m, 5, seed=200 + i) for i in range(5)]
    want = [np.asarray(eng.predict(r)["output"]) for r in reqs]
    with MicroBatcher(eng, max_batch=8, max_delay_ms=50.0) as mb:
        futs = [mb.submit(r) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # 5 x 5 rows with an 8-row threshold: greedy whole-request groups of
    # one or two requests each -> at least 3 flushes
    assert mb.stats["flushes"] >= 3


def test_microbatch_field_mismatch_fails_group():
    m, _, eng = _engine("mb_err")
    good = make_random_batch(m, 4, seed=300)
    bad = dict(make_random_batch(m, 4, seed=301))
    bad.pop(sorted(bad)[0])
    with MicroBatcher(eng, max_delay_ms=20.0) as mb:
        f1 = mb.submit(good)
        f2 = mb.submit(bad)
        # the bad request must fail loudly: ValueError when it coalesced
        # with the good one (field-set check), KeyError if timing served
        # it alone (prepare missing the field) -- never silent zeros
        with pytest.raises((ValueError, KeyError)):
            f2.result(timeout=120)
        try:
            f1.result(timeout=120)   # good request: served or group error
        except ValueError:
            pass


def test_microbatch_close_flushes_pending():
    m, _, eng = _engine("mb_close")
    r = make_random_batch(m, 3, seed=400)
    want = np.asarray(eng.predict(r)["output"])
    mb = MicroBatcher(eng, max_delay_ms=60_000.0)  # would wait a minute
    fut = mb.submit(r)
    mb.close()                                     # close must flush
    np.testing.assert_array_equal(fut.result(timeout=5), want)


def test_merge_requests_rejects_field_mismatch():
    with pytest.raises(ValueError):
        merge_requests([{"a": np.zeros(2)}, {"b": np.zeros(2)}])


@pytest.mark.cuda
def test_microbatch_bitexact_across_buckets_on_card():
    """On the card cuBLAS picks its kernel by the row count: the row tiles
    keep coalesced rows == the request alone across buckets 1, 32, 128 and
    2048."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape = (40, 2, 2, 2, 0, 4, [8], [1024, 64, 1])
    jm = j_make_dlrm(*shape, name="mb_card")
    eng = Engine(t_make(shape, "mb_card"),
                 EngineConfig(batch_buckets=(1, 32, 128, 2048)),
                 params=init_model_params(jm), device="cuda")
    reqs = [make_random_batch(jm, n, seed=600 + i)
            for i, n in enumerate((1, 20, 100, 7, 1, 64, 3))]
    want = [np.asarray(eng.predict(r)["output"]) for r in reqs]
    with MicroBatcher(eng, max_delay_ms=200.0) as mb:
        futs = [mb.submit(r) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    big = make_random_batch(jm, 2048, seed=9)
    full = eng.predict(big)["output"]
    for n in (1, 32, 100, 1500):
        sub = {k: v[:n] for k, v in big.items()}
        np.testing.assert_array_equal(eng.predict(sub)["output"], full[:n])
