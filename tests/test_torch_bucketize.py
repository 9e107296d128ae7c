"""The port's device-bucketize path against the JAX package: kernel K2's
plain version (fused bucketize + one-id lookup) against the JAX K2 run in
interpret mode, ``bucket_bounds``, the Engine under ``host_bucketize=False``
and ``wire_pack=False`` against the JAX Engine and the oracle, and the
eager Engine's ``warmup``/``benchmark``/``stats["compiles"]``.  Lookups are
held bit for bit; tower outputs at rtol 1e-4 / atol 1e-5 (the towers sum
in different orders), except where the tower is the identity."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.models.synthetic import make_microbenchmark_model as j_micro
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.ops.lookup_pallas import bucket_bounds as j_bucket_bounds
from recom_tpu.ops.lookup_pallas import onehot_bucketize_lookup as j_k2
from recom_tpu.oracle import OracleModel
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig
from recom_tpu_torch.models import make_dlrm_model as t_make_dlrm
from recom_tpu_torch.models.synthetic import make_microbenchmark_model as t_micro
from recom_tpu_torch.native.ops import ceil32
from recom_tpu_torch.ops import kernels
from recom_tpu_torch.ops import lookup_onehot as tk
from recom_tpu_torch.runtime import executor

torch.set_num_threads(1)

MINI_E = (6, 2, 2, 2, 1, 4, [8], [16])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _k2_case(seed, c, v_pad, d, b):
    """Boundary matrix, raw plane and table3 of a pure-bucketize group,
    with every value K2 can get wrong injected into the raw plane."""
    rng = np.random.default_rng(seed)
    kmax = v_pad - 1 - int(rng.integers(0, 20))
    bmat = np.full((c, kmax), np.inf, np.float32)
    cnts = np.zeros(c, np.int32)
    for i in range(c):
        k = int(rng.integers(1, kmax + 1))
        steps = rng.uniform(0.25, 3.0, k)
        cnts[i] = k
        bmat[i, :k] = (np.cumsum(steps) - steps.sum() / 2).astype(np.float32)
    # column 0: the microbenchmark's boundaries, 0, 5, 10, ...
    bmat[0, : cnts[0]] = np.arange(cnts[0], dtype=np.float32) * 5
    # column 1: two f64 boundaries within one f32 ulp, merged by ceil32
    b64 = np.asarray([-1.0, 1.5 + 1e-12, 1.5 + 2e-12, 4.0])
    merged = ceil32(b64)
    assert merged[1] == merged[2] and merged[1] > np.float32(1.5)
    bmat[1] = np.inf
    bmat[1, :4], cnts[1] = merged, 4
    c_pad = ((c + 7) // 8) * 8
    table3 = np.zeros((c_pad, v_pad, d), np.float32)
    table3[:c] = rng.standard_normal((c, v_pad, d)).astype(np.float32)

    raw = rng.uniform(-60, 60, (c, b)).astype(np.float32)
    raw[:, 0] = np.nan
    raw[:, 1] = np.inf
    raw[:, 2] = -np.inf
    raw[:, 3] = np.float32(-0.0)
    raw[:, 4] = np.float32(0.0)
    for i in range(c):
        k = cnts[i]
        hits = bmat[i, rng.integers(0, k, 6)]
        raw[i, 5:11] = hits                                 # exact hits
        raw[i, 11:17] = np.nextafter(hits, np.float32(-np.inf))
        raw[i, 17] = bmat[i, k - 1]                         # last boundary
        raw[i, 18] = bmat[i, 0]                             # first boundary
    raw[1, 19:22] = [merged[1], np.float32(1.5), merged[3]]
    return bmat, cnts, table3, raw


def _np_bucket(bmat, cnts, raw):
    """Reference ids: numpy's upper bound over each column's boundaries,
    NaN and +inf -> count."""
    ids = np.empty(raw.shape, np.int64)
    for i, k in enumerate(cnts):
        ids[i] = np.searchsorted(bmat[i, :k], raw[i], side="right")
        ids[i][~(raw[i] < np.inf)] = k
    return ids


def _torch_bounds(bmat, cnts, v_pad, c_pad, device="cpu"):
    return [torch.from_numpy(a).to(device)
            for a in tk.bucket_bounds(bmat, cnts, v_pad, c_pad)]


@pytest.mark.parametrize("v_pad,c,d,b", [(128, 13, 8, 64), (256, 9, 8, 40),
                                         (256, 8, 4, 33)])
def test_bucket_bounds_matches_jax(v_pad, c, d, b):
    bmat, cnts, table3, _ = _k2_case(v_pad + c, c, v_pad, d, b)
    for got, want in zip(tk.bucket_bounds(bmat, cnts, v_pad, table3.shape[0]),
                         j_bucket_bounds(bmat, cnts, v_pad, table3.shape[0])):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("v_pad,c,d,b", [(128, 13, 8, 64), (256, 9, 8, 40),
                                         (256, 8, 4, 33)])
def test_k2_plain_matches_pallas_interpret_bitwise(v_pad, c, d, b):
    bmat, cnts, table3, raw = _k2_case(v_pad + c, c, v_pad, d, b)
    c_pad = table3.shape[0]
    lo, hi, counts = j_bucket_bounds(bmat, cnts, v_pad, c_pad)
    raw_pad = np.zeros((c_pad, b), np.float32)
    raw_pad[:c] = raw
    want = np.asarray(j_k2(
        jnp.asarray(table3), jnp.asarray(raw_pad), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(counts), interpret=True,
    ))[:c].transpose(1, 0, 2)
    got = tk.onehot_bucketize_lookup(
        torch.from_numpy(table3), torch.from_numpy(raw),
        *_torch_bounds(bmat, cnts, v_pad, c_pad),
    ).numpy()
    assert got.shape == (b, c, d) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ids = _np_bucket(bmat, cnts, raw)
    ref = table3[np.arange(c)[:, None], ids].transpose(1, 0, 2)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    # the traps: NaN/+inf -> count, -inf -> 0, -0.0 == 0 -> above a
    # boundary at 0, a merged pair -> the bucket after both
    assert (ids[:, 0] == cnts).all() and (ids[:, 1] == cnts).all()
    assert (ids[:, 2] == 0).all()
    assert ids[0, 3] == ids[0, 4] == 1
    assert ids[1, 19] == 3 and ids[1, 20] == 1


@pytest.mark.parametrize("d", [1, 3, 32])
@pytest.mark.parametrize("v_pad", [128, 256])
def test_k2_plain_matches_pallas_on_edges(v_pad, d):
    """Ragged tiles (C = 45, Bp = 100); a column with no boundary, one with
    v_pad - 1 of them, one value repeated, only -inf, a merged pair."""
    c, b = 45, 100
    bmat, cnts, table3, raw = chip_smoke.k2_edge_case(c, v_pad, d, b,
                                                      seed=v_pad + d)
    c_pad = table3.shape[0]
    lo, hi, counts = j_bucket_bounds(bmat, cnts, v_pad, c_pad)
    raw_pad = np.zeros((c_pad, b), np.float32)
    raw_pad[:c] = raw
    want = np.asarray(j_k2(
        jnp.asarray(table3), jnp.asarray(raw_pad), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(counts), interpret=True,
    ))[:c].transpose(1, 0, 2)
    got = tk.onehot_bucketize_lookup(
        torch.from_numpy(table3), torch.from_numpy(raw),
        *_torch_bounds(bmat, cnts, v_pad, c_pad),
    ).numpy()
    assert got.shape == (b, c, d)
    # XLA on the CPU compares subnormals as zero (the float below a
    # boundary at 0 lands above it there); the port, numpy and the oracle
    # compare them as they are, so those entries are held to numpy alone
    sub = ((raw != 0) & (np.abs(raw) < np.finfo(np.float32).tiny)).T
    assert sub.any()
    np.testing.assert_array_equal(got[~sub].view(np.int32),
                                  want[~sub].view(np.int32))
    ids = _np_bucket(bmat, cnts, raw)
    ref = table3[np.arange(c)[:, None], ids].transpose(1, 0, 2)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert (ids[0] == 0).all()                       # no boundary
    assert ids[1, 0] == v_pad - 1 and ids[1, 2] == 0
    assert ids[2, 3] == 0 and (ids[2][raw[2] == 2.5] == 9).all()
    assert (ids[3] == 4).all()                       # -inf only
    assert list(ids[4, 37:40]) == [3, 1, 4]          # merged pair


def _branchless_bucket(hi, counts, raw):
    """csrc/onehot_bucketize.cu's search in numpy: a fixed number of steps
    over each column's whole hi row, entries past V counting as +inf; NaN
    and +inf take the count."""
    v = hi.shape[1]
    p2 = 1
    while p2 < v:
        p2 *= 2
    pos = np.zeros(raw.shape, np.int64)
    s = p2 // 2
    while s:
        j = pos + s - 1
        h = np.take_along_axis(hi[: raw.shape[0]], np.minimum(j, v - 1), 1)
        pos += np.where((j < v) & (h <= raw), s, 0)
        s //= 2
    return np.where(raw < np.inf, pos, counts[: raw.shape[0], :1])


@pytest.mark.parametrize("v_pad", [1, 2, 128, 200, 256, 384])
def test_k2_branchless_search_is_the_upper_bound(v_pad):
    if v_pad >= 128:
        bmat, cnts, _, raw = chip_smoke.k2_edge_case(45, v_pad, 1, 100,
                                                     seed=v_pad)
    else:                              # at most v_pad - 1 boundaries
        bmat = np.full((3, v_pad - 1), 0.5, np.float32)
        cnts = np.asarray([0, v_pad - 1, 0], np.int32)
        raw = np.asarray([[np.nan, np.inf, -np.inf, -0.0, 0.5, 7.0]] * 3,
                         np.float32)
    _, hi, counts = tk.bucket_bounds(bmat, cnts, v_pad, bmat.shape[0])
    np.testing.assert_array_equal(_branchless_bucket(hi, counts, raw),
                                  _np_bucket(bmat, cnts, raw))


def test_k2_wrapper_rejects_bad_inputs():
    bmat, cnts, table3, raw = _k2_case(0, 5, 128, 8, 32)
    t3, x = torch.from_numpy(table3), torch.from_numpy(raw)
    lo, hi, counts = _torch_bounds(bmat, cnts, 128, 8)
    with pytest.raises(ValueError, match="raw must be f32"):
        tk.onehot_bucketize_lookup(t3, x.double(), lo, hi, counts)
    with pytest.raises(ValueError, match="counts must be int32"):
        tk.onehot_bucketize_lookup(t3, x, lo, hi, counts[:, 0])
    with pytest.raises(ValueError, match="hi must be f32"):
        tk.onehot_bucketize_lookup(t3, x, lo, hi[:, :64].contiguous(),
                                   counts)
    with pytest.raises(ValueError, match="raw columns"):
        tk.onehot_bucketize_lookup(t3, torch.zeros((9, 32)), lo, hi, counts)
    with pytest.raises(ValueError, match="contiguous"):
        tk.onehot_bucketize_lookup(t3, torch.zeros((32, 5)).T, lo, hi,
                                   counts)


def _spy_k2(monkeypatch):
    """Record each K2 call the Engine makes (its raw plane's shape)."""
    calls = []
    real = executor.onehot_bucketize_lookup

    def spy(table3, raw, lo, hi, counts):
        calls.append(tuple(raw.shape))
        return real(table3, raw, lo, hi, counts)

    monkeypatch.setattr(executor, "onehot_bucketize_lookup", spy)
    return calls


MICRO_CASES = {          # config, whether both groups take K2
    "device_bucketize": ({"host_bucketize": False}, True),
    "structured": ({"wire_pack": False}, True),
    "default": ({}, False),
}


@pytest.mark.parametrize("name", list(MICRO_CASES))
def test_microbenchmark_model_matches_jax_engine_and_oracle(name, monkeypatch):
    kw, fused = MICRO_CASES[name]
    jm = j_micro(40, random_boundary=True)
    tm = t_micro(40, random_boundary=True)
    params = init_model_params(jm)
    batch = make_random_batch(jm, 70, seed=6)
    for f in list(batch)[:3]:
        batch[f][:4] = [np.nan, np.inf, -np.inf, -0.0]
    calls = _spy_k2(monkeypatch)
    eng = Engine(tm, EngineConfig(**kw), params=params, device="cpu")
    assert sorted({g.pallas_vocab for g in eng.compiled.groups}) == [128, 256]
    out = eng.predict(batch, return_pooled=True, return_concat=True)
    want = [(g.num_columns, 128) for g in eng.compiled.groups]
    assert sorted(calls) == (sorted(want) if fused else [])
    jout = JEngine(jm, JConfig(interpret=True, **kw), params=params).predict(
        batch, return_pooled=True, return_concat=True)
    ref = OracleModel(jm, params).forward(batch)
    assert len(ref["pooled"]) == 40
    for col, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], r, err_msg=col)
        np.testing.assert_array_equal(out["pooled"][col], jout["pooled"][col],
                                      err_msg=col)
    # identity tower: the output is the concat of the pooled columns
    assert out["output"].shape == (70, 320)
    np.testing.assert_array_equal(out["output"], ref["output"])
    np.testing.assert_array_equal(out["output"], jout["output"])
    np.testing.assert_array_equal(out["concat"], jout["concat"])


@pytest.mark.parametrize("wire_pack", [True, False])
def test_mini_model_e_device_bucketize_matches_jax_and_oracle(wire_pack,
                                                              monkeypatch):
    """Model E's bucketize columns share their one-hot group with int-hash
    columns: device bucketize then K1, never K2."""
    kw = {"host_bucketize": False, "wire_pack": wire_pack}
    jm = j_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    params = init_model_params(jm)
    batch = make_random_batch(jm, 45, seed=8)
    calls = _spy_k2(monkeypatch)
    eng = Engine(tm, EngineConfig(**kw), params=params, device="cpu")
    out = eng.predict(batch, return_pooled=True)
    assert calls == []
    jout = JEngine(jm, JConfig(**kw), params=params).predict(
        batch, return_pooled=True)
    ref = OracleModel(jm, params).forward(batch)
    for col, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], r, err_msg=col)
        np.testing.assert_array_equal(out["pooled"][col], jout["pooled"][col],
                                      err_msg=col)
    np.testing.assert_allclose(out["output"], ref["output"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out["output"], jout["output"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [{"use_pallas": False},
                                {"host_bucketize": False}])
def test_batch_bucketing_bounds_compiles(kw):
    """tests/test_engine.py::test_batch_bucketing_bounds_compiles on the
    port: a signature ("program") per batch bucket, not per batch size."""
    jm, tm = j_micro(3), t_micro(3)
    params = init_model_params(jm)
    eng = Engine(tm, EngineConfig(**kw), params=params, device="cpu")
    for bs in (10, 20, 30):
        eng.predict(make_random_batch(jm, bs, seed=bs))
    assert eng.stats["compiles"] == 1
    eng.predict(make_random_batch(jm, 33, seed=0))
    assert eng.stats["compiles"] == 2
    b = make_random_batch(jm, 17, seed=9)
    out = eng.predict(b, return_concat=True)
    ref = OracleModel(jm, params).forward(b)
    assert out["concat"].shape[0] == 17
    np.testing.assert_array_equal(out["concat"], ref["concat"])
    assert eng.stats_report()["programs_compiled"] == eng.stats["compiles"]


@pytest.mark.parametrize("wire_pack", [True, False])
def test_warmup_benchmark_and_stats_report(wire_pack):
    tm = t_micro(5, random_boundary=True)
    cfg = EngineConfig(host_bucketize=False, wire_pack=wire_pack,
                       batch_buckets=(16, 64))
    eng = Engine(tm, cfg, device="cpu")
    assert eng.warmup() == 2                 # every batch bucket
    assert eng.warmup(batch_sizes=(9, 16)) == 0
    jm = j_micro(5, random_boundary=True)
    batches = [make_random_batch(jm, 40, seed=s) for s in range(3)]
    new = eng.warmup(batches=batches)        # live signatures
    assert new == (1 if wire_pack else 0)    # wire: + the device-hash sig
    calls = eng.stats["calls"]
    eng.predict(batches[0])
    assert eng.stats["compiles"] == 2 + new  # nothing new once warmed
    res = eng.benchmark(batches, iters=4, warmup=1)
    assert set(res) == {"latency_ms", "examples_per_s"}
    assert res["latency_ms"] > 0
    assert res["examples_per_s"] == pytest.approx(40e3 / res["latency_ms"])
    assert eng.stats["compiles"] == 2 + new
    rep = eng.stats_report()
    assert rep["counters"]["calls"] == calls + 1
    assert rep["programs_compiled"] == eng.stats["compiles"]
    assert [g["backend"] for g in rep["groups"]] == (
        ["onehot_bucketize (K2)"] * len(eng.compiled.groups))
    assert "host_prep" in rep["stage_latency"]


@pytest.mark.cuda
@pytest.mark.parametrize("v_pad,c,d,b", [(128, 750, 8, 2048),
                                         (256, 250, 8, 2048),
                                         (256, 13, 4, 37), (128, 40, 3, 70)])
def test_k2_kernel_matches_plain_on_card(cuda, v_pad, c, d, b):
    bmat, cnts, table3, raw = _k2_case(v_pad + c, c, v_pad, d, b)
    t3 = torch.from_numpy(table3).to(cuda)
    x = torch.from_numpy(raw).to(cuda)
    bounds = _torch_bounds(bmat, cnts, v_pad, table3.shape[0], cuda)
    before = kernels.launches["K2"]
    got = tk.onehot_bucketize_lookup(t3, x, *bounds)
    assert kernels.launches["K2"] == before + 1
    want = tk.onehot_bucketize_lookup_plain(t3, x, *bounds)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 8, 32])
@pytest.mark.parametrize("v_pad", [128, 256, 384])
def test_k2_kernel_edges_match_plain_on_card(cuda, v_pad, d):
    bmat, cnts, table3, raw = chip_smoke.k2_edge_case(45, v_pad, d, 100,
                                                      seed=v_pad + d)
    t3 = torch.from_numpy(table3).to(cuda)
    x = torch.from_numpy(raw).to(cuda)
    bounds = _torch_bounds(bmat, cnts, v_pad, table3.shape[0], cuda)
    got = tk.onehot_bucketize_lookup(t3, x, *bounds)
    want = tk.onehot_bucketize_lookup_plain(t3, x, *bounds)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_microbenchmark_on_card_launches_k2_only(cuda):
    jm = j_micro(40, random_boundary=True)
    tm = t_micro(40, random_boundary=True)
    params = init_model_params(jm)
    batch = make_random_batch(jm, 70, seed=6)
    eng = Engine(tm, EngineConfig(host_bucketize=False), params=params,
                 device="cuda")
    kernels.reset_launches()
    out = eng.predict(batch, return_pooled=True)
    assert kernels.launches == {**{k: 0 for k in kernels.launches}, "K2": 2}
    ref = OracleModel(jm, params).forward(batch)
    for col, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], r, err_msg=col)
    np.testing.assert_array_equal(out["output"], ref["output"])
