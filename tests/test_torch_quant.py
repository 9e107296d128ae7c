"""The port's table storage (ops/quant.py; bf16 and int8 tables in the
Engine) against the JAX package: ``quantize_rows_int8`` and the stored bf16
bits equal the JAX engine's; the bf16 reads of K1 and K2 and the bf16 and
int8 reads of X1 (their plain versions, on the CPU) equal the JAX kernels
and ``lookup_xla.group_pooled`` on the same stored tables; and Engines with
``table_dtype="bfloat16"`` and ``"int8"`` serve pooled outputs ``==`` the
oracle on their own export (the dequantized tables, as tests/test_quant.py
holds the JAX engine) and ``==`` the JAX Engine with the same dtype and
params, tower outputs within rtol 1e-4 / atol 1e-5 (the towers sum in
different orders).  The CUDA variants (K1-bf16, K2-bf16, X1-bf16, X1-int8)
are held against their plain versions on a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.models.synthetic import make_microbenchmark_model as j_micro
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.ops import lookup_xla
from recom_tpu.ops.lookup_pallas import _onehot_lookup_impl
from recom_tpu.ops.lookup_pallas import bucket_bounds as j_bucket_bounds
from recom_tpu.ops.lookup_pallas import onehot_bucketize_lookup as j_k2
from recom_tpu.ops.quant import QuantizedTable as JQuantizedTable
from recom_tpu.ops.quant import quantize_rows_int8 as j_quantize
from recom_tpu.oracle import OracleModel
from recom_tpu.runtime.checkpoint import load_checkpoint as j_load
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig, Trainer
from recom_tpu_torch.models import make_dlrm_model as t_make_dlrm
from recom_tpu_torch.models.synthetic import make_microbenchmark_model as t_micro
from recom_tpu_torch.ops import kernels
from recom_tpu_torch.ops import lookup_gather as tg
from recom_tpu_torch.ops import lookup_onehot as tk
from recom_tpu_torch.ops.quant import (
    QuantizedTable,
    dequantize_rows,
    dequantize_table,
    quantize_rows_chunked,
    quantize_rows_int8,
)
from recom_tpu_torch.oracle import OracleModel as TOracle
from recom_tpu_torch.runtime.checkpoint import export_params, save_checkpoint

torch.set_num_threads(1)

MINI_E = (6, 2, 2, 2, 1, 4, [8], [16])
DTYPES = ("bfloat16", "int8")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _wide_rows(rng, r, d):
    """Rows whose magnitudes span 12 orders (exp(+-14)), an all-zero row,
    and a row of one value (every element quantizes to +-127)."""
    t = rng.standard_normal((r, d)).astype(np.float32) * np.exp(
        rng.uniform(-14, 14, (r, 1))).astype(np.float32)
    t[1] = 0.0
    t[2] = -3.5
    return t


def _ties(rng, shape):
    """f32 values at and beside bf16's rounding point: low 16 bits 0x8000
    (ties, to even both ways), 0x7FFF and 0x8001, over random finite upper
    halves."""
    hi = rng.integers(0x0080, 0x7F00, shape).astype(np.uint32)
    hi |= (rng.random(shape) < 0.5).astype(np.uint32) << 15      # sign
    lo = rng.choice(np.asarray([0x8000, 0x7FFF, 0x8001], np.uint32), shape)
    return ((hi << 16) | lo).view(np.float32)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().view(torch.int16).numpy().view(np.uint16)


# ---------------------------------------------------------------------------
# ops/quant.py
# ---------------------------------------------------------------------------


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    t = rng.standard_normal((64, 16)).astype(np.float32) * np.exp(
        rng.uniform(-6, 6, size=(64, 1))).astype(np.float32)
    q, s = quantize_rows_int8(t)
    deq = dequantize_table(q, s)
    amax = np.abs(t).max(axis=1, keepdims=True)
    assert (np.abs(deq - t) <= amax / 127.0 * 0.5 + 1e-12).all()
    q0, s0 = quantize_rows_int8(np.zeros((3, 4), np.float32))
    assert (q0 == 0).all() and (s0 == 0).all()
    # a zero row dequantizes to +0.0, in numpy and in torch
    assert not np.signbit(dequantize_table(q0, s0)).any()
    got = dequantize_rows(torch.from_numpy(q0), torch.from_numpy(s0))
    assert not torch.signbit(got).any()


@pytest.mark.parametrize("d", [1, 3, 8, 12])
def test_quantize_rows_int8_matches_jax(d):
    rng = np.random.default_rng(d)
    t = _wide_rows(rng, 300, d)
    q, s = quantize_rows_int8(t)
    jq, js_ = j_quantize(t)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.int32), js_.view(np.int32))
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert (np.abs(q[2]) == 127).all() and s[1] == 0
    # the Engine quantizes a block of rows at a time: the same bits
    cq, cs = quantize_rows_chunked(t, rows=7)
    np.testing.assert_array_equal(cq, q)
    np.testing.assert_array_equal(cs.view(np.int32), s.view(np.int32))
    # dequantize_rows is dequantize_table on gathered rows, bit for bit
    idx = rng.integers(0, 300, (5, 9))
    got = dequantize_rows(torch.from_numpy(q)[idx], torch.from_numpy(s)[idx])
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  dequantize_table(q, s)[idx].view(np.int32))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_bf16_stored_bits_match_jax_engine(use_pallas):
    """Every group's stored table: the same 16-bit patterns as the JAX
    engine's (round to nearest even), on finite values that include ties
    at the rounding point."""
    jm = j_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    params = init_model_params(jm)
    rng = np.random.default_rng(4)
    for name, tbl in params["tables"].items():
        params["tables"][name] = _ties(rng, tbl.shape)
    kw = dict(table_dtype="bfloat16", use_pallas=use_pallas)
    jeng = JEngine(jm, JConfig(**kw), params=params)
    eng = Engine(tm, EngineConfig(**kw), params=params, device="cpu")
    assert any(g.pallas_vocab is not None
               for g in eng.compiled.groups) == use_pallas
    for g in eng.compiled.groups:
        ours = eng.device_params["stacked"][str(g.gid)]
        theirs = np.asarray(jeng.device_params["stacked"][str(g.gid)])
        assert ours.dtype == torch.bfloat16 and ours.shape == theirs.shape
        np.testing.assert_array_equal(_bf16_bits(ours),
                                      theirs.view(np.uint16))


# ---------------------------------------------------------------------------
# the kernels' stored-dtype reads, plain versions against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 3, 8, 64])
def test_k1_bf16_plain_matches_pallas_interpret(d):
    rng = np.random.default_rng(d)
    c, v, b = 13, 200, 40
    t3 = np.zeros((16, 256, d), np.float32)
    t3[:c, :v] = rng.standard_normal((c, v, d)).astype(np.float32)
    ids = rng.integers(0, v, (c, b)).astype(np.int32)
    ids[rng.random((c, b)) < 0.2] = -1
    ids_t = np.full((16, b), -1, np.int32)
    ids_t[:c] = ids
    j3 = jnp.asarray(t3, dtype=jnp.bfloat16)
    want = np.asarray(_onehot_lookup_impl(j3, jnp.asarray(ids_t),
                                          interpret=True))[:c]
    t3b = torch.from_numpy(t3).to(torch.bfloat16)
    np.testing.assert_array_equal(_bf16_bits(t3b),
                                  np.asarray(j3).view(np.uint16))
    got = tk.onehot_lookup(t3b, torch.from_numpy(ids),
                           torch.full((c,), v - 1, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == (b, c, d)
    np.testing.assert_array_equal(got.numpy(), want.transpose(1, 0, 2))


@pytest.mark.parametrize("d", [3, 8])
def test_k2_bf16_plain_matches_pallas_interpret(d):
    rng = np.random.default_rng(10 + d)
    c, v_pad, b = 11, 128, 50
    kmax = 60
    bmat = np.full((c, kmax), np.inf, np.float32)
    cnts = rng.integers(1, kmax + 1, c).astype(np.int32)
    for i in range(c):
        bmat[i, : cnts[i]] = np.sort(rng.uniform(-5, 5, cnts[i]))
    raw = rng.uniform(-6, 6, (c, b)).astype(np.float32)
    raw[:, :3] = [np.nan, np.inf, -np.inf]
    c_pad = 16
    t3 = np.zeros((c_pad, v_pad, d), np.float32)
    t3[:c] = rng.standard_normal((c, v_pad, d)).astype(np.float32)
    lo, hi, counts = j_bucket_bounds(bmat, cnts, v_pad, c_pad)
    raw_pad = np.zeros((c_pad, b), np.float32)
    raw_pad[:c] = raw
    want = np.asarray(j_k2(
        jnp.asarray(t3, dtype=jnp.bfloat16), jnp.asarray(raw_pad),
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(counts),
        interpret=True))[:c]
    tb = [torch.from_numpy(x) for x in tk.bucket_bounds(bmat, cnts, v_pad,
                                                        c_pad)]
    got = tk.onehot_bucketize_lookup(torch.from_numpy(t3).to(torch.bfloat16),
                                     torch.from_numpy(raw), *tb)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.transpose(1, 0, 2))


def _x1_stored_case(seed, d, l, dtype, weighted):
    """One gather group in both packages' stored form: (torch table, jax
    table, ids [C, Bp, L], offsets, vocab, codes, weights or None,
    per-column rounding)."""
    rng = np.random.default_rng(seed)
    c, b = 5, 37
    vocab = rng.integers(5, 40, c)
    offs = np.concatenate([[0], np.cumsum(vocab)[:-1]]).astype(np.int32)
    table = _wide_rows(rng, int(vocab.sum()), d)
    ids = np.stack([rng.integers(0, vocab[i], (b, l)) for i in range(c)]
                   ).astype(np.int32)                       # [C, B, L]
    ids[rng.random(ids.shape) < 0.3] = -1
    ids[:, 0] = -1
    codes = np.asarray([0, 1, 2, 1, 2], np.int32)
    w = (rng.uniform(0.1, 2.0, ids.shape).astype(np.float32)
         if weighted else None)
    wcols = np.asarray([True, False, True, True, False]) & weighted
    if dtype == "int8":
        q, s = quantize_rows_int8(table)
        tt = QuantizedTable(torch.from_numpy(q), torch.from_numpy(s))
        jt = JQuantizedTable(jnp.asarray(q), jnp.asarray(s))
    else:
        tt = torch.from_numpy(table).to(torch.bfloat16)
        jt = jnp.asarray(table, dtype=jnp.bfloat16)
    return tt, jt, ids, offs, vocab, codes, w, wcols


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,l", [(1, 1), (3, 2), (12, 33), (8, 1), (32, 5)])
@pytest.mark.parametrize("weighted", [False, True])
def test_x1_stored_plain_matches_lookup_xla(dtype, d, l, weighted):
    tt, jt, ids, offs, vocab, codes, w, wcols = _x1_stored_case(
        d * 100 + l, d, l, dtype, weighted)
    want = np.asarray(lookup_xla.group_pooled(
        jt, jnp.asarray(ids.transpose(1, 0, 2)), offs, codes,
        None if w is None else jnp.asarray(w.transpose(1, 0, 2)),
        exact_math=True, weighted_cols=wcols))
    got = tg.group_pooled(tt, torch.from_numpy(ids), offs, codes,
                          None if w is None else torch.from_numpy(w), wcols,
                          (vocab - 1).astype(np.int32))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_x1_vector_loads_follow_the_stored_itemsize():
    """A bag lane loads up to 16 stored bytes at once: U = 4 f32 elements,
    8 bf16 or 16 int8 (8 at int8 d = 8, the whole row), where U divides d
    and the table is aligned to U stored elements, else the next smaller
    unit down to 4, else single elements.  The one-id tile (L = 1, no
    weights: bf16 and int8 groups) loads K1's units, 4 or 1."""
    ids2 = torch.zeros((1, 4, 2), dtype=torch.int32)
    ids1 = torch.zeros((1, 4, 1), dtype=torch.int32)
    dtypes = (torch.float32, torch.bfloat16, torch.int8)
    # (elements past a 16-byte boundary, d, the bag unit of f32 / bf16 /
    # int8, the one-id unit of bf16 / int8)
    cases = ((0, 8, (4, 8, 8), (4, 4)), (4, 8, (4, 4, 4), (4, 4)),
             (2, 8, (1, 1, 1), (1, 1)), (0, 3, (1, 1, 1), (1, 1)),
             (4, 12, (4, 4, 4), (4, 4)), (0, 32, (4, 8, 16), (4, 4)),
             (8, 32, (4, 8, 8), (4, 4)), (8, 16, (4, 8, 8), (4, 4)),
             (0, 64, (4, 8, 16), (4, 4)))
    for k, dtype in enumerate(dtypes):
        flat = torch.zeros(4096, dtype=dtype)
        item = flat.element_size()
        start = (-flat.data_ptr() % 16) // item       # a 16-byte boundary
        for shift, d, bag, oneid in cases:
            rows = flat[start + shift: start + shift + 32 * d].view(32, d)
            scale = torch.ones(32)
            table = (QuantizedTable(rows, scale) if dtype == torch.int8
                     else rows)
            fields, _, _ = tg._x1_group(table, ids2, np.zeros(1, np.int32),
                                        np.zeros(1, np.int32))
            assert (fields["unit"], fields["oneid"]) == (bag[k], False), (
                dtype, shift, d)
            fields1, _, _ = tg._x1_group(table, ids1, np.zeros(1, np.int32),
                                         np.zeros(1, np.int32))
            if dtype == torch.float32 and d >= tg.X1_ONEID_F32_BELOW_D:
                assert (fields1["unit"], fields1["oneid"]) == (bag[k], False)
            else:
                assert fields1["oneid"] and fields1["unit"] == (
                    (bag[0],) + oneid)[k], (dtype, shift, d)
            assert fields["table"] == rows.data_ptr()
            assert fields["scales"] == (scale.data_ptr()
                                        if dtype == torch.int8 else 0)
            tg.x1_descriptors([fields, fields1])      # accepted as made


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_x1_one_id_groups_take_the_one_id_tile(dtype):
    """An unweighted L = 1 group of bf16 or int8 rows (of f32 rows too
    below X1_ONEID_F32_BELOW_D) gets the one-id kind bit and K1's 32 x 32
    tiles: ceil(C / 32) x ceil(Bp / 32) blocks; a weighted L = 1 group,
    and any L > 1 group, keeps the bag tile."""
    c, bp, d = 45, 100, 8
    t = torch.zeros((64, d), dtype=getattr(torch, dtype))
    table = QuantizedTable(t, torch.ones(64)) if dtype == "int8" else t
    ids = torch.zeros((c, bp, 1), dtype=torch.int32)
    offs, codes = np.zeros(c, np.int32), np.zeros(c, np.int32)
    fields, out, _ = tg._x1_group(table, ids, offs, codes)
    one = dtype != "float32" or d < tg.X1_ONEID_F32_BELOW_D
    assert fields["oneid"] == one and out.shape == (bp, c, d)
    packed, blocks = tg.x1_descriptors([fields])
    (rec,) = [dict(zip(tg.X1_FIELDS, r))
              for r in tg.X1_DESC.iter_unpack(packed)]
    if one:
        assert rec["kind"] == 64 + 16 and rec["dq"] == 2
        assert blocks == 2 * 4 and rec["tiles_b"] == 4
    w = torch.ones((c, bp, 1))
    for args in ((ids, offs, codes, w), (torch.zeros((c, bp, 2),
                                                     dtype=torch.int32),
                                         offs, codes)):
        fields, _, _ = tg._x1_group(table, *args)
        assert not fields["oneid"]
        packed, _ = tg.x1_descriptors([fields])
        assert not tg.X1_DESC.unpack(packed)[-1] & 64


def test_wrappers_take_stored_tables_and_reject_others():
    t3 = torch.zeros((8, 128, 8))
    ids = torch.zeros((4, 16), dtype=torch.int32)
    caps = torch.zeros(4, dtype=torch.int32)
    out = tk.onehot_lookup(t3.to(torch.bfloat16), ids, caps)
    assert out.dtype == torch.float32
    with pytest.raises(ValueError, match="f32 or bf16"):
        tk.onehot_lookup(t3.to(torch.int8), ids, caps)
    with pytest.raises(ValueError, match="f32 or bf16"):
        tk.onehot_lookup(t3.half(), ids, caps)
    ids3 = torch.zeros((2, 16, 3), dtype=torch.int32)
    offs, codes = np.zeros(2, np.int32), np.zeros(2, np.int32)
    q = torch.zeros((10, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="QuantizedTable"):
        tg.group_pooled(QuantizedTable(q, torch.ones(9)), ids3, offs, codes)
    with pytest.raises(ValueError, match="QuantizedTable"):
        tg.group_pooled(QuantizedTable(q.float(), torch.ones(10)), ids3,
                        offs, codes)
    with pytest.raises(ValueError, match="f32 or bf16"):
        tg.group_pooled(q, ids3, offs, codes)
    got = tg.group_pooled(QuantizedTable(q, torch.ones(10)), ids3, offs,
                          codes)
    assert got.dtype == torch.float32 and got.shape == (16, 2, 8)


# ---------------------------------------------------------------------------
# the Engine with bf16 and int8 tables
# ---------------------------------------------------------------------------

CONFIGS = {
    "default": {},
    "no_pallas": {"use_pallas": False},
    "structured": {"wire_pack": False, "device_hash": False},
}


def _assert_serves(out, jout, ref):
    assert set(out["pooled"]) == set(ref["pooled"])
    for col, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], r, err_msg=col)
        np.testing.assert_array_equal(out["pooled"][col], jout["pooled"][col],
                                      err_msg=col)
    np.testing.assert_allclose(out["output"], ref["output"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out["output"], jout["output"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_stored_tables_match_oracle_and_jax(dtype, name):
    kw = dict(CONFIGS[name], table_dtype=dtype)
    jm = j_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    params = init_model_params(jm)
    batch = make_random_batch(jm, 70, seed=2)
    eng = Engine(tm, EngineConfig(**kw), params=params, device="cpu")
    jeng = JEngine(jm, JConfig(**kw), params=params)
    onehot = [g for g in eng.compiled.groups if g.pallas_vocab is not None]
    # int8 sends every group down the gather path, as the reference does
    assert bool(onehot) == (dtype == "bfloat16" and name != "no_pallas")
    for g in eng.compiled.groups:
        stored = eng.device_params["stacked"][str(g.gid)]
        if dtype == "int8":
            assert isinstance(stored, QuantizedTable)
            assert stored.q.dtype == torch.int8
            assert stored.scale.shape == stored.q.shape[:1]
        else:
            assert stored.dtype == torch.bfloat16
    exported = export_params(eng)
    assert all(t.dtype == np.float32 for t in exported["tables"].values())
    before = dict(kernels.launches)
    out = eng.predict(batch, return_pooled=True)
    assert kernels.launches == before        # plain versions on the CPU
    jout = jeng.predict(batch, return_pooled=True)
    ref = OracleModel(jm, exported).forward(batch)
    _assert_serves(out, jout, ref)
    assert out["output"].shape == (70, 1)
    # the port's own oracle on the same export
    tref = TOracle(tm, exported).forward(batch)
    for col, r in tref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], r, err_msg=col)


def test_bf16_pallas_groups_take_k1_plain(monkeypatch):
    """use_pallas=True with bf16: the one-hot group's bf16 table3 reaches
    K1's wrapper (its plain version on the CPU)."""
    seen = []
    real = tk.onehot_lookup_plain

    def spy(table3, ids, caps):
        seen.append(table3.dtype)
        return real(table3, ids, caps)

    monkeypatch.setattr(tk, "onehot_lookup_plain", spy)
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    eng = Engine(tm, EngineConfig(table_dtype="bfloat16"), device="cpu")
    from recom_tpu_torch.models import make_random_batch as t_batch

    eng.predict(t_batch(tm, 20, seed=1))
    assert seen == [torch.bfloat16]


@pytest.mark.parametrize("wire_pack", [True, False])
def test_microbenchmark_bf16_device_bucketize_matches_jax(wire_pack,
                                                          monkeypatch):
    """host_bucketize=False with bf16 tables: K2 (its plain version on
    the CPU) reads the bf16 table3 of both pure-bucketize groups."""
    seen = []
    real = tk.onehot_bucketize_lookup_plain

    def spy(table3, *a):
        seen.append(table3.dtype)
        return real(table3, *a)

    monkeypatch.setattr(tk, "onehot_bucketize_lookup_plain", spy)
    kw = dict(table_dtype="bfloat16", host_bucketize=False,
              wire_pack=wire_pack)
    jm = j_micro(40, random_boundary=True)
    tm = t_micro(40, random_boundary=True)
    params = init_model_params(jm)
    batch = make_random_batch(jm, 70, seed=6)
    for f in list(batch)[:3]:
        batch[f][:4] = [np.nan, np.inf, -np.inf, -0.0]
    eng = Engine(tm, EngineConfig(**kw), params=params, device="cpu")
    out = eng.predict(batch, return_pooled=True)
    assert seen == [torch.bfloat16, torch.bfloat16]
    jout = JEngine(jm, JConfig(interpret=True, **kw), params=params).predict(
        batch, return_pooled=True)
    ref = OracleModel(jm, export_params(eng)).forward(batch)
    for col, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], r, err_msg=col)
        np.testing.assert_array_equal(out["pooled"][col], jout["pooled"][col],
                                      err_msg=col)
    np.testing.assert_array_equal(out["output"], jout["output"])


def test_jax_load_checkpoint_reads_a_bf16_engine(tmp_path):
    tm = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    jm = j_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    params = init_model_params(jm)
    eng = Engine(tm, EngineConfig(table_dtype="bfloat16"), params=params,
                 device="cpu")
    save_checkpoint(str(tmp_path), eng)
    model, loaded = j_load(str(tmp_path))
    exported = export_params(eng)
    for name, t in exported["tables"].items():
        assert loaded["tables"][name].dtype == np.float32
        np.testing.assert_array_equal(loaded["tables"][name], t)
        # the stored values: the f32 params rounded to bf16
        want = torch.from_numpy(params["tables"][name]).to(
            torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(t, want)
    batch = make_random_batch(jm, 30, seed=4)
    jout = JEngine(model, JConfig(), params=loaded).predict(
        batch, return_pooled=True)
    out = eng.predict(batch, return_pooled=True)
    for col in out["pooled"]:
        np.testing.assert_array_equal(out["pooled"][col], jout["pooled"][col])


@pytest.mark.parametrize("dtype", DTYPES)
def test_trainer_rejects_quantized_tables(dtype):
    tm = t_make_dlrm(2, 1, 1, 0, 0, 2, [4], [8, 1], name="qtr")
    with pytest.raises(ValueError, match="float32"):
        Trainer(tm, EngineConfig(table_dtype=dtype), device="cpu")


# ---------------------------------------------------------------------------
# on the card: the variants against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 8, 12, 32, 64])
def test_onehot_bf16_kernels_match_plain_on_card(cuda, d):
    rng = np.random.default_rng(d)
    c, v, b = 45, 128, 100
    t3 = torch.from_numpy(_ties(rng, (48, v, d))).to(torch.bfloat16)
    bits = t3.view(torch.int16)
    bits[:, 0::7] = -32768                  # -0.0
    bits[:, 1::11] = 0x7FC1                 # NaN
    bits[:, 2::13] = 0x0001                 # the least subnormal
    t3 = t3.to(cuda)
    ids = torch.from_numpy(rng.integers(-3, v + 5, (c, b)).astype(
        np.int32)).to(cuda)
    caps = torch.full((c,), v - 2, dtype=torch.int32, device=cuda)
    before = kernels.launches["K1-bf16"]
    got = tk.onehot_lookup(t3, ids, caps)
    want = tk.onehot_lookup_plain(t3, ids, caps)
    torch.cuda.synchronize()
    assert kernels.launches["K1-bf16"] == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    bmat = np.sort(rng.uniform(-2, 2, (c, 60)).astype(np.float32), axis=1)
    bounds = [torch.from_numpy(x).to(cuda) for x in tk.bucket_bounds(
        bmat, np.full(c, 60, np.int32), v, 48)]
    raw = torch.from_numpy(rng.uniform(-3, 3, (c, b)).astype(
        np.float32)).to(cuda)
    got = tk.onehot_bucketize_lookup(t3, raw, *bounds)
    want = tk.onehot_bucketize_lookup_plain(t3, raw, *bounds)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 3, 8, 12, 32, 64])
@pytest.mark.parametrize("l", [1, 2, 33, 128])
def test_x1_stored_kernels_match_plain_on_card(cuda, dtype, d, l):
    cases = [_x1_stored_case(d * 1000 + l + w, d, l, dtype, bool(w))
             for w in (0, 1)]
    args = [(tt.to(cuda) if isinstance(tt, torch.Tensor) else
             QuantizedTable(tt.q.to(cuda), tt.scale.to(cuda)),
             torch.from_numpy(ids).to(cuda), offs, codes,
             None if w is None else torch.from_numpy(w).to(cuda), wc,
             (vocab - 1).astype(np.int32))
            for tt, _, ids, offs, vocab, codes, w, wc in cases]
    kid = tg.X1_KERNEL[torch.int8 if dtype == "int8" else torch.bfloat16]
    before = kernels.launches[kid]
    got = tg.groups_pooled(args)
    torch.cuda.synchronize()
    assert kernels.launches[kid] == before + 1
    for a, g in zip(args, got):
        want = tg.group_pooled_plain(*a)
        assert torch.equal(g, want)
