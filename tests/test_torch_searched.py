"""K1 over several groups in one launch, and a mixed one-hot group's
bucketize members searched in K1's id read (``lookup_onehot.Searched``),
against the JAX package on the CPU: the plain route of each group against
the JAX ``onehot_lookup`` (Pallas, interpret mode), the searched route
against JAX ``device_bucketize`` + LUT + clamp + K1, and the port's Engine
under ``host_bucketize=False`` on a mixed model with id LUTs against the
JAX Engine and the oracle.  Lookups are held with ``==``; tower outputs at
rtol 1e-4 / atol 1e-5 (the towers sum in different orders).

XLA on the CPU compares subnormals as zero, so the comparisons with JAX
keep to normal values; the subnormal and +-0.0 cases are held against the
port's own ``device_bucketize``.  The kernel's own cases, on a card, are
in chip_smoke.py (``k1_group_cases``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.ir import spec as JS
from recom_tpu.ir.intervals import IntervalSet as JIntervals
from recom_tpu.ops import lookup_xla
from recom_tpu.ops.lookup_pallas import _onehot_lookup_impl
from recom_tpu.oracle import OracleModel
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig
from recom_tpu_torch.ir import spec as TS
from recom_tpu_torch.ir.intervals import IntervalSet as TIntervals
from recom_tpu_torch.ops import item_lists as il
from recom_tpu_torch.ops import kernels
from recom_tpu_torch.ops import lookup_gather as tg
from recom_tpu_torch.ops import lookup_onehot as tk

torch.set_num_threads(1)

SPECIALS = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40,
                     1.4e-45], np.float32)


def _table3(rng, c, v, d):
    """Zero-padded [C_pad, V_pad, d] of finite values, no -0.0 (the Queue 3
    convention: the one-hot product turns a -0.0 row into +0.0)."""
    c_pad, v_pad = ((c + 7) // 8) * 8, ((v + 127) // 128) * 128
    t3 = np.zeros((c_pad, v_pad, d), np.float32)
    t3[:c, :v] = rng.standard_normal((c, v, d)).astype(np.float32)
    return t3 + np.float32(0.0)


def _jax_k1(t3, ids):
    """The JAX K1 (Pallas, interpret mode) on [C, Bp] ids: [Bp, C, d]."""
    c, b = ids.shape
    ids_t = np.full((t3.shape[0], b), -1, np.int32)
    ids_t[:c] = ids
    out = _onehot_lookup_impl(jnp.asarray(t3), jnp.asarray(ids_t),
                              interpret=True)
    return np.asarray(out)[:c].transpose(1, 0, 2)


def _mixed_case(rng, nbz, nhost, v, d, b, lut: bool, normal_only: bool):
    """A mixed group: table3, host ids, caps, (boundaries, counts, lut) of
    its nbz bucketize members and their raw plane (boundary hits, the
    floats below them, and, unless ``normal_only``, NaN, +-inf, +-0.0 and
    subnormals)."""
    c = nbz + nhost
    t3 = _table3(rng, c, v, d)
    kmax = 2 * v                     # more buckets than rows: a LUT maps them
    bm = np.full((nbz, kmax), np.inf, np.float32)
    cnt = rng.integers(0, kmax + 1, nbz).astype(np.int32)
    cnt[0] = kmax
    for i in range(nbz):
        bm[i, :cnt[i]] = np.sort(rng.uniform(-10, 10, cnt[i])
                                 .astype(np.float32))
    if cnt[0] > 3:
        bm[0, 2] = bm[0, 1]                             # repeated boundary
    raw = rng.uniform(-12, 12, (nbz, b)).astype(np.float32)
    for i in range(nbz):
        if cnt[i]:
            hits = bm[i, rng.integers(0, cnt[i], 6)]
            raw[i, 10:16] = hits
            raw[i, 16:22] = np.nextafter(hits, np.float32(-np.inf))
    if not normal_only:
        raw[:, :len(SPECIALS)] = SPECIALS
    lm = (rng.integers(-1, v, (nbz, kmax + 1)).astype(np.int32) if lut
          else None)
    if not lut:
        cnt = np.minimum(cnt, v - 1)          # buckets are rows: fit V
        for i in range(nbz):
            bm[i, cnt[i]:] = np.inf
    host = rng.integers(-2, v + 3, (nhost, b)).astype(np.int32)
    caps = rng.integers(v // 2, v, c).astype(np.int32)
    return t3, host, caps, (bm, cnt, lm), raw


def _searched(bounds, raw):
    hi, cn, lm = tk.searched_bounds(*bounds)
    return tk.Searched(torch.from_numpy(raw), torch.from_numpy(hi),
                       torch.from_numpy(cn),
                       None if lm is None else torch.from_numpy(lm))


def test_k1_groups_in_one_call_match_pallas_interpret_group_by_group():
    """``onehot_lookups`` of Criteo-shaped one-column groups at d = 64 and
    wide groups at d = 8 together: each group's rows == the JAX K1's."""
    rng = np.random.default_rng(0)
    shapes = [(1, 155, 64, 40), (1, 976, 64, 40), (13, 200, 8, 40),
              (3, 101, 16, 40), (40, 128, 4, 40)]
    groups, wants = [], []
    for c, v, d, b in shapes:
        t3 = _table3(rng, c, v, d)
        ids = rng.integers(-1, v, (c, b)).astype(np.int32)
        wants.append(_jax_k1(t3, ids))
        groups.append((torch.from_numpy(t3), torch.from_numpy(ids),
                       torch.full((c,), v - 1, dtype=torch.int32)))
    got = tk.onehot_lookups(groups)
    assert len(got) == len(shapes)
    for (c, v, d, b), g, w in zip(shapes, got, wants):
        assert g.shape == (b, c, d)
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("lut", [False, True])
def test_searched_group_matches_jax_bucketize_lut_clamp_and_k1(lut):
    """A mixed group's searched route (plain version) == JAX
    ``device_bucketize`` + the id LUT + the clamp + K1, on normal values
    (boundary hits and the floats below them among them)."""
    rng = np.random.default_rng(1 + lut)
    nbz, nhost, v, d, b = 5, 3, 40, 8, 64
    t3, host, caps, bounds, raw = _mixed_case(rng, nbz, nhost, v, d, b, lut,
                                              normal_only=True)
    bm, cnt, lm = bounds
    jids = np.asarray(lookup_xla.device_bucketize(
        jnp.asarray(raw.T), jnp.asarray(bm), jnp.asarray(cnt))).T
    if lut:
        jids = lm[np.arange(nbz)[:, None], jids]
    ids = np.minimum(np.concatenate([jids, host]), caps[:, None])
    want = _jax_k1(t3, ids)
    got = tk.onehot_lookups([(torch.from_numpy(t3), torch.from_numpy(host),
                              torch.from_numpy(caps), _searched(bounds, raw))])
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("lut", [False, True])
def test_searched_ids_on_edge_values_match_device_bucketize(lut):
    """NaN and +inf at the member's count, -inf below every finite
    boundary, +-0.0, subnormals and exact boundaries: the searched ids
    (``searched_ids_plain``, what K1's id read computes) == the port's
    ``device_bucketize`` (+ LUT) as integers, and the rows those ids
    select."""
    rng = np.random.default_rng(3 + lut)
    nbz, nhost, v, d, b = 4, 2, 30, 4, 40
    t3, host, caps, bounds, raw = _mixed_case(rng, nbz, nhost, v, d, b, lut,
                                              normal_only=False)
    bm, cnt, lm = bounds
    s = _searched(bounds, raw)
    got = tk.searched_ids_plain(s)
    want = tg.device_bucketize(torch.from_numpy(raw), torch.from_numpy(bm),
                               torch.from_numpy(cnt))
    assert (want[:, 0] == torch.from_numpy(cnt)).all()          # NaN
    assert (want[:, 1] == torch.from_numpy(cnt)).all()          # +inf
    if lut:
        want = torch.from_numpy(lm)[torch.arange(nbz)[:, None], want.long()]
    assert got.dtype == torch.int32 and torch.equal(got, want.int())
    ids = torch.minimum(torch.cat([got, torch.from_numpy(host)]),
                        torch.from_numpy(caps)[:, None])
    rows = tk.onehot_lookups([(torch.from_numpy(t3), torch.from_numpy(host),
                               torch.from_numpy(caps), s)])[0]
    plain = tk.onehot_lookup_plain(torch.from_numpy(t3), ids,
                                   torch.from_numpy(caps))
    assert torch.equal(rows.view(torch.int32), plain.view(torch.int32))


def test_searched_group_rejects_bad_inputs():
    rng = np.random.default_rng(5)
    t3, host, caps, bounds, raw = _mixed_case(rng, 3, 2, 20, 4, 32, True,
                                              normal_only=True)
    s = _searched(bounds, raw)
    t3, host, caps = map(torch.from_numpy, (t3, host, caps))
    with pytest.raises(ValueError, match="caps"):
        tk.onehot_lookups([(t3, host, caps[:4], s)])
    with pytest.raises(ValueError, match="raw"):
        tk.onehot_lookups([(t3, host, caps, s._replace(raw=s.raw.double()))])
    with pytest.raises(ValueError, match="lut"):
        tk.onehot_lookups([(t3, host, caps, s._replace(lut=s.lut[:, :3]))])
    with pytest.raises(ValueError, match="ids"):
        tk.onehot_lookups([(t3, host[:, :5], caps, s)])


@pytest.mark.parametrize("c,bp,d,tile", [
    (1, 2048, 64, (1, 7)),        # Criteo's one-column groups: 1 x 128
    (930, 2048, 8, (32, 5)),      # model E's wide group: 32 x 32
    (5, 2048, 64, (5, 4)),        # narrow: all its columns, 16 rows
    (1, 40, 8, (1, 6)),           # no more rows than Bp needs
    (3, 1, 4096, (3, 0)),
])
def test_k1_tile_fits_the_group(c, bp, d, tile):
    cols, rl2 = tk.k1_tile(c, bp, d)
    assert (cols, rl2) == tile
    assert cols * (1 << rl2) <= tk.K1_ENTRIES
    assert tk.k1_blocks(c, bp, d) == -(-c // cols) * -(-bp // (1 << rl2))


def test_searched_ids_reach_k3a_under_autograd():
    """Under autograd a searched group's [C, Bp] ids (the searched members'
    then the host's) are what K3a reads: the table's gradient == the plain
    K3a's on ``searched_ids_plain`` joined to the host ids."""
    rng = np.random.default_rng(6)
    t3, host, caps, bounds, raw = _mixed_case(rng, 3, 2, 20, 4, 33, True,
                                              normal_only=False)
    s = _searched(bounds, raw)
    t = torch.from_numpy(t3).requires_grad_(True)
    out = tk.onehot_lookups([(t, torch.from_numpy(host),
                              torch.from_numpy(caps), s)])[0]
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    (out * g).sum().backward()
    ids = torch.cat([tk.searched_ids_plain(s), torch.from_numpy(host)])
    want = tk.onehot_lookup_grad_plain(g, ids, torch.from_numpy(caps),
                                       t3.shape[0], t3.shape[1])
    assert torch.equal(t.grad, want)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_step_lists_carry_part_from_the_forward_to_the_backward(device):
    """``item_lists.StepLists``: a K3a group cut into several vocab tiles,
    an X1b group and an X1b group whose columns share rows (listed as one
    SUM column) register their entries in the forward, ``run`` lists them
    in one launch of Part, and each backward reads its own, with no Part
    of its own.  The gradients == those of the backward kernels called
    alone, each listing its own, and == the plain versions on CPU copies.
    On the CPU nothing is registered: the plain versions read no lists."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device(device)
    rng = np.random.default_rng(8)
    c, v, d, b = 3, 3000, 16, 64
    t3 = rng.standard_normal((c, v, d)).astype(np.float32)
    ids = rng.integers(-1, v, (c, b)).astype(np.int32)
    caps = np.full(c, v - 1, np.int32)
    assert tk.k3a_entry(torch.from_numpy(ids), torch.from_numpy(caps), c, v,
                        d) is not None           # cut into vocab tiles
    gathers = []
    for offs in (np.arange(5) * 100, np.array([0, 0, 100, 100, 200])):
        offs = offs.astype(np.int32)
        assert tg.shares_rows(offs, 5) == (offs[1] == 0)
        gathers.append((rng.standard_normal((500, d)).astype(np.float32),
                        rng.integers(-1, 100, (5, b, 2)).astype(np.int32),
                        offs, np.array([0, 1, 2, 1, 0], np.int32)))
    g1 = rng.standard_normal((b, c, d)).astype(np.float32)
    gx = [rng.standard_normal((b, 5, d)).astype(np.float32) for _ in gathers]
    on = lambda x: torch.from_numpy(x).to(dev)
    plan = il.StepLists()
    ta = on(t3).requires_grad_(True)
    tbs = [on(t).requires_grad_(True) for t, *_ in gathers]
    a = tk.onehot_lookups([(ta, on(ids), on(caps))], lists=plan)[0]
    ps = tg.groups_pooled([(t, on(i), o, cd) for t, (_, i, o, cd)
                           in zip(tbs, gathers)], lists=plan)
    assert len(plan._pending) == (3 if device == "cuda" else 0)
    part = kernels.launches["Part"]
    plan.run()
    assert not plan._pending
    assert len(plan._lists) == (3 if device == "cuda" else 0)
    loss = (a * on(g1)).sum() + sum((p * on(g)).sum() for p, g in zip(ps, gx))
    loss.backward()
    if device == "cuda":
        torch.cuda.synchronize()
        assert kernels.launches["Part"] == part + 1
    alone_a = tk.onehot_lookups_grad([(on(g1), on(ids), on(caps), c, v)])[0]
    alone_b = tg.groups_pooled_grad([
        (on(g), 500, on(i), o, cd) for g, (_, i, o, cd) in zip(gx, gathers)])
    plain_a = tk.onehot_lookup_grad_plain(
        torch.from_numpy(g1), torch.from_numpy(ids), torch.from_numpy(caps),
        c, v)
    plain_b = tg.groups_pooled_grad([          # CPU copies: the plain
        (torch.from_numpy(g), 500, torch.from_numpy(i), o, cd)
        for g, (_, i, o, cd) in zip(gx, gathers)])
    bits = lambda x, y: torch.equal(x.cpu().view(torch.int32),
                                    y.cpu().view(torch.int32))
    assert bits(ta.grad, alone_a) and bits(ta.grad, plain_a)
    for t, al, pl in zip(tbs, alone_b, plain_b):
        assert bits(t.grad, al) and bits(t.grad, pl)


# ---- the Engine on a mixed model with id LUTs --------------------------------


def _mixed_model(S, Intervals):
    """One one-hot group: three bucketize members (one plain, one under a
    Mod into fewer rows than its buckets, one under a FilterRange: both
    give the group an id LUT) and two int-hash members."""
    tables, cols = {}, []

    def table(name, vocab):
        tables[name] = S.TableSpec(name, vocab, 8, init_seed=len(tables))
        return name

    b0 = [float(x) for x in np.linspace(-5, 5, 12, dtype=np.float32)]
    b1 = [float(x) for x in np.linspace(-20, 20, 30, dtype=np.float32)]
    dense = S.FeatureKind.DENSE_FLOAT
    cols.append(S.FeatureColumn(
        "b0", S.FeatureSource("b0", dense), (S.Bucketize(b0),),
        S.LookupSpec(table("t0", 13), S.Combiner.MEAN)))
    cols.append(S.FeatureColumn(
        "b1", S.FeatureSource("b1", dense), (S.Bucketize(b1), S.Mod(7)),
        S.LookupSpec(table("t1", 7), S.Combiner.SUM)))
    cols.append(S.FeatureColumn(
        "b2", S.FeatureSource("b2", dense),
        (S.Bucketize(b0), S.FilterRange(Intervals.closed(2, 8))),
        S.LookupSpec(table("t2", 13), S.Combiner.MEAN)))
    for name, vocab in (("h0", 20), ("h1", 11)):
        cols.append(S.FeatureColumn(
            name, S.FeatureSource(name, S.FeatureKind.DENSE_INT),
            (S.HashBucket(vocab),),
            S.LookupSpec(table(f"t_{name}", vocab), S.Combiner.MEAN)))
    return S.ModelSpec("mixed", tables, cols)


def _mixed_batch(b: int, seed: int, normal_only: bool):
    rng = np.random.default_rng(seed)
    out = {}
    for name, lo, hi in (("b0", -7, 7), ("b1", -25, 25), ("b2", -7, 7)):
        x = rng.uniform(lo, hi, b).astype(np.float32)
        x[8:14] = np.linspace(-5, 5, 12, dtype=np.float32)[::2]   # hits
        if not normal_only:
            x[:len(SPECIALS)] = SPECIALS
        out[name] = x
    for name in ("h0", "h1"):
        out[name] = rng.integers(0, 1000, b).astype(np.int64)
    return out


@pytest.mark.parametrize("wire_pack", [True, False])
def test_engine_mixed_group_with_luts_matches_jax_engine_and_oracle(
        wire_pack):
    jm, tm = _mixed_model(JS, JIntervals), _mixed_model(TS, TIntervals)
    kw = dict(host_bucketize=False, wire_pack=wire_pack)
    eng = Engine(tm, EngineConfig(**kw), device="cpu")
    (g,) = [g for g in eng.compiled.groups if g.pallas_vocab is not None]
    assert (g.num_columns, g.n_bucketize) == (5, 3)
    assert g.lut_matrix is not None and "k1_hi" in eng._consts[g.gid]
    assert g.boundary_matrix.shape[1] + 1 > 7        # buckets past t1's rows
    params = init_model_params(jm)
    eng = Engine(tm, EngineConfig(**kw), params=params, device="cpu")
    jeng = JEngine(jm, JConfig(**kw), params=params)
    for normal_only in (True, False):
        batch = _mixed_batch(45, seed=9, normal_only=normal_only)
        out = eng.predict(batch, return_pooled=True)
        ref = OracleModel(jm, params).forward(batch)
        for col, r in ref["pooled"].items():
            np.testing.assert_array_equal(out["pooled"][col], r, err_msg=col)
        np.testing.assert_allclose(out["output"], ref["output"], rtol=1e-4,
                                   atol=1e-5)
        if normal_only:
            jout = jeng.predict(batch, return_pooled=True)
            for col in ref["pooled"]:
                np.testing.assert_array_equal(out["pooled"][col],
                                              jout["pooled"][col],
                                              err_msg=col)
            np.testing.assert_allclose(out["output"], jout["output"],
                                       rtol=1e-4, atol=1e-5)


def test_forward_entries_make_no_array_from_the_host(monkeypatch):
    """The forward registers its entries inside a captured training step,
    where no array may be copied from the host: given the Engine's
    per-column tensors, ``x1b_forward_entry`` and ``k3a_entry`` build no
    tensor from a host array (once the plan's host copies are cached)."""
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(rng.integers(-1, 100, (4, 32, 3))
                           .astype(np.int32))
    offs = torch.arange(4, dtype=torch.int32) * 100
    caps = torch.full((4,), 99, dtype=torch.int32)
    want = tg.x1b_forward_entry(400, 8, ids, offs, caps)   # caches the copies

    def no_host(x, *a, **k):
        raise AssertionError("a tensor made from a host array")

    monkeypatch.setattr(torch, "as_tensor", no_host)
    monkeypatch.setattr(torch, "from_numpy", no_host)
    got = tg.x1b_forward_entry(400, 8, ids, offs, caps)
    assert torch.equal(got["ids"], want["ids"])
    assert torch.equal(got["caps"], want["caps"])
    assert np.array_equal(got["info"], want["info"])
    k3 = tk.k3a_entry(ids[:, :, 0].contiguous(), caps, 5, 3000, 16)
    assert k3 is not None and k3["info"].shape == (4, 4)
