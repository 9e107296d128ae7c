"""The port's backward kernels against the JAX package's gradients: the
plain versions of K3a (one-hot lookup), K3b (fused bucketize + lookup) and
X1b (gather + pooling) on the CPU against ``jax.grad``/``jax.vjp`` of the
JAX functions (the Pallas kernels in interpret mode, as
tests/test_pallas_lookup.py runs them), the autograd wrappers against the
plain versions, and on a card the CUDA kernels against the plain versions.

Tolerances: K3a and K3b sum each row in batch order on both sides
(``index_add_`` and XLA's scatter-add, column after column), so they are
held with ``==``; so is X1b with one slot a bag (both sides add in batch
order within a column, and columns never share a row).  With several slots
a bag the JAX gather's transpose adds in [L, Bp, C] order and the port in
[C, Bp, L] order, and a row's sum may take hundreds of slots (ids past a
cap all land on its row) and cancel: the two are held to 1e-5 of the sum
of the terms' magnitudes (the two orders' rounding errors are each at most
about n 2^-24 of it; observed under 1e-6).  Subnormal raw values stay out (XLA on the CPU compares them as
zero, ROADMAP Queue 3), and so do -inf boundaries (the JAX backward counts
only finite boundaries and so disagrees with its own forward there; the
port's backward follows the forward)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from recom_tpu.ops import lookup_xla
from recom_tpu.ops.lookup_pallas import bucket_bounds as j_bucket_bounds
from recom_tpu.ops.lookup_pallas import onehot_bucketize_lookup as j_k2
from recom_tpu.ops.lookup_pallas import onehot_lookup as j_k1
from recom_tpu_torch.ops import item_lists, kernels
from recom_tpu_torch.ops import lookup_gather as tg
from recom_tpu_torch.ops import lookup_onehot as tk

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _k3a_case(seed, c, v, d, b):
    """table3 [C_pad, V_pad, d], ids [C, b] with missing ids, ids past
    their caps and an all-missing column, caps [C], cotangent [b, C, d]."""
    rng = np.random.default_rng(seed)
    c_pad, v_pad = ((c + 7) // 8) * 8, ((v + 127) // 128) * 128
    t3 = np.zeros((c_pad, v_pad, d), np.float32)
    t3[:c, :v] = rng.standard_normal((c, v, d)).astype(np.float32)
    ids = rng.integers(-3, v + 20, (c, b)).astype(np.int32)
    ids[c // 2] = -1
    # a hot row: many entries of column 0 hit row 2
    ids[0, ::3] = 2
    caps = rng.integers(v // 2, v, c).astype(np.int32)
    g = rng.standard_normal((b, c, d)).astype(np.float32)
    return t3, ids, caps, g


@pytest.mark.parametrize("c,v,d,b", [(13, 101, 8, 48), (9, 200, 4, 64),
                                     (3, 128, 3, 37), (7, 2209, 64, 150)])
def test_k3a_plain_matches_jax_grad(c, v, d, b):
    t3, ids, caps, g = _k3a_case(c + v + d, c, v, d, b)
    c_pad = t3.shape[0]
    # the JAX package clamps before its kernel (executor.py:503-505)
    ids_t = np.full((c_pad, b), -1, np.int32)
    ids_t[:c] = np.minimum(ids, caps[:, None])
    g_t = np.zeros((c_pad, b, d), np.float32)
    g_t[:c] = g.transpose(1, 0, 2)

    def loss(t):
        rows = j_k1(t, jnp.asarray(ids_t), 128, 8, 128, True)
        return (rows * jnp.asarray(g_t)).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(t3)))
    got = tk.onehot_lookup_grad(torch.from_numpy(g), torch.from_numpy(ids),
                                torch.from_numpy(caps), *t3.shape[:2])
    assert got.shape == t3.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _k3b_case(seed, c, v_pad, d, b):
    """A pure-bucketize group with no -inf boundary: boundary matrix and
    counts, table3, raw [C, b] holding NaN, +-inf, +-0.0, exact
    boundaries and the floats below them, and a cotangent [b, C, d]."""
    rng = np.random.default_rng(seed)
    kmax = v_pad - 1
    bmat = np.full((c, kmax), np.inf, np.float32)
    cnts = rng.integers(1, kmax + 1, c).astype(np.int32)
    for i in range(c):
        steps = rng.uniform(0.25, 3.0, cnts[i])
        bmat[i, : cnts[i]] = np.cumsum(steps) - steps.sum() / 2
    cnts[0] = 0
    cnts[1] = 9
    bmat[1, :9] = 2.5                                  # repeated
    c_pad = ((c + 7) // 8) * 8
    t3 = np.zeros((c_pad, v_pad, d), np.float32)
    t3[:c] = rng.standard_normal((c, v_pad, d)).astype(np.float32)
    raw = rng.uniform(-60, 60, (c, b)).astype(np.float32)
    raw[:, :5] = [np.nan, np.inf, -np.inf, -0.0, 0.0]
    for i in range(c):
        hits = bmat[i, rng.integers(0, max(int(cnts[i]), 1), 8)]
        raw[i, 5:13] = hits
        raw[i, 13:21] = np.nextafter(hits, np.float32(-np.inf))
    g = rng.standard_normal((b, c, d)).astype(np.float32)
    return bmat, cnts, t3, raw, g


@pytest.mark.parametrize("c,v_pad,d,b", [(11, 128, 8, 48), (5, 256, 3, 40)])
def test_k3b_plain_matches_jax_grad(c, v_pad, d, b):
    bmat, cnts, t3, raw, g = _k3b_case(c + v_pad, c, v_pad, d, b)
    c_pad = t3.shape[0]
    lo, hi, counts = j_bucket_bounds(bmat, cnts, v_pad, c_pad)
    raw_t = np.zeros((c_pad, b), np.float32)
    raw_t[:c] = raw
    g_t = np.zeros((c_pad, b, d), np.float32)
    g_t[:c] = g.transpose(1, 0, 2)

    def loss(t):
        rows = j_k2(t, jnp.asarray(raw_t), jnp.asarray(lo), jnp.asarray(hi),
                    jnp.asarray(counts), 128, 8, 128, True)
        return (rows * jnp.asarray(g_t)).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(t3)))
    bounds = [torch.from_numpy(x) for x in tk.bucket_bounds(bmat, cnts,
                                                            v_pad, c_pad)]
    got = tk.onehot_bucketize_lookup_grad(torch.from_numpy(g),
                                          torch.from_numpy(raw), *bounds)
    np.testing.assert_array_equal(got.numpy(), want)


def _autograd(fn, table, g):
    t = table.clone().requires_grad_(True)
    out = fn(t)
    (gr,) = torch.autograd.grad(out, t, g)
    return gr


def test_onehot_autograd_runs_the_backward_kernels():
    """The wrappers under autograd return K3a's and K3b's plain versions
    (a cotangent that is a slice of a wider one takes no copy), which
    equal torch's own autograd through the plain forwards, -inf
    boundaries included."""
    t3, ids, caps, g = _k3a_case(5, 13, 101, 8, 48)
    a = (torch.from_numpy(ids), torch.from_numpy(caps))
    gt = torch.from_numpy(g)
    wide = torch.zeros((48, 20, 8))
    wide[:, 3:16] = gt
    gs = wide[:, 3:16]
    assert tk.cotangent_rows(gs, 48, 13, 8)[0].data_ptr() == gs.data_ptr()
    got = _autograd(lambda t: tk.onehot_lookup(t, *a), torch.from_numpy(t3),
                    gs)
    np.testing.assert_array_equal(
        got.numpy(), tk.onehot_lookup_grad_plain(gt, *a, *t3.shape[:2]))
    ref = _autograd(lambda t: tk.onehot_lookup_plain(t, *a),
                    torch.from_numpy(t3), gt)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())

    bmat, cnts, t3, raw = chip_smoke.k2_edge_case(45, 128, 8, 100, seed=3)
    g = np.random.default_rng(0).standard_normal((100, 45, 8)).astype(
        np.float32)
    bounds = [torch.from_numpy(x) for x in tk.bucket_bounds(bmat, cnts, 128,
                                                            t3.shape[0])]
    x = torch.from_numpy(raw)
    got = _autograd(lambda t: tk.onehot_bucketize_lookup(t, x, *bounds),
                    torch.from_numpy(t3), torch.from_numpy(g))
    ref = _autograd(lambda t: tk.onehot_bucketize_lookup_plain(t, x, *bounds),
                    torch.from_numpy(t3), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _x1b_case(d, l, weighted, seed):
    table, ids, offs, caps, codes, w, wc = chip_smoke.x1_edge_case(
        d, l, seed=seed, specials=False)
    if not weighted:
        w, wc = None, np.zeros(len(wc), bool)
    g = np.random.default_rng(seed + 1).standard_normal(
        (ids.shape[1], ids.shape[0], d)).astype(np.float32)
    return table, ids, offs, caps, codes, w, wc, g


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d,l", [(8, 1), (3, 1), (8, 12), (32, 2), (1, 5),
                                 (64, 1), (64, 3)])
def test_x1b_plain_matches_jax_vjp(d, l, weighted):
    """SUM, MEAN and SQRTN columns (codes 0, 1, 2, 1, 2, 0), all-missing
    and zero-weight bags, ids past their caps."""
    table, ids, offs, caps, codes, w, wc, g = _x1b_case(d, l, weighted,
                                                        seed=d * 10 + l)
    clamped = np.minimum(ids, caps[:, None, None]).transpose(1, 0, 2)
    jw = None if w is None else jnp.asarray(w.transpose(1, 0, 2))

    def f(t):
        return lookup_xla.group_pooled(t, jnp.asarray(clamped), offs, codes,
                                       jw, exact_math=True, weighted_cols=wc)

    _, vjp = jax.vjp(f, jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    got = tg.group_pooled_grad(
        torch.from_numpy(g), table.shape[0], torch.from_numpy(ids), offs,
        codes, None if w is None else torch.from_numpy(w), wc, caps)
    assert got.shape == table.shape
    if l == 1:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        mag = tg.group_pooled_grad(
            torch.from_numpy(np.abs(g)), table.shape[0],
            torch.from_numpy(ids), offs, codes,
            None if w is None else torch.from_numpy(np.abs(w)), wc, caps)
        err = np.abs(got.numpy() - np.asarray(want))
        assert (err <= 1e-5 * mag.numpy()).all(), err.max()


def test_groups_pooled_autograd_runs_x1b_per_group():
    """One X1 forward for two groups under autograd; each table's gradient
    is that group's X1b plain version, and equals torch's own autograd
    through the plain forward (one row per slot: the same products in the
    same order)."""
    cases = [_x1b_case(8, 12, True, 1), _x1b_case(3, 1, False, 2)]
    args, gs = [], []
    for table, ids, offs, caps, codes, w, wc, g in cases:
        args.append((torch.from_numpy(table).requires_grad_(True),
                     torch.from_numpy(ids), offs, codes,
                     None if w is None else torch.from_numpy(w), wc, caps))
        gs.append(torch.from_numpy(g))
    outs = tg.groups_pooled(args)
    grads = torch.autograd.grad(outs, [a[0] for a in args], gs)
    for a, g, gr in zip(args, gs, grads):
        want = tg.group_pooled_grad_plain(g, a[0].shape[0], *a[1:])
        np.testing.assert_array_equal(gr.numpy(), want.numpy())
    table, ids, offs, caps, codes, w, wc, g = cases[1]
    t = torch.from_numpy(table).requires_grad_(True)
    out = tg.group_pooled_plain(t, torch.from_numpy(ids), offs, codes, None,
                                wc, caps)
    (ref,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    np.testing.assert_array_equal(grads[1].numpy(), ref.numpy())


def test_backward_on_cpu_launches_no_kernel():
    before = dict(kernels.launches)
    t3, ids, caps, g = _k3a_case(7, 5, 101, 8, 16)
    _autograd(lambda t: tk.onehot_lookup(t, torch.from_numpy(ids),
                                         torch.from_numpy(caps)),
              torch.from_numpy(t3), torch.from_numpy(g))
    assert kernels.launches == before


# ---------------------------------------------------------------------------
# On a card: each kernel == its plain version on CPU copies, twice
# ---------------------------------------------------------------------------


def _equal_bits(a, b):
    return torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("c,v,d,b", [(930, 101, 8, 2048), (45, 300, 3, 100),
                                     (13, 2000, 32, 70), (9, 128, 1, 5000),
                                     (7, 2209, 64, 2048), (1, 976, 64, 700)])
def test_k3a_kernel_matches_plain_on_card(cuda, c, v, d, b):
    t3, ids, caps, g = _k3a_case(c + v, c, v, d, b)
    a = [torch.from_numpy(x) for x in (g, ids, caps)]
    want = tk.onehot_lookup_grad(*a, *t3.shape[:2])
    before = kernels.launches["K3a"]
    got = [tk.onehot_lookup_grad(*(x.to(cuda) for x in a), *t3.shape[:2])
           for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.launches["K3a"] == before + 2
    assert _equal_bits(got[0], want) and _equal_bits(got[1], want)


@pytest.mark.cuda
@pytest.mark.parametrize("v_pad,d", [(128, 8), (256, 3), (384, 32)])
def test_k3b_kernel_matches_plain_on_card(cuda, v_pad, d):
    bmat, cnts, t3, raw = chip_smoke.k2_edge_case(45, v_pad, d, 100,
                                                  seed=v_pad + d)
    g = np.random.default_rng(d).standard_normal((100, 45, d)).astype(
        np.float32)
    a = [torch.from_numpy(x) for x in
         (g, raw, *tk.bucket_bounds(bmat, cnts, v_pad, t3.shape[0]))]
    want = tk.onehot_bucketize_lookup_grad(*a)
    got = [tk.onehot_bucketize_lookup_grad(*(x.to(cuda) for x in a))
           for _ in range(2)]
    torch.cuda.synchronize()
    assert _equal_bits(got[0], want) and _equal_bits(got[1], want)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d,l", [(1, 1), (3, 2), (8, 12), (32, 33), (64, 1),
                                 (64, 12)])
def test_x1b_kernel_matches_plain_on_card(cuda, d, l, weighted):
    table, ids, offs, caps, codes, w, wc, g = _x1b_case(d, l, weighted, 3)
    args = [torch.from_numpy(g), table.shape[0], torch.from_numpy(ids), offs,
            codes, None if w is None else torch.from_numpy(w), wc, caps]
    want = tg.group_pooled_grad(*args)
    dev = [x.to(cuda) if isinstance(x, torch.Tensor) else x for x in args]
    got = [tg.group_pooled_grad(*dev) for _ in range(2)]
    torch.cuda.synchronize()
    assert _equal_bits(got[0], want) and _equal_bits(got[1], want)


# ---------------------------------------------------------------------------
# X1b's host side: the work plan, the launch records, one call a backward
# ---------------------------------------------------------------------------


def _plan_rows(plan, num_rows):
    """How many items cover each row of [0, R)."""
    cover = np.zeros(num_rows, np.int64)
    for row_lo, _, nrows, _, _ in plan:
        cover[row_lo: row_lo + nrows] += 1
    return cover


@pytest.mark.parametrize("vocab,d,caps_less,slots", [
    ([10_000] * 3, 8, 0, 2048),                 # model E's small groups
    ([1 << 20, 1 << 19], 32, 0, 2048),          # large vocabs
    ([300, 200_000, 150_000, 90_000], 8, 0,     # both classes in a group,
     40_000),                                   # by rows a slot as well
    ([40, 33_000, 7], 3, 2, 100),               # caps below the vocab: gaps
    ([70_000], 512, 0, 1000),                   # d past a window's words
])
def test_x1b_plan_covers_every_row_once(vocab, d, caps_less, slots):
    vocab = np.asarray(vocab, np.int64)
    offs = np.concatenate([[0], np.cumsum(vocab)[:-1]])
    caps = vocab - 1 - caps_less
    r = int(vocab.sum()) + 5                    # rows past the last member
    plan = tg.x1b_plan(r, d, offs, caps, slots)
    assert (_plan_rows(plan, r) == 1).all()
    tile = tg.x1b_tile_rows(d)
    for row_lo, local_lo, nrows, member, dense in plan:
        if member < 0:
            assert nrows <= tg.X1B_RANGE_ROWS
            continue
        assert row_lo == offs[member] + local_lo
        assert local_lo + nrows <= caps[member] + 1
        sparse = tg.x1b_sparse(int(caps[member]) + 1, d, slots)
        assert bool(dense) != sparse
        assert nrows <= (tg.x1b_range_rows(int(caps[member]) + 1, d, slots)
                         if sparse else tile)
    kinds = plan[:, 4][plan[:, 3] >= 0]
    small = [not tg.x1b_sparse(int(c) + 1, d, slots) for c in caps]
    assert (kinds == 1).sum() == sum(-(-int(c + 1) // tile)
                                     for c, s in zip(caps, small) if s)


@pytest.mark.parametrize("offs,caps,r", [
    ([0, 40], [50, 10], 100),        # member 0's rows run into member 1's
    ([0, 0], [9, 9], 100),           # two members at one offset
    ([0, 60], [9, 50], 100),         # the last member runs past R
    ([0, 120], [9, 9], 100),         # a member starts past R
])
def test_x1b_plan_raises_on_overlapping_members(offs, caps, r):
    with pytest.raises(ValueError, match="X1b"):
        tg.x1b_plan(r, 8, offs, caps, 64)


def test_x1b_work_packs_every_group_sparse_first():
    plans = [tg.x1b_plan(300_000, 8, [0, 100], [99, 299_899], 2048),
             tg.x1b_plan(50, 3, [0, 20], [9, 9], 2048)]
    work = tg.x1b_work(plans)
    assert work.shape == (sum(len(p) for p in plans), 4)
    kind = work[:, 3]
    member, group, dense = (kind >> 4) - 1, (kind >> 1) & 7, kind & 1
    cls = np.where(member < 0, 2, np.where(dense == 1, 1, 0))
    assert (np.diff(cls) >= 0).all()            # sparse, dense, then zero
    assert set(cls) == {0, 1, 2}
    for gi, p in enumerate(plans):
        mine = work[group == gi]
        assert sorted(map(tuple, mine[:, :3])) == sorted(map(tuple, p[:, :3]))
    with pytest.raises(ValueError, match="groups per launch"):
        tg.x1b_work(plans * 5)


def _x1b_groups(seed):
    """Three groups as a backward sees them: model E's kinds at small
    sizes (a MEAN group of one id a bag, a SUM list group, and a group
    whose large-vocab members take sparse ranges, one with every slot in
    one range), with their cotangents."""
    rng = np.random.default_rng(seed)
    out = []
    for c, vocab, d, l, code, weighted in (
            (5, [300] * 5, 8, 1, 1, False), (3, [500] * 3, 8, 6, 0, True),
            (3, [40_000, 70_000, 50], 4, 3, 0, False)):
        vocab = np.asarray(vocab, np.int64)
        offs = np.concatenate([[0], np.cumsum(vocab)[:-1]]).astype(np.int32)
        bp = 40
        ids = np.stack([rng.integers(-2, v + 3, (bp, l)) for v in vocab])
        ids = ids.astype(np.int32)
        if len(vocab) == 3 and vocab[0] > 1000:
            ids[0] = rng.integers(0, 100, (bp, l))      # all in one range
        w = rng.uniform(0.1, 2.0, (c, bp, l)).astype(np.float32)
        g = rng.standard_normal((bp, c, d)).astype(np.float32)
        out.append(dict(
            g=torch.from_numpy(g), rows=int(vocab.sum()),
            ids=torch.from_numpy(ids), offs=offs,
            codes=np.full(c, code, np.int32),
            w=torch.from_numpy(w) if weighted else None,
            wc=np.full(c, weighted), caps=(vocab - 1).astype(np.int32)))
    return out


def _x1b_args(x):
    return (x["g"], x["rows"], x["ids"], x["offs"], x["codes"], x["w"],
            x["wc"], x["caps"])


def test_groups_pooled_grad_matches_plain_and_jax():
    """All groups of a backward in one call equal each group's plain
    version, and the JAX VJP of the one-id group exactly."""
    groups = _x1b_groups(11)
    got = tg.groups_pooled_grad([_x1b_args(x) for x in groups])
    for x, gr in zip(groups, got):
        want = tg.group_pooled_grad_plain(*_x1b_args(x))
        np.testing.assert_array_equal(gr.numpy(), want.numpy())
    x = groups[0]
    clamped = np.minimum(x["ids"].numpy(), x["caps"][:, None, None])

    def f(t):
        return lookup_xla.group_pooled(
            t, jnp.asarray(clamped.transpose(1, 0, 2)), x["offs"],
            x["codes"], None, exact_math=True, weighted_cols=x["wc"])

    table = np.zeros((x["rows"], 8), np.float32)
    _, vjp = jax.vjp(f, jnp.asarray(table))
    (want,) = vjp(jnp.asarray(x["g"].numpy()))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    outs = [torch.full((x["rows"], x["g"].shape[2]), float("nan"))
            for x in groups]
    back = tg.groups_pooled_grad([_x1b_args(x) for x in groups], out=outs)
    assert all(b is o for b, o in zip(back, outs))
    for b, gr in zip(back, got):
        np.testing.assert_array_equal(b.numpy(), gr.numpy())


def test_x1b_descriptors_describe_each_group():
    """The X1B_DESC record of a group holds its pointers and sizes, its
    plan key the group's constants (the plan made once per key)."""
    x = _x1b_groups(12)[1]
    checked = tg._x1b_check(*_x1b_args(x))
    desc, key, out, keep = tg._x1b_group(checked)
    f = tg.X1B_DESC.unpack(desc)
    g, ids, w, caps, codes, wcols, o = f[:7]
    assert (g, ids, w, o) == (x["g"].data_ptr(), x["ids"].data_ptr(),
                              x["w"].data_ptr(), out.data_ptr())
    assert (caps, codes, wcols) == tuple(t.data_ptr() for t in keep[3:])
    assert f[7:] == (x["g"].stride(0), 3, 40, 6, 8)
    assert tuple(out.shape) == (x["rows"], 8)
    assert key[:2] == (x["rows"], 8)
    plan = tg._x1b_plan_cached(*key)
    assert plan is tg._x1b_plan_cached(*key)
    assert key[4] == 40 * 6                     # slots a member: Bp x L
    np.testing.assert_array_equal(plan, tg.x1b_plan(x["rows"], 8, x["offs"],
                                                    x["caps"], 40 * 6))


def test_groups_pooled_backward_is_one_call(monkeypatch):
    """Autograd through groups_pooled calls the X1b wrapper once for all
    groups whose tables need a gradient (one launch on the card)."""
    groups = _x1b_groups(13)
    calls = []
    real = tg.groups_pooled_grad

    def spy(entries, out=None, lists=None):
        calls.append(len(entries))
        return real(entries, out, lists)

    monkeypatch.setattr(tg, "groups_pooled_grad", spy)
    tables = [torch.zeros((x["rows"], x["g"].shape[2]),
                          requires_grad=i != 1)
              for i, x in enumerate(groups)]
    outs = tg.groups_pooled([(t, x["ids"], x["offs"], x["codes"], x["w"],
                              x["wc"], x["caps"])
                             for t, x in zip(tables, groups)])
    loss = sum((o * x["g"]).sum() for o, x in zip(outs, groups))
    loss.backward()
    assert calls == [2]
    assert tables[1].grad is None
    for t, x in ((tables[0], groups[0]), (tables[2], groups[2])):
        np.testing.assert_array_equal(
            t.grad.numpy(), tg.group_pooled_grad_plain(*_x1b_args(x)).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("d,weighted,crowded", chip_smoke.X1B_CLASS_CASES)
def test_x1b_classes_into_nan_outputs_on_card(cuda, d, weighted, crowded):
    """Small- and large-vocab members in one group (slots spanning every
    range, in one range, a hot row), or a range crowded past a window: the
    kernel writes every element of a NaN-filled output, twice the same
    bits, == the plain version."""
    g, r, ids, offs, caps, codes, w, wc = chip_smoke.x1b_class_case(
        d, seed=d + 100 * crowded, weighted=weighted, crowded=crowded)
    args = [torch.from_numpy(g), r, torch.from_numpy(ids), offs, codes,
            None if w is None else torch.from_numpy(w), wc, caps]
    want = tg.group_pooled_grad(*args)
    dev = [x.to(cuda) if isinstance(x, torch.Tensor) else x for x in args]
    outs = [torch.full((r, d), float("nan"), device=cuda) for _ in range(2)]
    before = kernels.launches["X1b"]
    got = [tg.groups_pooled_grad([dev], out=[o])[0] for o in outs]
    torch.cuda.synchronize()
    assert kernels.launches["X1b"] == before + 2
    assert all(gr is o for gr, o in zip(got, outs))
    assert _equal_bits(got[0], want) and _equal_bits(got[1], want)


@pytest.mark.cuda
def test_x1b_one_launch_for_every_group_on_card(cuda):
    groups = _x1b_groups(14)
    want = [tg.group_pooled_grad_plain(*_x1b_args(x)) for x in groups]
    dev = [tuple(a.to(cuda) if isinstance(a, torch.Tensor) else a
                 for a in _x1b_args(x)) for x in groups]
    before = kernels.launches["X1b"]
    got = tg.groups_pooled_grad(dev)
    torch.cuda.synchronize()
    assert kernels.launches["X1b"] == before + 1
    for gr, w in zip(got, want):
        assert _equal_bits(gr, w)


@pytest.mark.cuda
@pytest.mark.parametrize("given", ["none", "all", "some"])
def test_x1b_more_groups_than_a_launch_on_card(cuda, given):
    """Twelve groups in one call, past X1B_MAX_GROUPS: two launches of
    X1b, each group == its plain version, whether Part's lists come from
    the call (one launch of Part a launch of X1b), from a partition made
    beforehand, as the forward's ``StepLists`` makes it, or for every
    other group only."""
    groups = [x for seed in (15, 16, 17, 18) for x in _x1b_groups(seed)]
    assert len(groups) > tg.X1B_MAX_GROUPS
    want = [tg.group_pooled_grad_plain(*_x1b_args(x)) for x in groups]
    dev = [tuple(a.to(cuda) if isinstance(a, torch.Tensor) else a
                 for a in _x1b_args(x)) for x in groups]
    made = item_lists.partition(tg.x1b_partition_groups(dev))
    lists = {"none": None, "all": made,
             "some": [p if k % 2 else None for k, p in enumerate(made)]}
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    got = tg.groups_pooled_grad(dev, lists=lists[given])
    torch.cuda.synchronize()
    launches = -(-len(groups) // tg.X1B_MAX_GROUPS)
    assert kernels.launches["X1b"] == before["X1b"] + launches
    assert kernels.launches["Part"] == before["Part"] + (
        0 if given == "all" else launches)
    for gr, w in zip(got, want):
        assert _equal_bits(gr, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 8, 32, 64])
@pytest.mark.parametrize("kernel", ["K3a", "K3b"])
def test_k3_edge_shapes_on_card(cuda, kernel, d):
    """C = 45, not a multiple of the columns an item takes; Bp = 700, past
    a stage of the ring."""
    b = 700
    g = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (b, 45, d)).astype(np.float32))
    if kernel == "K3a":
        t3, ids, caps = chip_smoke.k1_edge_case(45, 101, d, b, seed=d,
                                                specials=False)
        a = [g, torch.from_numpy(ids), torch.from_numpy(caps)]
        fn = lambda *x: tk.onehot_lookup_grad(*x, *t3.shape[:2])
    else:
        bmat, cnts, t3, raw = chip_smoke.k2_edge_case(45, 128, d, b, seed=d)
        a = [g, torch.from_numpy(raw),
             *map(torch.from_numpy, tk.bucket_bounds(bmat, cnts, 128,
                                                     t3.shape[0]))]
        fn = tk.onehot_bucketize_lookup_grad
    want = fn(*a)
    got = [fn(*(x.to(cuda) for x in a)) for _ in range(2)]
    torch.cuda.synchronize()
    assert _equal_bits(got[0], want) and _equal_bits(got[1], want)
