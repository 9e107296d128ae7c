"""The port's lookup kernels K1 (one-id lookup) and X1 (gather + in-order
pooling) against the JAX reference: the plain PyTorch versions on the CPU
(what the wrappers run for CPU tensors), and the CUDA kernels against the
plain versions on a card.  Results are held with ``==`` (as the JAX
package's own tests do: +0 == -0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from recom_tpu.ops import lookup_xla
from recom_tpu.ops.lookup_pallas import _onehot_lookup_impl, group_pooled_onehot
from recom_tpu_torch.ops import kernels
from recom_tpu_torch.ops import lookup_gather as tg
from recom_tpu_torch.ops.lookup_onehot import onehot_lookup, onehot_lookup_plain

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table3(rng, c, v, d):
    """Zero-padded [C_pad, V_pad, d] like the engine's one-hot layout."""
    c_pad, v_pad = ((c + 7) // 8) * 8, ((v + 127) // 128) * 128
    t3 = np.zeros((c_pad, v_pad, d), np.float32)
    t3[:c, :v] = rng.standard_normal((c, v, d)).astype(np.float32)
    return t3


@pytest.mark.parametrize("c,v,d,b", [(13, 200, 8, 48), (8, 128, 4, 64),
                                     (3, 101, 16, 37), (7, 2209, 64, 40),
                                     (1, 1543, 64, 30)])
def test_k1_plain_matches_pallas_interpret(c, v, d, b):
    rng = np.random.default_rng(c * 1000 + v)
    t3 = _table3(rng, c, v, d)
    ids = rng.integers(0, v, (c, b)).astype(np.int32)
    ids[rng.random((c, b)) < 0.2] = -1
    ids_t = np.full((t3.shape[0], b), -1, np.int32)
    ids_t[:c] = ids
    want = np.asarray(
        _onehot_lookup_impl(jnp.asarray(t3), jnp.asarray(ids_t),
                            interpret=True)
    )[:c].transpose(1, 0, 2)
    caps = torch.full((c,), v - 1, dtype=torch.int32)
    got = onehot_lookup(torch.from_numpy(t3), torch.from_numpy(ids), caps)
    assert got.shape == (b, c, d)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k1_clamp_and_combiners_match_group_pooled_onehot():
    """K1 fuses the serving clamp (ids past a member's vocab -> its last
    row) and the one-id combiner of group_pooled_onehot (every combiner
    passes the row through or gives 0)."""
    rng = np.random.default_rng(1)
    c, v, d, b = 11, 100, 8, 40
    t3 = _table3(rng, c, v, d)
    ids = rng.integers(-3, v + 30, (c, b)).astype(np.int32)
    caps = rng.integers(v - 20, v, c).astype(np.int32)
    code = np.asarray([0, 1, 2] * 3 + [1, 0], np.int32)
    clamped = np.minimum(ids, caps[:, None])
    want = np.asarray(group_pooled_onehot(
        jnp.asarray(t3), jnp.asarray(clamped.T[:, :, None]), code, c,
        interpret=True,
    ))
    got = onehot_lookup(torch.from_numpy(t3), torch.from_numpy(ids),
                        torch.from_numpy(caps))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [1, 3, 8, 32, 64])
def test_k1_plain_matches_pallas_on_ragged_tiles(d):
    c, v, b = 45, 101, 100
    # NaN rows would spread through the reference's one-hot product
    t3, ids, caps = chip_smoke.k1_edge_case(c, v, d, b, seed=d,
                                            specials=False)
    clamped = np.minimum(ids, caps[:, None])
    ids_t = np.full((t3.shape[0], b), -1, np.int32)
    ids_t[:c] = clamped
    want = np.asarray(
        _onehot_lookup_impl(jnp.asarray(t3), jnp.asarray(ids_t),
                            interpret=True)
    )[:c].transpose(1, 0, 2)
    got = onehot_lookup(torch.from_numpy(t3), torch.from_numpy(ids),
                        torch.from_numpy(caps))
    assert got.shape == (b, c, d)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k1_plain_copies_rows_bit_for_bit():
    """-0.0 and NaN rows (with payloads) come through as their bits; a
    missing id gives +0.0."""
    c, v, d, b = 5, 16, 3, 40
    t3, ids, caps = chip_smoke.k1_edge_case(c, v, d, b, seed=3)
    t3.view(np.int32)[:, 2::7] = np.int32(-8_388_607)     # 0xFF800001, NaN
    got = onehot_lookup(torch.from_numpy(t3), torch.from_numpy(ids),
                        torch.from_numpy(caps)).numpy()
    clamped = np.minimum(ids, caps[:, None])
    want = np.zeros((b, c, d), np.float32)
    for i in range(c):
        ok = clamped[i] >= 0
        want[ok, i] = t3[i, clamped[i, ok]]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_k1_wrapper_rejects_bad_inputs():
    t3 = torch.zeros((8, 128, 8))
    ids = torch.zeros((4, 16), dtype=torch.int32)
    caps = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        onehot_lookup(t3, ids.long(), caps)
    with pytest.raises(ValueError, match="f32"):
        onehot_lookup(t3.double(), ids, caps)
    with pytest.raises(ValueError, match="contiguous"):
        onehot_lookup(t3, torch.zeros((16, 4), dtype=torch.int32).T, caps)
    with pytest.raises(ValueError, match="caps"):
        onehot_lookup(t3, ids, caps[:3])


def _x1_case(seed, c, b, l, d, weighted):
    rng = np.random.default_rng(seed)
    vocab = rng.integers(5, 40, c)
    offs = np.concatenate([[0], np.cumsum(vocab)[:-1]]).astype(np.int32)
    table = rng.standard_normal((int(vocab.sum()), d)).astype(np.float32)
    ids = np.stack(
        [rng.integers(0, vocab[i], (b, l)) for i in range(c)], axis=1
    ).astype(np.int32)                                    # [B, C, L]
    ids[rng.random(ids.shape) < 0.3] = -1
    ids[0] = -1                                           # an all-empty row
    weights = (
        rng.uniform(0.1, 2.0, ids.shape).astype(np.float32)
        if weighted else None
    )
    return table, ids, offs, vocab, weights


@pytest.mark.parametrize("l", [1, 5])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("codes", [(0, 0, 0, 0, 0, 0), (1, 1, 1, 1, 1, 1),
                                   (0, 1, 2, 2, 1, 0)])
def test_x1_plain_matches_lookup_xla(l, weighted, codes):
    c, b, d = 6, 33, 8
    table, ids, offs, vocab, weights = _x1_case(
        10 * l + weighted, c, b, l, d, weighted
    )
    code = np.asarray(codes, np.int32)
    # a group may mix divide (weighted) and reciprocal rounding per column
    wcols = np.asarray([True, False, True, False, False, True])
    if not weighted:
        wcols = np.zeros(c, bool)
    want = np.asarray(lookup_xla.group_pooled(
        jnp.asarray(table), jnp.asarray(ids), offs, code,
        None if weights is None else jnp.asarray(weights),
        exact_math=True, weighted_cols=wcols,
    ))
    got = tg.group_pooled(
        torch.from_numpy(table),
        torch.from_numpy(np.ascontiguousarray(ids.transpose(1, 0, 2))),
        offs, code,
        None if weights is None else torch.from_numpy(
            np.ascontiguousarray(weights.transpose(1, 0, 2))),
        wcols, (vocab - 1).astype(np.int32),
    )
    assert got.shape == (b, c, d)
    np.testing.assert_array_equal(got.numpy(), want)


def test_x1_clamp_to_member_last_row():
    """Over-range ids clamp to THEIR member's last row, never a sibling's."""
    c, b, l, d = 4, 20, 3, 4
    table, ids, offs, vocab, _ = _x1_case(7, c, b, l, d, False)
    ids = ids + np.int32(50) * (ids >= 0)                 # all over range
    code = np.asarray([0, 1, 0, 1], np.int32)
    caps = (vocab - 1).astype(np.int32)
    want = np.asarray(lookup_xla.group_pooled(
        jnp.asarray(table),
        jnp.asarray(np.minimum(ids, caps[None, :, None])), offs, code,
    ))
    got = tg.group_pooled(
        torch.from_numpy(table),
        torch.from_numpy(np.ascontiguousarray(ids.transpose(1, 0, 2))),
        offs, code, vocab_caps=caps,
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_combiner_divisors_and_pool_rows_match_reference():
    rng = np.random.default_rng(5)
    c, b, l, d = 5, 9, 4, 8
    rows = rng.standard_normal((b, c, l, d)).astype(np.float32)
    w = rng.uniform(0, 2, (b, c, l)).astype(np.float32)
    w[:, 1] = 0.0                                         # zero denominators
    code = np.asarray([0, 1, 2, 1, 2], np.int32)
    wcols = np.asarray([True, False, False, True, True])
    want = np.asarray(lookup_xla.pool_rows_inorder(
        jnp.asarray(rows), jnp.asarray(w), code, True, wcols
    ))
    got = tg.pool_rows_inorder(
        torch.from_numpy(np.ascontiguousarray(rows.transpose(1, 0, 2, 3))),
        torch.from_numpy(np.ascontiguousarray(w.transpose(1, 0, 2))),
        code, wcols,
    )
    np.testing.assert_array_equal(got.numpy().transpose(1, 0, 2), want)


def test_device_bucketize_matches_reference():
    rng = np.random.default_rng(6)
    bounds = np.full((3, 6), np.inf, np.float32)
    bounds[0, :5] = [0, 1, 2, 3, 4]
    bounds[1, :3] = [-1.5, 0.5, 7.25]
    bounds[2, :6] = np.arange(6) * 10
    counts = np.asarray([5, 3, 6], np.int32)
    x = rng.uniform(-5, 60, (3, 25)).astype(np.float32)
    x[:, :4] = [np.nan, np.inf, -np.inf, 0.5]
    want = np.asarray(lookup_xla.device_bucketize(
        jnp.asarray(x.T), jnp.asarray(bounds), jnp.asarray(counts)
    )).T
    got = tg.device_bucketize(torch.from_numpy(x), torch.from_numpy(bounds),
                              torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card(cuda):
    rng = np.random.default_rng(8)
    c, v, d, b = 37, 101, 8, 300
    t3 = torch.from_numpy(_table3(rng, c, v, d)).to(cuda)
    ids = torch.from_numpy(
        rng.integers(-2, v + 9, (c, b)).astype(np.int32)).to(cuda)
    caps = torch.full((c,), v - 1, dtype=torch.int32, device=cuda)
    before = kernels.launches["K1"]
    got = onehot_lookup(t3, ids, caps)
    assert kernels.launches["K1"] == before + 1
    torch.testing.assert_close(got, onehot_lookup_plain(t3, ids, caps),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("l,d,weighted", [(1, 8, False), (12, 32, False),
                                          (5, 8, True)])
def test_x1_kernel_matches_plain_on_card(cuda, l, d, weighted):
    c, b = 6, 257
    table, ids, offs, vocab, weights = _x1_case(l + d, c, b, l, d, weighted)
    code = np.asarray([0, 1, 2, 2, 1, 0], np.int32)
    wcols = np.asarray([True, False, True, False, False, True]) & weighted
    tt = torch.from_numpy(table).to(cuda)
    it = torch.from_numpy(np.ascontiguousarray(ids.transpose(1, 0, 2))).to(cuda)
    wt = None if weights is None else torch.from_numpy(
        np.ascontiguousarray(weights.transpose(1, 0, 2))).to(cuda)
    caps = (vocab - 1).astype(np.int32)
    before = kernels.launches["X1"]
    got = tg.group_pooled(tt, it, offs, code, wt, wcols, caps)
    assert kernels.launches["X1"] == before + 1
    want = tg.group_pooled_plain(tt, it, offs, code, wt, wcols, caps)
    assert bool((got == want).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 8, 32, 64])
def test_k1_kernel_edges_match_plain_on_card(cuda, d):
    """Ragged tiles (C = 45, Bp = 100), d off the float4 path (1, 3) and on
    it (8, 32), an all-missing column, ids past their caps and below -1,
    and -0.0 / NaN rows, compared as bits."""
    c, v, b = 45, 101, 100
    t3, ids, caps = chip_smoke.k1_edge_case(c, v, d, b, seed=100 + d)
    t3g = torch.from_numpy(t3).to(cuda)
    idsg = torch.from_numpy(ids).to(cuda)
    capsg = torch.from_numpy(caps).to(cuda)
    before = kernels.launches["K1"]
    got = onehot_lookup(t3g, idsg, capsg)
    assert kernels.launches["K1"] == before + 1
    want = onehot_lookup_plain(t3g, idsg, capsg)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, c, d)
    assert bool((got.view(torch.int32) == want.view(torch.int32)).all())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("l", chip_smoke.X1_EDGE_L)
@pytest.mark.parametrize("d", chip_smoke.X1_EDGE_D)
def test_x1_plain_matches_lookup_xla_on_edges(d, l, weighted):
    """All-missing bags, ids past their caps and below -1, -0.0 rows, NaN
    and +-inf rows (never a member's row 0, which the reference reads for
    a missing slot), zero-weight MEAN and SQRTN bags, mixed rounding."""
    table, ids, offs, caps, code, w, wcols = chip_smoke.x1_edge_case(
        d, l, seed=10 * d + l)
    if not weighted:
        w, wcols = None, np.zeros(len(wcols), bool)
    clamped = np.minimum(ids, caps[:, None, None]).transpose(1, 0, 2)
    want = np.asarray(lookup_xla.group_pooled(
        jnp.asarray(table), jnp.asarray(clamped), offs, code,
        None if w is None else jnp.asarray(w.transpose(1, 0, 2)),
        exact_math=True, weighted_cols=wcols,
    ))
    got = tg.group_pooled(
        torch.from_numpy(table), torch.from_numpy(ids), offs, code,
        None if w is None else torch.from_numpy(w), wcols, caps,
    ).numpy()
    assert got.shape == (100, 6, d)
    np.testing.assert_array_equal(got, want)


def _x1_blocks(desc, blocks):
    """The (group, column, batch row) bags or entries each block of an X1
    launch pools, as csrc/pooled_gather.cu maps them: a bag-tile block takes
    tile_cols columns x tile_rows batch rows of its group, G lanes a bag,
    batch tiles first; a one-id block (kind bit 64) 32 columns x 32 batch
    rows, column tiles first, each of its 256 threads reading the ids of
    entries e, e + 256, ... (column e // 32, batch row e % 32)."""
    seen = []
    begins = [g["block_begin"] for g in desc]
    for blk in range(blocks):
        i = int(np.searchsorted(begins, blk, side="right")) - 1
        g = desc[i]
        local = blk - int(g["block_begin"])
        tc, tb = divmod(local, int(g["tiles_b"]))
        if int(g["kind"]) & 64:
            tb, tc = divmod(local, -(-int(g["C"]) // 32))
            for t in range(tg.X1_THREADS):
                for e in range(t, 32 * 32, tg.X1_THREADS):
                    c, b = tc * 32 + e // 32, tb * 32 + e % 32
                    if c < g["C"] and b < g["Bp"]:
                        seen.append((i, c, b))
            continue
        lanes = 1 << (int(g["kind"]) % 8)
        bags = 256 // lanes                  # pool_tile's kBags, TB, TC
        rows = min(32, bags)
        cols = bags // rows
        for t in range(0, tg.X1_THREADS, lanes):
            bag = t // lanes
            c, b = tc * cols + bag // rows, tb * rows + bag % rows
            if c < g["C"] and b < g["Bp"]:
                seen.append((i, c, b))
    return seen


def test_x1_descriptors_cover_every_bag_once():
    """One launch of eight groups, both tiles: f32 d = 8 bags (float4
    units), model E's 980-column int8 one-id group and a ragged one-id
    group of scalars, 16-byte units of bf16 and int8 rows (8 and 16
    elements; 8 at int8 d = 8), a scalar group.  Each group's kind, units
    and block count are csrc/pooled_gather.cu's, and every (column, batch
    row) of every group is pooled by exactly one block."""
    # (C, Bp, L, d, unit, one-id)
    shapes = [(50, 2048, 1, 8, 4, False), (980, 2048, 1, 8, 4, True),
              (15, 2048, 12, 8, 8, False), (5, 2048, 7, 32, 16, False),
              (6, 100, 33, 3, 1, False), (45, 100, 1, 12, 1, True),
              (2, 9, 1, 200, 8, False), (4, 70, 5, 64, 16, False)]
    groups = [dict(table=1 + i, scales=i % 2, ids=2, weights=0,
                   row_offsets=3, caps=4, codes=5, weighted=6, out=7 + i,
                   C=c, Bp=bp, L=l, d=d, unit=unit, oneid=oneid)
              for i, (c, bp, l, d, unit, oneid) in enumerate(shapes)]
    # (dq, lanes, tile rows, tile cols) as csrc/pooled_gather.cu has them
    assert [tg.x1_tile(d, unit, oneid) for d, unit, oneid in (
        (8, 4, False), (32, 4, False), (1, 1, False), (3, 1, False),
        (200, 4, False), (8, 8, False), (32, 16, False), (64, 8, False),
        (8, 4, True), (12, 1, True))] == [
        (2, 2, 32, 4), (8, 8, 32, 1), (1, 1, 32, 8), (3, 4, 32, 2),
        (50, 32, 8, 1), (1, 1, 32, 8), (2, 2, 32, 4), (8, 8, 32, 1),
        (2, 1, 32, 32), (12, 1, 32, 32)]
    packed, blocks = tg.x1_descriptors(groups)
    assert tg.X1_DESC.size == 120 and len(packed) == 120 * len(shapes)
    desc = [dict(zip(tg.X1_FIELDS, r)) for r in tg.X1_DESC.iter_unpack(packed)]
    field = lambda k: [g[k] for g in desc]
    assert field("table") == [1 + i for i in range(len(shapes))]
    assert field("scales") == [i % 2 for i in range(len(shapes))]
    # 64 * one-id + 8 * log2(unit) + log2(lanes)
    assert field("kind") == [16 + 1, 64 + 16, 24, 32 + 1, 2, 64, 24 + 5,
                             32 + 2]
    assert field("dq") == [2, 2, 1, 2, 3, 12, 25, 4]
    assert field("out") == [7 + i for i in range(len(shapes))]
    assert field("C") == [s[0] for s in shapes]
    assert field("block_begin")[0] == 0
    assert list(np.diff(field("block_begin") + [blocks])) == [
        832, 31 * 64, 128, 128, 12, 2 * 4, 4, 6]
    seen = _x1_blocks(desc, blocks)
    want = {(i, c, b) for i, (cc, bp, *_) in enumerate(shapes)
            for c in range(cc) for b in range(bp)}
    assert len(seen) == len(set(seen)) == len(want) and set(seen) == want
    with pytest.raises(ValueError, match="groups per launch"):
        tg.x1_descriptors(groups + groups[:1])
    with pytest.raises(ValueError, match="does not fit"):
        tg.x1_descriptors([dict(groups[4], unit=4)])
    with pytest.raises(ValueError, match="does not fit"):
        tg.x1_descriptors([dict(groups[2], d=12)])        # 12 % 8
    with pytest.raises(ValueError, match="does not fit"):
        tg.x1_descriptors([dict(groups[1], unit=8)])      # one-id: 1 or 4
    with pytest.raises(ValueError, match="one-id tile takes"):
        tg.x1_descriptors([dict(groups[1], L=2)])
    with pytest.raises(ValueError, match="one-id tile takes"):
        tg.x1_descriptors([dict(groups[1], weights=9)])


def test_groups_pooled_equals_group_pooled_per_group():
    cases = [chip_smoke.x1_edge_case(d, l, seed=d + l)
             for d, l in ((8, 1), (32, 12), (3, 33))]
    args = [(torch.from_numpy(t), torch.from_numpy(i), o, code,
             torch.from_numpy(w), wc, caps)
            for t, i, o, caps, code, w, wc in cases]
    got = tg.groups_pooled(args)
    assert len(got) == 3 and tg.groups_pooled([]) == []
    for g, a in zip(got, args):
        np.testing.assert_array_equal(g.numpy(), tg.group_pooled(*a).numpy())


def _same_or_nan(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("l", chip_smoke.X1_EDGE_L)
@pytest.mark.parametrize("d", chip_smoke.X1_EDGE_D)
def test_x1_kernel_edges_match_plain_on_card(cuda, d, l):
    """The kernel skips missing slots (as the oracle does) where the plain
    version adds row 0 x 0: the two agree with == and equal NaN positions
    while row 0 of every member is finite."""
    table, ids, offs, caps, code, w, wcols = chip_smoke.x1_edge_case(
        d, l, seed=10 * d + l)
    a = (torch.from_numpy(table).to(cuda), torch.from_numpy(ids).to(cuda),
         offs, code, torch.from_numpy(w).to(cuda), wcols, caps)
    before = kernels.launches["X1"]
    got = tg.group_pooled(*a)
    assert kernels.launches["X1"] == before + 1
    want = tg.group_pooled_plain(*a)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (100, 6, d)
    assert _same_or_nan(got, want)


@pytest.mark.cuda
def test_x1_one_launch_serves_many_groups_on_card(cuda):
    """Ten groups of every lane count and both row types: two launches (8
    groups each at most), each group == its plain version."""
    pairs = [(d, l) for d in chip_smoke.X1_EDGE_D for l in (1, 12)]
    pairs += [(8, 33), (32, 2)]
    args = []
    for d, l in pairs:
        table, ids, offs, caps, code, w, wcols = chip_smoke.x1_edge_case(
            d, l, seed=d * l)
        args.append((torch.from_numpy(table).to(cuda),
                     torch.from_numpy(ids).to(cuda), offs, code,
                     torch.from_numpy(w).to(cuda), wcols, caps))
    before = kernels.launches["X1"]
    got = tg.groups_pooled(args)
    assert kernels.launches["X1"] == before + 2
    for g, a in zip(got, args):
        assert _same_or_nan(g, tg.group_pooled_plain(*a))


def test_sqrtn_denominator_is_correctly_rounded():
    """SQRTN divides by the correctly rounded f32 root of the squared
    weight sum (the oracle's np.sqrt, the kernel's __fsqrt_rn); torch's own
    f32 sqrt on the CPU misses by an ulp on some inputs."""
    rng = np.random.default_rng(11)
    w2 = rng.uniform(0.01, 4.0, (1, 100_000)).astype(np.float32)
    acc = torch.ones((1, w2.shape[1], 1))
    got = tg.apply_combiner_divisors(
        acc, torch.from_numpy(w2), torch.from_numpy(w2), np.asarray([2]),
        True)[0, :, 0].numpy()
    np.testing.assert_array_equal(got, np.float32(1) / np.sqrt(w2[0]))
