"""The partition pass Part (ops/item_lists.py) that lists each work item's
own entries for X1b, K3a and K3b, and the one-hot groups' backward
collected in one call.

On the CPU: the plain version of the partition held to its definition
(every entry with an item placed once, in its segment's region, ordered by
item and then by entry; every other place -1; each item's first place in
each segment) on random and edge inputs, integers compared with ``==``;
the host plans that feed it (X1b's member rows beside ``x1b_plan``, K3's
vocab tiles); and the one-hot lookups of several groups under autograd
against ``jax.grad`` of the JAX package's Pallas kernel in interpret mode,
bit for bit (both sum each row in batch order, column after column, as
tests/test_torch_grad.py holds a single group).  On a card: the kernel
``==`` its plain version, and K3a over several groups in one launch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from recom_tpu.ops.lookup_pallas import onehot_lookup as j_k1
from recom_tpu_torch.ops import item_lists as il
from recom_tpu_torch.ops import kernels
from recom_tpu_torch.ops import lookup_gather as tg
from recom_tpu_torch.ops import lookup_onehot as tk

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _definition(values, info):
    """(slot, val, off) of the partition, entry by entry from its
    definition (numpy loops)."""
    values = np.asarray(values, np.int64)
    c, s = values.shape
    nseg = il.segments(s)
    slot = np.full((c, s), -1, np.int64)
    val = np.full((c, s), -1, np.int64)
    off = np.zeros(il.off_rows(info) * nseg, np.int64)
    for m in range(c):
        unit, items, lim, ibase = (int(x) for x in info[m])
        for sg in range(nseg):
            lo, hi = sg * il.PART_SEG, min(s, (sg + 1) * il.PART_SEG)
            mine = [(values[m, e] // unit, e) for e in range(lo, hi)
                    if 0 <= values[m, e] < lim
                    and values[m, e] // unit < items]
            mine.sort()
            for p, (_, e) in enumerate(mine):
                slot[m, lo + p] = e
                val[m, lo + p] = values[m, e]
            keys = [k for k, _ in mine]
            for i in range(items + 1):
                off[il.off_at(info, nseg, m, i, sg)] = sum(k < i
                                                           for k in keys)
    return slot, val, off


def _check(values, info):
    got = il.partition_plain(torch.from_numpy(np.asarray(values, np.int32)),
                             info)
    for x, want in zip(got, _definition(values, info)):
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), want)
    return got


@pytest.mark.parametrize("seed", range(4))
def test_partition_plain_matches_its_definition(seed):
    """Members of several units and items, values below 0, past their
    bound and at it, over one and three segments."""
    rng = np.random.default_rng(seed)
    c = 3
    s = (5000, 200, 9000, 4096)[seed]
    units = rng.integers(1, 50, c)
    items = rng.integers(1, 40, c)
    lims = units * items - rng.integers(0, 3, c)
    values = rng.integers(-3, int(lims.max()) + 5, (c, s))
    _check(values, il.member_info(units, items, lims))


@pytest.mark.parametrize("case", ["empty items", "one item", "no items",
                                  "all missing", "no entries"])
def test_partition_plain_edge_inputs(case):
    """An item that no entry selects; every entry in one item (one hot
    row); a member with no items; every entry missing; members of no
    entries (their offsets still written)."""
    rng = np.random.default_rng(7)
    c, s = 4, 6000
    units, items, lims = [8, 8, 8, 8], [6, 6, 6, 6], [48, 48, 48, 48]
    values = rng.integers(0, 48, (c, s))
    if case == "empty items":
        values = rng.integers(0, 16, (c, s))          # items 2..5 empty
    elif case == "one item":
        values[:] = 13
    elif case == "no items":
        items = [6, 0, 6, 0]
    elif case == "all missing":
        values[:] = -1
    elif case == "no entries":
        values = values[:, :0]
    slot, val, off = _check(values, il.member_info(units, items, lims))
    if case == "one item":
        seg = il.PART_SEG
        assert (slot.numpy()[:, :seg] == np.arange(seg)).all()
        # member 0's offsets of its first segment: one contiguous row
        assert (off.numpy()[1:7] == [0] + [seg] * 5).all()


@pytest.mark.parametrize("items,bins", [
    (256, 256),             # model E's large X1b member: its items
    (4000, 4000),           # more items than a segment's entries
    (79, 79),               # Criteo's K3a tiles
    (5000, 4096),           # past one pass: 12-bit digits
    (3, 3), (0, 1), (9000, 4096)])
def test_digit_bins_cover_every_pass(items, bins):
    """The shared memory a launch takes: no pass of a block's sort uses
    more bins than ``digit_bins`` (one pass of a bin an item up to 4096
    items, 12-bit digits past them)."""
    assert il.digit_bins(items) == bins
    assert min(items, il.PART_MAX_BINS) <= bins <= il.PART_MAX_BINS


def test_partition_of_clamped_ids_and_buckets():
    """The values the wrapper partitions: ids clamped to their caps (an id
    past its cap lands on the cap's row, int32 extremes, missing ids), and
    K3b's buckets of raw values (NaN and +inf at the column's count), as
    ``bucket_ids_plain`` finds them."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-3, 400, (5, 300)).astype(np.int32)
    ids[0, :3] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 350]
    caps = np.asarray([299, 100, 399, 0, 250], np.int32)
    info = tk.k3_member_info(5, 384, 64)
    g = dict(ids=torch.from_numpy(ids), caps=torch.from_numpy(caps),
             info=info)
    (got,) = il.partition([g])
    clamped = np.minimum(ids, caps[:, None])
    for x, want in zip(got, _definition(clamped, info)):
        np.testing.assert_array_equal(x.numpy(), want)
    bmat, cnts, t3, raw = chip_smoke.k2_edge_case(45, 384, 64, 100, seed=5)
    lo, hi, counts = (torch.from_numpy(x) for x in tk.bucket_bounds(
        bmat, cnts, 384, t3.shape[0]))
    info = tk.k3_member_info(45, 384, 64)
    (got,) = il.partition([dict(raw=torch.from_numpy(raw), hi=hi,
                                counts=counts, info=info)])
    buckets = tk.bucket_ids_plain(torch.from_numpy(raw), hi, counts).numpy()
    for x, want in zip(got, _definition(buckets, info)):
        np.testing.assert_array_equal(x.numpy(), want)


@pytest.mark.parametrize("v,d,tiles", [(128, 8, 1), (128, 64, 2),
                                       (2304, 64, 36), (1664, 64, 26),
                                       (384, 32, 3), (101, 3, 1)])
def test_k3_geometry_tiles(v, d, tiles):
    """K3's items: the Criteo DLRM's vocabularies at d = 64 cut into tiles
    of 64 rows (listed), model E's and bucketize-880's one tile of 4
    columns at d = 8 (not listed)."""
    cb, nv, got = tk.k3_geometry(v, d)
    assert got == tiles and tk.k3_listed(v, d) == (tiles > 1)
    assert cb * nv <= min(tk.K3_MAX_KEYS, tk.K3_ACC_FLOATS // d)
    assert (got - 1) * nv < v <= got * nv
    assert cb == 1 or cb * d <= tk.K3_ROW_FLOATS
    info = tk.k3_member_info(3, v, d)
    assert info.tolist() == [[nv, tiles, v, k * (tiles + 1)]
                             for k in range(3)]


@pytest.mark.parametrize("vocab,d,slots", [
    ([10_000] * 3, 8, 2048),                    # model E's small groups
    ([1 << 20, 1 << 19], 32, 2048),             # sparse ranges
    ([300, 200_000, 150_000, 90_000], 8, 192),  # both classes in a group
    ([122_881], 32, 61_440),                    # the exchange's buffer
])
def test_x1b_member_info_numbers_the_plan_items(vocab, d, slots):
    """Each work item of ``x1b_plan`` is item ``local_lo // unit`` of its
    member's rows of the partition (row ``ibase + local_lo // unit``), and
    each member's items are exactly its work items."""
    vocab = np.asarray(vocab, np.int64)
    offs = np.concatenate([[0], np.cumsum(vocab)[:-1]])
    caps = vocab - 1
    r = int(vocab.sum()) + 5
    plan = tg.x1b_plan(r, d, offs, caps, slots)
    info = tg.x1b_member_info(r, d, offs, caps, slots)
    for m in range(len(vocab)):
        unit, items, lim, _ = info[m]
        mine = plan[plan[:, 3] == m]
        assert lim == caps[m] + 1 and len(mine) == items
        assert sorted(mine[:, 1] // unit) == list(range(items))
        assert (mine[:, 1] % unit == 0).all() and (mine[:, 2] <= unit).all()
        sparse = tg.x1b_sparse(int(lim), d, slots)
        assert (mine[:, 4] == int(not sparse)).all()
        assert unit == (tg.x1b_range_rows(int(lim), d, slots) if sparse
                        else tg.x1b_tile_rows(d))


@pytest.mark.parametrize("extent,d,slots,rows", [
    (1 << 23, 32, 24_576, 32_768),      # model E's large lists
    (1_000_000, 64, 2048, 16_384),      # the Criteo DLRM's 1M-row members
    (290_792, 64, 2048, 8192),
    (39_060, 64, 2048, 1024),
    (20_971_520, 32, 122_880, 16_384),  # a (1, 2) stripe's psum partials
    (50_000, 8, 1, 32_768),             # one slot: the widest range
])
def test_x1b_range_rows_fill_one_window(extent, d, slots, rows):
    """A sparse range's rows: the widest power of two up to 32 768 whose
    share of the slots, spread evenly, fills at most one window."""
    assert tg.x1b_range_rows(extent, d, slots) == rows
    assert rows * slots <= tg.x1b_tile_rows(d) * extent or rows == 32
    assert rows == tg.X1B_RANGE_ROWS or \
        2 * rows * slots > tg.x1b_tile_rows(d) * extent


@pytest.mark.parametrize("rows,slots,d,sparse", [
    (122_881, 61_440, 32, False),       # the exchange pool's buffer
    (70_001, 18_000, 8, False),         # a buffer of 70 001 rows
    (20_971_520, 122_880, 32, True),    # the psum partial's stripe
    (50_000, 192, 8, True),             # the owner's scatter, edge case
])
def test_shared_rows_group_is_one_column(rows, slots, d, sparse):
    """A group whose columns share rows becomes one SUM column of one
    member (no member cut per X1B_RANGE_ROWS rows, no copy of the
    cotangent): dense tiles where its rows are at most 4 a slot, else
    sparse ranges."""
    c, ll = 3, slots // (3 * 8)
    bp = 8
    rng = np.random.default_rng(rows % 97)
    ids = torch.from_numpy(rng.integers(-1, rows, (c, bp, ll)).astype(
        np.int32))
    g = torch.from_numpy(rng.standard_normal((bp, c, d)).astype(np.float32))
    zero, no_cap, flags = tg.shared_rows_consts(c, "cpu")
    args = tg.shared_rows_grad_args(g, rows, ids, zero, zero, None, flags,
                                    no_cap)
    dacc, num_rows, ids1, offs = args[:4]
    assert tuple(ids1.shape) == (1, c * bp, ll)
    assert tuple(dacc.shape) == (c * bp, 1, d)
    assert tuple(offs.shape) == (1,) and num_rows == rows
    assert tg.x1b_sparse(rows, d, c * bp * ll) == sparse
    plan = tg.x1b_plan(rows, d, [0], None, c * bp * ll)
    assert set(plan[:, 4][plan[:, 3] >= 0]) == {0 if sparse else 1}


def _onehot_case(seed, c, v, d, b):
    rng = np.random.default_rng(seed)
    c_pad, v_pad = ((c + 7) // 8) * 8, ((v + 127) // 128) * 128
    t3 = np.zeros((c_pad, v_pad, d), np.float32)
    t3[:c, :v] = rng.standard_normal((c, v, d)).astype(np.float32)
    ids = rng.integers(-3, v + 20, (c, b)).astype(np.int32)
    ids[0, ::3] = 2                                  # a hot row
    caps = rng.integers(v // 2, v, c).astype(np.int32)
    g = rng.standard_normal((b, c, d)).astype(np.float32)
    return t3, ids, caps, g


# the Criteo DLRM's one-hot groups at small sizes (a 128-row vocab of 7
# columns and single columns of 2209 and 155), and model E's kind (d = 8)
ONEHOT_GROUPS = ((7, 63, 64), (1, 2209, 64), (1, 155, 64), (13, 101, 8))


def test_onehot_lookups_backward_matches_jax_grad():
    """Several one-hot groups in one call under autograd: each table3's
    gradient == ``jax.grad`` of the JAX package's one-hot lookup of the
    same groups (the sum of the groups' losses), bit for bit."""
    b = 96
    cases = [_onehot_case(10 + k, c, v, d, b)
             for k, (c, v, d) in enumerate(ONEHOT_GROUPS)]

    def jloss(tables):
        total = 0.0
        for t, (t3, ids, caps, g) in zip(tables, cases):
            c_pad, c = t3.shape[0], ids.shape[0]
            ids_t = np.full((c_pad, b), -1, np.int32)
            ids_t[:c] = np.minimum(ids, caps[:, None])
            g_t = np.zeros((c_pad, b, t3.shape[2]), np.float32)
            g_t[:c] = g.transpose(1, 0, 2)
            rows = j_k1(t, jnp.asarray(ids_t), 128, 8, 128, True)
            total = total + (rows * jnp.asarray(g_t)).sum()
        return total

    wants = jax.grad(jloss)([jnp.asarray(t3) for t3, *_ in cases])
    tables = [torch.from_numpy(t3).requires_grad_(True)
              for t3, *_ in cases]
    outs = tk.onehot_lookups([(t, torch.from_numpy(ids),
                               torch.from_numpy(caps))
                              for t, (_, ids, caps, _) in zip(tables, cases)])
    grads = torch.autograd.grad(
        outs, tables, [torch.from_numpy(g) for *_, g in cases])
    for gr, want in zip(grads, wants):
        np.testing.assert_array_equal(gr.numpy(), np.asarray(want))


def test_onehot_lookups_backward_is_one_call(monkeypatch):
    """Autograd through ``onehot_lookups`` calls the K3a wrapper once for
    every group whose table3 needs a gradient (one launch on the card),
    each gradient == that group's plain version."""
    cases = [_onehot_case(20 + k, c, v, d, 40)
             for k, (c, v, d) in enumerate(ONEHOT_GROUPS)]
    calls = []
    real = tk.onehot_lookups_grad

    def spy(groups, lists=None):
        calls.append(len(groups))
        return real(groups, lists)

    monkeypatch.setattr(tk, "onehot_lookups_grad", spy)
    tables = [torch.from_numpy(t3).requires_grad_(k != 1)
              for k, (t3, *_) in enumerate(cases)]
    outs = tk.onehot_lookups([(t, torch.from_numpy(ids),
                               torch.from_numpy(caps))
                              for t, (_, ids, caps, _) in zip(tables, cases)])
    loss = sum((o * torch.from_numpy(g)).sum()
               for o, (*_, g) in zip(outs, cases))
    loss.backward()
    assert calls == [3]
    assert tables[1].grad is None
    for k in (0, 2, 3):
        t3, ids, caps, g = cases[k]
        want = tk.onehot_lookup_grad_plain(
            torch.from_numpy(g), torch.from_numpy(ids),
            torch.from_numpy(caps), *t3.shape[:2])
        np.testing.assert_array_equal(tables[k].grad.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# On a card: the kernel == its plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("items", [1, 40, 961, 5000])
def test_partition_kernel_matches_plain_on_card(cuda, items):
    """Members of 1, 40, 961 (the exchange's tiles) and 5000 items (two
    digit passes), over one and three segments."""
    rng = np.random.default_rng(items)
    c, s = 3, 9000
    units = np.full(c, 7)
    lims = np.full(c, 7 * items - 2)
    values = rng.integers(-2, 7 * items + 3, (c, s)).astype(np.int32)
    values[1, ::5] = 11
    caps = np.full(c, np.iinfo(np.int32).max, np.int32)
    info = il.member_info(units, np.full(c, items), lims)
    g = dict(ids=torch.from_numpy(values), caps=torch.from_numpy(caps),
             info=info)
    want = il.partition([g])
    before = kernels.launches["Part"]
    got = il.partition([{k: v.to(cuda) if isinstance(v, torch.Tensor) else v
                         for k, v in g.items()}])
    torch.cuda.synchronize()
    assert kernels.launches["Part"] == before + 1
    for x, w in zip(got[0], want[0]):
        assert torch.equal(x.cpu(), w)


@pytest.mark.cuda
def test_k3a_groups_in_one_launch_on_card(cuda):
    cases = [_onehot_case(30 + k, c, v, d, 700)
             for k, (c, v, d) in enumerate(ONEHOT_GROUPS)]
    args = [(torch.from_numpy(g), torch.from_numpy(ids),
             torch.from_numpy(caps), *t3.shape[:2])
            for t3, ids, caps, g in cases]
    want = tk.onehot_lookups_grad(args)
    before = kernels.launches["K3a"]
    got = tk.onehot_lookups_grad(
        [tuple(x.to(cuda) if isinstance(x, torch.Tensor) else x for x in a)
         for a in args])
    torch.cuda.synchronize()
    assert kernels.launches["K3a"] == before + 1
    for gr, w in zip(got, want):
        assert torch.equal(gr.cpu().view(torch.int32), w.view(torch.int32))
