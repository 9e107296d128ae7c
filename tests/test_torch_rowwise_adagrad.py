"""Row-wise AdaGrad's kernel O1 (csrc/rowwise_adagrad.cu,
ops/rowwise_adagrad.py) and its routing in ``OptaxOptimizer``.

On the CPU: the rule O1 rests on, held on the plain version (the dense
formula leaves every row whose gradient is +0.0 throughout as it was, bit
for bit, and a row of -0.0 is not such a row); the routing (row-wise
AdaGrad leaves on a card go to O1, an Adam leaf and a leaf split by
columns keep their formulas, the CPU takes the plain version); the
descriptor records and the wrapper's checks, which raise before any
launch.  On a card: O1 against the dense formula on the card, at the
widths of the training paths and at others, every untouched row's p and
acc the same bits, the touched rows too; and the row counter, exact."""

import types

import numpy as np
import pytest
import torch

from recom_tpu_torch.ops import kernels
from recom_tpu_torch.ops import rowwise_adagrad as ra
from recom_tpu_torch.train import OptaxOptimizer

torch.set_num_threads(1)

LR, EPS = 0.01, 1e-10
# (p's shape, a row-wise accumulator): the training paths' widths (model
# E's d 8, 16, 32; the one-hot groups' [C, V, d]), wider rows, widths off
# the 16-byte lanes, a 1-D leaf
SHAPES = [
    ((300, 8), True), ((300, 16), True), ((300, 32), True),
    ((70, 64), True), ((40, 128), True), ((90, 12), True), ((33, 3), True),
    ((50, 200), True), ((5, 24, 16), False), ((3, 7, 12), False),
    ((1000,), False),
]
IDS = ["x".join(map(str, s)) for s, _ in SHAPES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t):
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def _leaf(shape, seed):
    """(p, g, acc) on the CPU: g +0.0 in most rows of the last dimension,
    a row of -0.0 and a row with a single non-zero among them, and p -0.0
    in a row of each kind."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    rows = g.reshape(-1, shape[-1])
    n = rows.shape[0]
    touched = (rng.random(n) < 0.2) | (n == 1)
    rows[~touched] = 0.0
    rows[:, ::3] *= n > 1           # a 1-D leaf: +0.0 in a third of it
    if n > 3:
        rows[1] = -0.0              # touched: -0.0 is not +0.0
        rows[2] = 0.0
        rows[2, -1] = 1e-3          # touched by one element
        rows[3] = 0.0
        prows = p.reshape(-1, shape[-1])
        prows[1] = -0.0
        prows[3] = -0.0
    acc_shape = shape[:1] if len(shape) == 2 else shape
    acc = rng.random(acc_shape).astype(np.float32) * 3
    return tuple(torch.tensor(x) for x in (p, g, acc))


def _touched(g):
    """Rows of the last dimension whose gradient is not +0.0 throughout."""
    rows = g.reshape(-1, g.shape[-1]) if g.dim() else g.reshape(1, 1)
    return (rows.view(torch.int32) != 0).any(dim=1)


def _stepped(p, g, acc, rows=None):
    """Clones of p and acc after the plain version's step over every row,
    or over ``rows`` alone (a bool mask over the rows of the last
    dimension), the others left as they were."""
    p, acc = p.clone(), acc.clone()
    if rows is None:
        ra.rowwise_adagrad_plain(p, g, acc, LR, EPS)
        return p, acc
    d = p.shape[-1]
    p2, g2 = p.view(-1, d), g.view(-1, d)
    if p.dim() == 2:
        sub_p, sub_acc = p2[rows].clone(), acc[rows].clone()
    else:
        sub_p, sub_acc = p2[rows].clone(), acc.view(-1, d)[rows].clone()
        sub_p = sub_p.view(-1, 1, d)
        sub_acc = sub_acc.view(-1, 1, d)
    ra.rowwise_adagrad_plain(sub_p, g2[rows].view(sub_p.shape), sub_acc,
                             LR, EPS)
    p2[rows] = sub_p.view(-1, d)
    if p.dim() == 2:
        acc[rows] = sub_acc
    else:
        acc.view(-1, d)[rows] = sub_acc.view(-1, d)
    return p, acc


# ---------------------------------------------------------------------------
# the rule, on the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,rowwise", SHAPES[:-1], ids=IDS[:-1])
def test_plain_step_over_touched_rows_alone_is_the_dense_step(shape, rowwise):
    """The dense formula over every row and the same formula over the
    touched rows alone give the same bits: the rows whose gradient is +0.0
    throughout keep their p and acc, p = -0.0 included.  The row of -0.0
    gradients is touched: p = -0.0 there becomes +0.0."""
    p, g, acc = _leaf(shape, seed=sum(shape))
    dense_p, dense_acc = _stepped(p, g, acc)
    rows = _touched(g)
    sparse_p, sparse_acc = _stepped(p, g, acc, rows)
    np.testing.assert_array_equal(_bits(sparse_p), _bits(dense_p))
    np.testing.assert_array_equal(_bits(sparse_acc), _bits(dense_acc))
    d = shape[-1]
    np.testing.assert_array_equal(_bits(dense_p.view(-1, d)[~rows]),
                                  _bits(p.view(-1, d)[~rows]))
    assert rows[1] and rows[2] and not bool(rows[3])
    assert (_bits(p.view(-1, d)[1]) == 0x80000000).all()
    assert (_bits(dense_p.view(-1, d)[1]) == 0).all()


def test_a_minus_zero_row_skipped_would_differ_from_the_dense_step():
    """Why -0.0 counts as touched: skipping that row would keep p = -0.0
    where the dense step writes +0.0."""
    p, g, acc = _leaf((300, 16), seed=1)
    dense_p, _ = _stepped(p, g, acc)
    plus_zero_only = (g.view(torch.int32) & 0x7FFFFFFF).ne(0).any(dim=1)
    assert not plus_zero_only[1]
    wrong_p, _ = _stepped(p, g, acc, plus_zero_only)
    assert not np.array_equal(_bits(wrong_p), _bits(dense_p))


def test_plain_version_is_the_formula_each_op_rounded():
    """The plain version is recom_tpu/train.py's rule in f32: numpy's
    f32 arithmetic in the same order gives it within rounding."""
    p, g, acc = _leaf((300, 16), seed=2)
    got_p, got_acc = _stepped(p, g, acc)
    pn, gn, an = p.numpy(), g.numpy(), acc.numpy()
    rows = gn * gn
    mean = rows.sum(axis=1, dtype=np.float64).astype(np.float32)
    mean = (mean * np.float32(1 / 16)).astype(np.float32)
    want_acc = (an + mean).astype(np.float32)
    s = (1 / np.sqrt((want_acc + np.float32(EPS)).astype(np.float64))
         ).astype(np.float32)
    want_p = pn + (np.float32(-LR) * gn) * s[:, None]
    np.testing.assert_allclose(got_acc.numpy(), want_acc, rtol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# routing in OptaxOptimizer
# ---------------------------------------------------------------------------


def _optimizer(column_split=False):
    """A dlrm-style OptaxOptimizer on the CPU: a row-wise AdaGrad group of
    a 2-D, a 3-D and a 1-D leaf, and an Adam group."""
    tables = [torch.randn(40, 8), torch.randn(2, 6, 8), torch.randn(10)]
    tower = [torch.randn(4, 3), torch.randn(3)]
    opt = OptaxOptimizer([
        {"params": tables, "rule": "rowwise_adagrad", "lr": LR,
         "eps": EPS},
        {"params": tower, "rule": "adam", "lr": 1e-3, "b1": 0.9,
         "b2": 0.999, "eps": 1e-8, "eps_root": 0.0},
    ])
    if column_split:
        mesh = types.SimpleNamespace(all_reduce=lambda x, axis: x)
        opt.column_split[id(tables[0])] = (mesh, "model", 8)
    return opt, tables, tower


def _grads(leaves, seed=3):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for p in leaves:
        g = torch.randn(p.shape, generator=gen)
        g.view(-1, p.shape[-1])[::2] = 0.0
        out.append(g)
    return out


def _recording(monkeypatch):
    calls = []
    real = ra.update

    def update(leaves, lr, eps, counts=None):
        calls.append([p for p, _, _ in leaves])
        real(leaves, lr, eps, counts)

    monkeypatch.setattr(ra, "update", update)
    return calls


def test_cpu_leaves_take_the_plain_version_and_no_counter(monkeypatch):
    calls = _recording(monkeypatch)
    opt, tables, tower = _optimizer()
    leaves = tables + tower
    before = [p.clone() for p in leaves]
    grads = _grads(leaves)
    opt.advance()
    opt.apply(grads)
    assert calls == [[]]            # one row-wise group, no leaf on a card
    assert opt.row_counts() is None
    for p, b, g in zip(tables, before, grads):
        acc = torch.zeros(p.shape[:1] if p.dim() == 2 else p.shape)
        want = b.clone()
        ra.rowwise_adagrad_plain(want, g, acc, LR, EPS)
        np.testing.assert_array_equal(_bits(p), _bits(want))


@pytest.mark.parametrize("split", [False, True], ids=["whole", "columns"])
def test_routing_sends_card_leaves_to_o1_and_keeps_the_rest(monkeypatch,
                                                            split):
    """Every row-wise AdaGrad leaf that ``_o1_routed`` takes (a card's,
    here all of them) goes to one ``update`` call for the group; a leaf
    split by columns keeps the dense formula with its all_reduce, and the
    Adam group is never handed to O1.  The results are the plain
    version's either way."""
    calls = _recording(monkeypatch)
    opt, tables, tower = _optimizer(column_split=split)
    ref, ref_tables, ref_tower = _optimizer()
    for a, b in zip(ref_tables + ref_tower, tables + tower):
        a.data.copy_(b)
    monkeypatch.setattr(OptaxOptimizer, "_o1_routed",
                        lambda self, p: id(p) not in self.column_split)
    grads = _grads(tables + tower)
    for o in (opt, ref):
        o.advance()
    opt.apply(grads)
    monkeypatch.undo()
    ref.apply(grads)
    routed = [id(p) for p in calls[0]]
    assert routed == [id(p) for p in tables[int(split):]]
    assert not {id(p) for p in tower} & set(routed)
    for a, b in zip(tables + tower, ref_tables + ref_tower):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_o1_routed_only_on_a_card_and_not_split():
    opt, tables, _ = _optimizer(column_split=True)
    assert not opt._o1_routed(tables[1])                    # the CPU
    card = types.SimpleNamespace(device=torch.device("cuda"))
    assert opt._o1_routed(card)
    opt.column_split[id(card)] = None
    assert not opt._o1_routed(card)


# ---------------------------------------------------------------------------
# descriptors and the wrapper's checks
# ---------------------------------------------------------------------------


def _unpack(desc):
    keys = ("p", "g", "acc", "rows", "d", "chunk0", "chunk_rows", "factor",
            "kind", "lanes", "pad")
    return dict(zip(keys, ra.O1_DESC.unpack(desc)))


@pytest.mark.parametrize("shape,kind,lanes,chunk_rows", [
    ((300, 32), ra.O1_VECTOR, 8, 16),
    ((300, 8), ra.O1_VECTOR, 2, 64),
    ((40, 128), ra.O1_VECTOR, 32, 4),
    ((90, 12), 0, 8, 4),
    ((33, 3), 0, 2, 16),
    ((50, 200), 0, 32, 1),
    ((5, 24, 16), ra.O1_ELEMENTWISE | ra.O1_VECTOR, 4, 32),
    ((3, 7, 12), ra.O1_ELEMENTWISE, 8, 4),
    ((1000,), ra.O1_ELEMENTWISE, 32, 1),
], ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else None)
def test_descriptor_record(shape, kind, lanes, chunk_rows):
    """A leaf's record: its pointers, rows of its last dimension, the
    16-byte lanes for d = 4 ... 128 (else ATen's lanes a row), the rows a
    chunk, and ATen's mean factor for a row-wise leaf."""
    p, g, acc = _leaf(shape, seed=4)
    desc, chunks = ra.o1_leaf(p, g, acc, 7)
    r = _unpack(desc)
    d = shape[-1]
    rows = int(np.prod(shape)) // d
    assert (r["p"], r["g"], r["acc"]) == (p.data_ptr(), g.data_ptr(),
                                          acc.data_ptr())
    assert (r["rows"], r["d"], r["chunk0"]) == (rows, d, 7)
    assert (r["kind"], r["lanes"], r["chunk_rows"]) == (kind, lanes,
                                                        chunk_rows)
    assert chunks == -(-rows // chunk_rows)
    want = (np.float32(rows) / np.float32(rows * d) if len(shape) == 2
            else np.float32(1))
    assert np.float32(r["factor"]) == want
    assert len(desc) == ra.O1_DESC.size == 72


def test_unaligned_rows_take_the_lane_per_element_path():
    base = torch.zeros(300 * 32 + 1)
    p = base[1:].view(300, 32)
    assert p.is_contiguous() and p.data_ptr() % 16
    r = _unpack(ra.o1_leaf(p, torch.zeros(300, 32), torch.zeros(300), 0)[0])
    assert (r["kind"], r["lanes"], r["chunk_rows"]) == (0, 32, 1)


def test_launches_split_at_the_leaf_limit_and_number_chunks():
    """Leaves in runs of O1_MAX_LEAVES, each run's chunks numbered from 0
    in order; an empty leaf is left out."""
    leaves = [_leaf((20 + i, 16), seed=i) for i in range(40)]
    leaves.insert(5, (torch.zeros(0, 16), torch.zeros(0, 16),
                      torch.zeros(0)))
    runs = ra.o1_launches(leaves)
    assert [n for _, n, _ in runs] == [32, 8]
    full = [x for x in leaves if x[0].numel()]
    k = 0
    for recs, n, chunks in runs:
        at = 0
        for j in range(n):
            r = _unpack(recs[j * 72: (j + 1) * 72])
            assert r["chunk0"] == at and r["p"] == full[k][0].data_ptr()
            at += -(-r["rows"] // r["chunk_rows"])
            k += 1
        assert at == chunks
    assert k == 40


@pytest.mark.parametrize("case", ["dtype", "contiguous", "g_shape",
                                  "acc_rowwise", "acc_elementwise",
                                  "device"])
def test_checks_raise_before_any_launch(monkeypatch, case):
    def no_launch(*a, **k):
        raise AssertionError("launched")

    monkeypatch.setattr(kernels, "launch", no_launch)
    p, g, acc = _leaf((30, 16), seed=5)
    if case == "dtype":
        p = p.double()
    elif case == "contiguous":
        g = g.t().contiguous().t()
    elif case == "g_shape":
        g = g[:, :8].contiguous()
    elif case == "acc_rowwise":
        acc = torch.zeros(30, 16)
    elif case == "acc_elementwise":
        p, g = p.view(2, 15, 16), g.view(2, 15, 16)
    elif case == "device":
        acc = torch.zeros(30, device="meta")
    with pytest.raises(ValueError, match="O1"):
        ra.o1_launches([(p, g, acc)])


def test_update_raises_on_mixed_or_unknown_devices(monkeypatch):
    monkeypatch.setattr(kernels, "launch", lambda *a, **k: 1 / 0)
    p, g, acc = _leaf((30, 16), seed=6)
    meta = tuple(t.to("meta") for t in (p, g, acc))
    with pytest.raises(ValueError, match="more than one device"):
        ra.update([(p, g, acc), meta], LR, EPS)
    with pytest.raises(ValueError, match="unsupported device"):
        ra.update([meta], LR, EPS)


def test_o1_is_counted_by_name_and_not_as_lookup_work():
    """The graph's node of O1 is named ``rowwise_adagrad_kernel``: O1 by
    ``kernels.kernel_of``, and none of the benchmark's kernel files'
    patterns (recbench/counts/kernels/), which read the lookups' work."""
    import glob
    import json
    import os
    import re

    name = "(anonymous namespace)::rowwise_adagrad_kernel(O1Launch)"
    assert kernels.kernel_of(name) == "O1"
    files = glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                   "recbench", "counts", "kernels", "*.json"))
    assert files
    for f in files:
        with open(f) as fh:
            assert not re.search(json.load(fh)["pattern"], name), f
    assert kernels.KERNELS["O1"][0] == "rowwise_adagrad"
    assert kernels.LIBRARIES["rowwise_adagrad"] == "rowwise_adagrad.cu"
    assert "O1" in kernels.launches


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _on(cuda, leaf):
    return tuple(t.to(cuda) for t in leaf)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rowwise", SHAPES, ids=IDS)
def test_o1_equals_the_dense_formula_on_the_card(cuda, shape, rowwise):
    """O1 against the dense torch formula on the card: every untouched
    row's p and acc the same bits as before the step; every row the dense
    step's bits where O1 sums a row in ATen's order (d <= 128; elementwise
    leaves have no sum), NaN rows included; elsewhere within rtol 1e-6."""
    p, g, acc = _on(cuda, _leaf(shape, seed=sum(shape) + 1))
    d = shape[-1]
    if g.view(-1, d).shape[0] > 4:
        g.view(-1, d)[4, 0] = float("nan")
    want_p, want_acc = p.clone(), acc.clone()
    ra.rowwise_adagrad_plain(want_p, g, want_acc, LR, EPS)
    got_p, got_acc = p.clone(), acc.clone()
    before = dict(kernels.launches)
    ra.update([(got_p, g, got_acc)], LR, EPS)
    torch.cuda.synchronize()
    assert kernels.launches["O1"] == before["O1"] + 1
    rows = _touched(g)
    np.testing.assert_array_equal(_bits(got_p.view(-1, d)[~rows]),
                                  _bits(p.view(-1, d)[~rows]))
    untouched_acc = acc[~rows] if rowwise else acc.view(-1, d)[~rows]
    kept_acc = got_acc[~rows] if rowwise else got_acc.view(-1, d)[~rows]
    np.testing.assert_array_equal(_bits(kept_acc), _bits(untouched_acc))
    if not rowwise or d <= 128:
        np.testing.assert_array_equal(_bits(got_p), _bits(want_p))
        np.testing.assert_array_equal(_bits(got_acc), _bits(want_acc))
    else:
        np.testing.assert_allclose(got_p.cpu().numpy(), want_p.cpu().numpy(),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(got_acc.cpu().numpy(),
                                   want_acc.cpu().numpy(), rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_row_counts_exact_on_a_known_pattern(cuda):
    """The optimizer's counter after two applies: twice the touched rows
    of each leaf (rows of the last dimension) and twice every row; one
    launch of O1 an apply for the group's leaves, none for Adam's."""
    shapes = [(1000, 32), (300, 8), (4, 50, 16), (70, 12), (17,)]
    tables = [torch.zeros(s, device=cuda) for s in shapes]
    tower = [torch.zeros(4, 3, device=cuda)]
    opt = OptaxOptimizer([
        {"params": tables, "rule": "rowwise_adagrad", "lr": LR, "eps": EPS},
        {"params": tower, "rule": "adam", "lr": 1e-3, "b1": 0.9,
         "b2": 0.999, "eps": 1e-8, "eps_root": 0.0},
    ])
    assert opt.row_counts() == (0, 0)
    grads, touched, seen = [], 0, 0
    for i, p in enumerate(tables):
        g = torch.zeros_like(p)
        rows = g.view(-1, p.shape[-1]) if p.dim() else g.view(1, 1)
        pick = list(range(i, rows.shape[0], 7))
        for r in pick:
            rows[r, r % rows.shape[1]] = 1.0 + r
        touched += len(pick)
        seen += rows.shape[0]
        grads.append(g)
    grads.append(torch.ones(4, 3, device=cuda))
    before = kernels.launches["O1"]
    for _ in range(2):
        opt.advance()
        opt.apply(grads)
    assert kernels.launches["O1"] == before + 2
    assert opt.row_counts() == (2 * touched, 2 * seen)
