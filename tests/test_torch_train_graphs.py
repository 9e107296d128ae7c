"""The Trainer's program per shape signature: on the card each signature's
training step is one captured CUDA graph (recom_tpu_torch/train.py,
runtime/graphs.py) -- forward, loss, ``torch.autograd.grad`` and the
optimizer's update in place -- the counterpart of the JAX Trainer's
jitted ``train_step`` per signature (recom_tpu/train.py:123-140).

On the CPU the Trainer steps eagerly; these tests also give it a stand-in
capture (``StepStandIn``) so that the program path runs here.  A capture
runs nothing on the card, so the stand-in's capture, which must run the
step to take its outputs, puts the params and the optimizer state back as
they were; its "graph" replays by running the captured step again on the
static inputs, with each Adam group's host ``count`` held at its value at
capture, as a graph keeps the host values it was captured with.  The
program path is held ``==`` the eager Trainer as bits (losses, params,
optimizer state) and to the JAX Trainer within tests/test_torch_train.py's
tolerances (losses rtol 1e-4; params rtol 1e-4 / atol 1e-6).  The ``cuda``
cases hold the real graphs to the eager step bit for bit on the card."""

import threading
import warnings

import numpy as np
import optax
import pytest
import torch

from recom_tpu import EngineConfig as JConfig
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.runtime.checkpoint import export_params as j_export
from recom_tpu.train import Trainer as JTrainer
from recom_tpu.train import dlrm_optimizer as j_dlrm
from recom_tpu.train import rowwise_adagrad as j_rowwise
from recom_tpu_torch import EngineConfig, Trainer
from recom_tpu_torch.models import make_dlrm_model as t_make_dlrm
from recom_tpu_torch.ops import kernels
from recom_tpu_torch.runtime.checkpoint import export_params
from recom_tpu_torch.runtime.graphs import Program
from recom_tpu_torch.train import adam, dlrm_optimizer, rowwise_adagrad
from recom_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

MINI_E = (6, 2, 2, 2, 1, 4, [8], [16])
BZ = (6, 0, 0, 0, 0, 4, [8], [16])
BUCKETS = (16, 64)
OPTIMIZERS = {
    "adam": (lambda: adam(1e-2), lambda: optax.adam(1e-2)),
    "rowwise_adagrad": (lambda: rowwise_adagrad(0.05),
                        lambda: j_rowwise(0.05)),
    "dlrm_optimizer": (lambda: dlrm_optimizer(0.05, 1e-2),
                       lambda: j_dlrm(0.05, 1e-2)),
}


class StandInGraph:
    """A graph that replays by running the captured step ``fn`` again and
    writing its results into ``outputs``, each Adam group's ``count`` held
    at its value at capture (``frozen``)."""

    def __init__(self, fn, outputs, optimizer):
        self.fn, self.outputs, self.opt = fn, outputs, optimizer
        self.frozen = [g.get("count") for g in optimizer.param_groups]
        self.replays = 0

    def replay(self):
        self.replays += 1
        groups = self.opt.param_groups
        now = [g.get("count") for g in groups]
        for g, c in zip(groups, self.frozen):
            if c is not None:
                g["count"] = c
        try:
            new = self.fn()
        finally:
            for g, c in zip(groups, now):
                if c is not None:
                    g["count"] = c
        for o, n in zip(tree_leaves(self.outputs), tree_leaves(new)):
            o.copy_(n)


class StepStandIn:
    """A capturer of the Trainer ``tr``'s steps on the CPU: ``warm`` runs
    the step; ``capture`` runs it once more for its outputs (under
    ``kernels.recording``, as the card's capture does) and then, unless
    ``restore`` is False, writes back the params and optimizer state it
    found, since a real capture runs nothing."""

    def __init__(self, tr, restore: bool = True):
        self.tr, self.restore = tr, restore
        self.warms = 0
        self.graphs = []

    def _tensors(self):
        return (tree_leaves(self.tr.params)
                + [t for t in self.tr.optimizer.state_tensors()
                   if isinstance(t, torch.Tensor)])

    def warm(self, fn):
        self.warms += 1
        return fn()

    def capture(self, fn):
        tensors = self._tensors()
        before = [t.detach().clone() for t in tensors]
        with kernels.recording() as made:
            out = fn()
        if self.restore:
            with torch.no_grad():
                for t, b in zip(tensors, before):
                    t.copy_(b)
        graph = StandInGraph(fn, out, self.tr.optimizer)
        self.graphs.append(graph)
        return graph, out, dict(made)


def _labels(n, seed):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.float32)


def _trainers(opt="dlrm_optimizer", shape=MINI_E, cfg=None, jax=True,
              restore=True):
    """(JAX model, JAX Trainer or None, the port's eager CPU Trainer, the
    port's CPU Trainer with a stand-in capture), all on the same params."""
    cfg = dict(cfg or {}, batch_buckets=BUCKETS)
    jm = j_make_dlrm(*shape, name="mini", large_rows=20_000)
    tm = t_make_dlrm(*shape, name="mini", large_rows=20_000)
    t_opt, j_opt = OPTIMIZERS[opt]
    jtr = JTrainer(jm, JConfig(**cfg), optimizer=j_opt())
    params = j_export(jtr.engine)
    eager, graphed = (Trainer(tm, EngineConfig(**cfg), optimizer=t_opt(),
                              params=params, device="cpu")
                      for _ in range(2))
    graphed._capture = StepStandIn(graphed, restore=restore)
    return jm, (jtr if jax else None), eager, graphed


def _steps(jm, sizes=(10, 50), steps=3):
    """(batch, labels) of ``steps`` steps at each batch size: one signature
    each (the rows of each size's first batch in other orders)."""
    out = []
    for bs in sizes:
        base = make_random_batch(jm, bs, seed=bs)
        for k in range(steps):
            idx = np.random.default_rng(100 * bs + k).permutation(bs)
            b = {f: v[idx] if isinstance(v, np.ndarray) else
                 [v[i] for i in idx] for f, v in base.items()}
            out.append((b, _labels(bs, 10 * bs + k)))
    return out


def _bits(t):
    return t.detach().numpy().view(np.uint32)


def _storage(tr):
    """The data pointer of each param and optimizer state tensor."""
    return [t.data_ptr() for t in tree_leaves(tr.params)
            + [t for t in tr.optimizer.state_tensors()
               if isinstance(t, torch.Tensor)]]


def _assert_same_state(a, b):
    """Every param and every optimizer state leaf of Trainers ``a`` and
    ``b`` the same bits; every Adam count the same."""
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    sa, sb = a.optimizer.state_tensors(), b.optimizer.state_tensors()
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(_bits(x), _bits(y))
        else:
            assert x == y


# ---------------------------------------------------------------------------
# the program cache: keys, bound, the first step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("captured", [False, True])
def test_programs_keyed_by_signature_and_bounded_by_buckets(captured):
    """One program per (signature, "train"): each signature's batch size is
    a bucket, and a signature seen before makes none, so the buckets (with
    the rowlen and string-width buckets a signature holds) bound their
    number; captured (the stand-in, as on one card) or eager (the CPU, a
    mesh: each key maps to None)."""
    jm, _, eager, graphed = _trainers(jax=False)
    tr = graphed if captured else eager
    batches = [(make_random_batch(jm, bs, seed=bs), _labels(bs, i))
               for i, bs in enumerate((3, 16, 17, 40, 64, 5, 33, 64, 9))]
    for b, lab in batches:
        tr.step(b, lab)
    keys = list(tr._programs)
    assert len(keys) == len(set(keys))
    assert {sig[0] for sig, _ in keys} == set(BUCKETS)
    assert all(kind == "train" for _, kind in keys)
    assert {(tr.engine.prepare(b).signature, "train")
            for b, _ in batches} == set(keys)
    for b, lab in batches:
        tr.step(b, lab)
    assert list(tr._programs) == keys
    if captured:
        assert all(isinstance(p, Program) for p in tr._programs.values())
        assert tr._capture.warms == len(keys)
        assert sum(g.replays for g in tr._capture.graphs) == \
            2 * len(batches) - len(keys)
        # the serving programs are the Engine's own, apart from these
        assert tr.engine._programs == {}
    else:
        assert all(p is None for p in tr._programs.values())


def test_first_step_of_a_signature_runs_eagerly_and_capture_runs_nothing():
    """The first step of a signature is the eager pass's (its loss and
    update are the eager Trainer's); the capture after it leaves params and
    state as they were; a stand-in that does not put them back steps twice,
    and the comparison with the eager Trainer fails."""
    jm, _, eager, graphed = _trainers(jax=False)
    (b, lab), = _steps(jm, sizes=(10,), steps=1)
    assert graphed.step(b, lab) == eager.step(b, lab)
    assert graphed._capture.warms == 1 and len(graphed._capture.graphs) == 1
    assert graphed._capture.graphs[0].replays == 0
    _assert_same_state(graphed, eager)
    _, _, eager2, twice = _trainers(jax=False, restore=False)
    assert twice.step(b, lab) == eager2.step(b, lab)
    with pytest.raises(AssertionError):
        _assert_same_state(twice, eager2)


# ---------------------------------------------------------------------------
# the program path against the eager Trainer and the JAX Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_program_steps_equal_eager_and_match_jax(opt):
    """Three steps at each of two buckets (a capture, then two replays on
    other rows): every loss, param and optimizer state leaf `==` the eager
    Trainer's as bits, and within tolerance of the JAX Trainer's."""
    jm, jtr, eager, graphed = _trainers(opt)
    steps = _steps(jm)
    ptrs = _storage(graphed)
    got = [graphed.step(b, lab) for b, lab in steps]
    want = [eager.step(b, lab) for b, lab in steps]
    assert np.asarray(got, np.float64).tobytes() == \
        np.asarray(want, np.float64).tobytes()
    _assert_same_state(graphed, eager)
    # a graph reads and writes the tensors it was captured on: the step
    # writes every param and state tensor in place
    assert _storage(graphed) == ptrs
    assert sum(g.replays for g in graphed._capture.graphs) == 4
    jl = [jtr.step(b, lab) for b, lab in steps]
    np.testing.assert_allclose(got, jl, rtol=1e-4)
    tp, jp = export_params(graphed.engine), j_export(jtr.engine)
    for name, t in jp["tables"].items():
        np.testing.assert_allclose(tp["tables"][name], t, rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    for key, layers in jp["tower"].items():
        for i, layer in enumerate(layers):
            for wb in ("w", "b"):
                np.testing.assert_allclose(
                    tp["tower"][key][i][wb], layer[wb], rtol=1e-4,
                    atol=1e-6, err_msg=f"tower {key}[{i}].{wb}")


def test_program_steps_on_the_device_bucketize_path_equal_eager():
    """The K2 / K3b path (host_bucketize=False) through the programs."""
    jm, _, eager, graphed = _trainers(shape=BZ, jax=False,
                                      cfg={"host_bucketize": False})
    assert any(graphed.engine._fused_bucketize(g)
               for g in graphed.engine.compiled.groups)
    steps = _steps(jm)
    assert [graphed.step(b, lab) for b, lab in steps] == \
        [eager.step(b, lab) for b, lab in steps]
    _assert_same_state(graphed, eager)


def test_adam_step_scalars_reloaded_before_each_replay(monkeypatch):
    """Adam's bias corrections are the program's input, loaded before each
    replay from the host count: the static scalars hold the last step's,
    and a program whose scalars stay those of the step it was captured at
    (a mutant of ``step_scalars``) no longer equals the eager Trainer."""
    from recom_tpu_torch.train import OptaxOptimizer

    jm, _, eager, graphed = _trainers("adam", jax=False)
    steps = _steps(jm, sizes=(10,))
    for b, lab in steps:
        assert graphed.step(b, lab) == eager.step(b, lab)
    _assert_same_state(graphed, eager)
    prog, = graphed._programs.values()
    assert graphed.optimizer.param_groups[0]["count"] == 3
    np.testing.assert_array_equal(
        prog.inputs["scalars"].numpy(),
        graphed.optimizer.step_scalars(torch.device("cpu")))
    np.testing.assert_array_equal(
        prog.inputs["scalars"].numpy(),
        [np.float32(1 - 0.9 ** 3), np.float32(1 - 0.999 ** 3)])

    real = OptaxOptimizer.step_scalars
    first = {}

    def baked(self, device):
        return first.setdefault(id(self), real(self, device))

    monkeypatch.setattr(OptaxOptimizer, "step_scalars", baked)
    _, _, eager, graphed = _trainers("adam", jax=False)
    for b, lab in steps:
        graphed.step(b, lab)
        eager.step(b, lab)
    with pytest.raises(AssertionError):
        _assert_same_state(graphed, eager)


@pytest.mark.parametrize("opt", ["adam", "dlrm_optimizer"])
def test_state_load_and_reload_params_after_capture_reach_the_replay(opt):
    """``load_global_state_leaves`` and ``Engine.reload_params`` after a
    capture write every tensor in place (each keeps its storage), and the
    next replay steps from what they wrote: `==` an eager Trainer given the
    same params and state."""
    jm, _, eager, graphed = _trainers(opt, jax=False)
    steps = _steps(jm, sizes=(10,))
    for b, lab in steps[:2]:
        graphed.step(b, lab)                    # capture, replay
        eager.step(b, lab)
    ptrs = _storage(graphed)
    rng = np.random.default_rng(5)
    leaves = [x + rng.standard_normal(x.shape).astype(x.dtype) ** 2
              if x.dtype == np.float32 else x + 4
              for x in graphed.global_state_leaves()]
    params = export_params(graphed.engine)
    params = {"tables": {k: v * 0.5 for k, v in params["tables"].items()},
              "tower": params["tower"]}
    for tr in (graphed, eager):
        tr.load_global_state_leaves(leaves)
        tr.engine.reload_params(params)
    assert _storage(graphed) == ptrs
    b, lab = steps[2]
    replays = sum(g.replays for g in graphed._capture.graphs)
    assert graphed.step(b, lab) == eager.step(b, lab)
    assert sum(g.replays for g in graphed._capture.graphs) == replays + 1
    _assert_same_state(graphed, eager)


def test_load_state_leaves_raises_before_writing_on_a_wrong_shape():
    _, _, eager, _ = _trainers("adam", jax=False)
    leaves = eager.optimizer.state_leaves()
    before = [x.copy() for x in leaves]
    bad = [x + 1 for x in leaves[:-1]] + [np.zeros((3, 3), np.float32)]
    with pytest.raises(ValueError, match="shape"):
        eager.optimizer.load_state_leaves(bad)
    for x, y in zip(eager.optimizer.state_leaves(), before):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# launch accounting across threads
# ---------------------------------------------------------------------------


class _FakeLib:
    """ctypes library stand-in: every entry point succeeds."""

    def __getattr__(self, name):
        return lambda *args: 0


class _Stream:
    """What ``kernels.recording`` reads of a capturing torch.cuda.Stream."""

    def __init__(self, handle):
        self.cuda_stream = handle


def test_launches_on_another_thread_during_a_capture_are_recorded(
        monkeypatch):
    """Autograd runs a captured backward on its own device thread: a
    launch queued on the capturing stream from any thread is recorded by
    the capture, not counted; a launch on another stream counts; after the
    capture, launches count again."""
    monkeypatch.setattr(kernels, "library", lambda name: _FakeLib())
    kernels.reset_launches()
    capturing, other = 0x5000, 0x6000

    def backward(stream):
        kernels.launch("K3a", 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, stream)
        kernels.launch("X1b", b"", 1, 0, 1, stream)

    def on_thread(stream):
        th = threading.Thread(target=backward, args=(stream,))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()

    with kernels.recording(_Stream(capturing)) as recorded:
        kernels.launch("K1", 0, 0, 0, 0, 1, 1, 1, 1, capturing)
        on_thread(capturing)
        on_thread(other)
    assert recorded == {"K1": 1, "K3a": 1, "X1b": 1}
    assert kernels.launches["K3a"] == kernels.launches["X1b"] == 1
    assert kernels.launches["K1"] == 0
    on_thread(capturing)
    assert kernels.launches["K3a"] == kernels.launches["X1b"] == 2
    kernels.reset_launches()


# ---------------------------------------------------------------------------
# on the card: the real graphs
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_pair(cuda, shape, cfg, opt="dlrm_optimizer"):
    """(JAX model, an eager Trainer and a captured one on the card, on the
    same params)."""
    cfg = dict(cfg, batch_buckets=BUCKETS)
    jm = j_make_dlrm(*shape, name="mini", large_rows=20_000)
    tm = t_make_dlrm(*shape, name="mini", large_rows=20_000)
    params = j_export(JTrainer(jm, JConfig(**cfg)).engine)
    t_opt, _ = OPTIMIZERS[opt]
    eager, graphed = (Trainer(tm, EngineConfig(**cfg), optimizer=t_opt(),
                              params=params, device=cuda)
                      for _ in range(2))
    eager._capture = None
    return jm, eager, graphed


def _card_bits(t):
    return t.detach().cpu().numpy().view(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cfg,opt", [
    (MINI_E, {}, "dlrm_optimizer"),
    (MINI_E, {}, "adam"),
    (BZ, {"host_bucketize": False}, "dlrm_optimizer"),
], ids=["k3a", "k3a_adam", "k3b"])
def test_replayed_step_equals_eager_bit_for_bit(cuda, shape, cfg, opt):
    from recom_tpu_torch.runtime.graphs import CudaCapture, graph_launches

    jm, eager, graphed = _card_pair(cuda, shape, cfg, opt)
    assert isinstance(graphed._capture, CudaCapture)
    assert graphed._capture is not graphed.engine._capture
    # the bucketize model has no gather group, so no X1b
    backward = ("K3b",) if cfg else ("K3a", "X1b")
    for b, lab in _steps(jm):
        kernels.reset_launches()
        got = graphed.step(b, lab)
        counts = dict(kernels.launches)
        assert got == eager.step(b, lab)
        prog = graphed._programs[(graphed.engine.prepare(b).signature,
                                  "train")]
        # the graph's kernel nodes are the step's launches, the backward
        # kernels too, and each step counts them once
        assert graph_launches(prog.graph.raw_cuda_graph()) == prog.launches
        assert all(prog.launches.get(k) == 1 for k in backward)
        assert {k: n for k, n in counts.items() if n} == prog.launches
    assert len(graphed._programs) == 2
    for x, y in zip(tree_leaves(graphed.params), tree_leaves(eager.params)):
        np.testing.assert_array_equal(_card_bits(x), _card_bits(y))
    for x, y in zip(graphed.optimizer.state_tensors(),
                    eager.optimizer.state_tensors()):
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(_card_bits(x), _card_bits(y))
        else:
            assert x == y


def _overwrite_freed(streams):
    """-1 over every free block of the caching allocator's small pool on
    each of ``streams`` (512-byte tensors until the pool reserves a new
    segment); the tensors, to hold while it must stay so."""
    stat = "reserved_bytes.small_pool.current"
    junk = []
    for stream in streams:
        with torch.cuda.stream(stream):
            before = torch.cuda.memory_stats()[stat]
            for k in range(1, 1 << 20):
                junk.append(torch.full((128,), -1, dtype=torch.int32,
                                       device="cuda"))
                if k % 256 == 0 and torch.cuda.memory_stats()[stat] > before:
                    break
    torch.cuda.synchronize()
    return junk


@pytest.mark.cuda
def test_replays_outlive_the_evicted_plan_caches(cuda):
    """The cached plan arrays a captured step's launches read (X1b's work
    items, the partition's member rows) are held by its program: with the
    caches cleared after the capture and the memory they free overwritten,
    the replayed steps still equal the eager ones bit for bit."""
    import gc

    from recom_tpu_torch.ops import item_lists, lookup_gather

    jm, eager, graphed = _card_pair(cuda, MINI_E, {})
    steps = _steps(jm, sizes=(50,))
    want = [eager.step(b, lab) for b, lab in steps]
    got = [graphed.step(*steps[0])]
    prog = graphed._programs[(graphed.engine.prepare(steps[0][0]).signature,
                              "train")]
    assert prog.launches.get("X1b") == 1 and len(prog.kept) >= 2
    lookup_gather._x1b_work_on.cache_clear()
    item_lists._info_on.cache_clear()
    gc.collect()
    junk = _overwrite_freed([torch.cuda.current_stream(),
                             graphed._capture.stream])
    got += [graphed.step(b, lab) for b, lab in steps[1:]]
    assert got == want
    for x, y in zip(tree_leaves(graphed.params), tree_leaves(eager.params)):
        np.testing.assert_array_equal(_card_bits(x), _card_bits(y))
    del junk


@pytest.mark.cuda
def test_warmed_step_syncs_only_to_read_the_loss(cuda):
    jm, _, graphed = _card_pair(cuda, MINI_E, {})
    (b, lab), (b2, lab2) = _steps(jm, sizes=(50,), steps=2)
    graphed.step(b, lab)                       # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            loss = graphed.step(b2, lab2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert np.isfinite(loss)
