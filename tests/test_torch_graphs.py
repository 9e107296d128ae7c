"""The Engine's program per (shape signature, outputs): one captured CUDA
graph each on the card (runtime/graphs.py), the counterpart of the JAX
Engine's jitted program per signature.

On the CPU the Engine runs eagerly; these tests also give it a stand-in
capture (``StandIn``): its eager pass runs the forward, and its "graph"
replays by running the captured forward again on the static inputs and
writing the results into the captured outputs, as a CUDA graph writes its
static outputs.  So the Engine's program path (static inputs, a replay per
request, the clone of a ``fetch=False`` output, updates read through the
live tensors) runs here, held against the JAX Engine (pooled ``==``, the
output at rtol 1e-4 / atol 1e-5, the tower tolerance of
tests/test_engine.py).  The ``cuda`` cases hold the real graphs to the
eager forward bit for bit on the card."""

import threading

import numpy as np
import pytest
import torch

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.models.synthetic import make_microbenchmark_model as j_micro
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.oracle import OracleModel
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig, ServingPipeline
from recom_tpu_torch.models import make_dlrm_model as t_make_dlrm
from recom_tpu_torch.models.synthetic import make_microbenchmark_model as t_micro
from recom_tpu_torch.ops import kernels
from recom_tpu_torch.runtime.checkpoint import export_params
from recom_tpu_torch.runtime.graphs import Program
from recom_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

SHAPE = (6, 2, 2, 2, 1, 4, [8], [16, 1])
BUCKETS = (16, 64)


class StandInGraph:
    """A graph that replays by running ``fn`` again and writing its results
    into ``outputs`` (``fn`` None: a replay queues nothing)."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs, self.replays = fn, outputs, 0

    def replay(self):
        self.replays += 1
        if self.fn is not None:
            for o, n in zip(tree_leaves(self.outputs),
                            tree_leaves(self.fn())):
                o.copy_(n)


class StandIn:
    """A capturer for the CPU: ``warm`` runs the forward; ``capture`` runs
    it once to take its outputs (under ``kernels.recording``, as the card's
    capture does) and returns a ``StandInGraph`` and the launches it holds:
    those the forward made, off by ``off`` ({kernel id: launches the graph
    holds beyond them; less than 0, left out of it})."""

    def __init__(self, replays_run: bool = True, off=None):
        self.replays_run = replays_run
        self.off = off or {}
        self.graphs = []

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        with kernels.recording() as made:
            out = fn()
        held = dict(made)
        for k, n in self.off.items():
            held[k] = held.get(k, 0) + n
        graph = StandInGraph(fn if self.replays_run else None, out)
        self.graphs.append(graph)
        return graph, out, {k: n for k, n in held.items() if n}


def _pair(name="gr", shape=SHAPE, params=None, **cfg):
    """The JAX Engine and the port's CPU Engine, with a stand-in capture,
    of one model on the same params."""
    cfg.setdefault("batch_buckets", BUCKETS)
    jm = j_make_dlrm(*shape, name=name, large_rows=4096)
    tm = t_make_dlrm(*shape, name=name, large_rows=4096)
    params = init_model_params(jm) if params is None else params
    jcfg = dict(cfg)
    if jcfg.get("use_pallas", True):
        jcfg["interpret"] = True
    eng = Engine(tm, EngineConfig(**cfg), params=params, device="cpu")
    eng._capture = StandIn()
    return jm, params, JEngine(jm, JConfig(**jcfg), params=params), eng


def _permuted(batch, seed):
    """The rows of ``batch`` in another order: a batch of the same shape
    signature with other values in each row's place."""
    n = len(next(iter(batch.values())))
    idx = np.random.default_rng(seed).permutation(n)
    return {k: v[idx] if isinstance(v, np.ndarray) else [v[i] for i in idx]
            for k, v in batch.items()}


def _assert_out(out, jout):
    for col, p in jout["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], p, err_msg=col)
    np.testing.assert_allclose(out["output"], jout["output"], rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the program cache: keys and bound
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("captured", [False, True])
def test_programs_keyed_by_signature_and_mode_and_bounded(captured):
    """tests/test_engine.py::test_batch_bucketing_bounds_compiles, extended:
    one program per (signature, sorted outputs), so the batch buckets times
    the output modes bound their number, eager or captured."""
    jm = j_make_dlrm(*SHAPE, name="keys", large_rows=4096)
    tm = t_make_dlrm(*SHAPE, name="keys", large_rows=4096)
    eng = Engine(tm, EngineConfig(batch_buckets=BUCKETS),
                 params=init_model_params(jm), device="cpu")
    if captured:
        eng._capture = StandIn()
    modes = [dict(), dict(return_pooled=True), dict(return_concat=True),
             dict(return_pooled=True, return_concat=True)]
    for i, bs in enumerate((3, 16, 17, 40, 64, 5, 33, 64)):
        eng.predict(make_random_batch(jm, bs, seed=bs), **modes[i % 4])
        eng.predict(make_random_batch(jm, bs, seed=bs + 1), **modes[i % 4])
    keys = list(eng._programs)
    assert len(keys) == len(set(keys)) == eng.stats["compiles"]
    assert eng.stats_report()["programs_compiled"] == eng.stats["compiles"]
    for sig, mode in keys:
        assert sig[0] in BUCKETS and mode == tuple(sorted(mode))
    assert {m for _, m in keys} == {(), ("pooled",), ("concat",),
                                    ("concat", "pooled")}
    assert len(keys) <= len(BUCKETS) * len(modes)
    before = eng.stats["compiles"]
    eng.predict(make_random_batch(jm, 50, seed=9), return_concat=True,
                return_pooled=True)
    assert eng.stats["compiles"] == before
    if captured:
        assert all(isinstance(p, Program) for p in eng._programs.values())
        assert sum(g.replays for g in eng._capture.graphs) == 17 - before
    else:
        assert all(p is None for p in eng._programs.values())


def test_warmup_captures_every_bucket_once():
    jm, _, _, eng = _pair("wu")
    assert eng.warmup() == len(BUCKETS)
    assert eng.warmup() == 0                # replayed, nothing new
    assert [g.replays for g in eng._capture.graphs] == [1, 1]
    assert eng.warmup(batch_sizes=(9,)) == 0
    assert eng.stats["compiles"] == len(eng._programs) == len(BUCKETS)
    bench = eng.benchmark(make_random_batch(jm, 16, seed=1), iters=3,
                          warmup=1)
    assert bench["latency_ms"] > 0
    # benchmark serves the live signature (its rowlens may differ from
    # warmup's empty arrays): at most one program more, then replays
    assert eng.stats["compiles"] <= len(BUCKETS) + 1


# ---------------------------------------------------------------------------
# launch accounting
# ---------------------------------------------------------------------------


class _FakeLib:
    """ctypes library stand-in: every entry point succeeds."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_launch_accounting_replay_adds_recorded_capture_adds_none(
        monkeypatch):
    monkeypatch.setattr(kernels, "library", lambda name: _FakeLib())
    kernels.reset_launches()

    def forward(inputs):
        kernels.launch("K1")
        for _ in range(3):
            kernels.launch("X2")
        return {"output": inputs["blob"].float() * 2}

    host = {"blob": torch.arange(8, dtype=torch.uint8)}
    standin = StandIn(replays_run=False)        # a replay queues nothing
    prog, first = Program.capture(standin, torch.device("cpu"), host,
                                  forward)
    # the eager pass counts; the capture's calls are only recorded
    assert kernels.launches["K1"] == 1 and kernels.launches["X2"] == 3
    assert prog.launches == {"K1": 1, "X2": 3}
    np.testing.assert_array_equal(first["output"].numpy(),
                                  np.arange(8) * 2.0)
    for n in (2, 3):
        prog.load({"blob": torch.full((8,), n, dtype=torch.uint8)})
        prog.replay()
        assert kernels.launches["K1"] == n and kernels.launches["X2"] == 3 * n
    assert standin.graphs[0].replays == 2
    np.testing.assert_array_equal(prog.inputs["blob"].numpy(), [3] * 8)
    # outside a capture a launch counts again; recording nests (the outer
    # one also records the inner one's launches) and restores
    with kernels.recording() as outer:
        with kernels.recording() as inner:
            kernels.launch("X1")
        kernels.launch("X1")
    kernels.launch("X1")
    assert inner == {"X1": 1} and outer == {"X1": 2}
    assert kernels.launches["X1"] == 1
    with pytest.raises(ValueError, match="static inputs"):
        prog.load({"blob": torch.zeros(9, dtype=torch.uint8)})
    kernels.reset_launches()


class _ReadingLib:
    """ctypes library stand-in whose X1b entry point reads the plan arrays
    its launch points at, as the kernel does: the work items (pointer and
    rows) and each group's member rows (the ``X1B_LISTS`` record's info
    pointer).  ``calls`` keeps every call's arguments, ``reads`` what each
    call read."""

    def __init__(self):
        self.calls, self.reads = [], []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(args)
            self.reads.append(self.read(*args))
            return 0
        return entry

    @staticmethod
    def read(desc, ngroups, lists, work, nwork, stream):
        import ctypes

        from recom_tpu_torch.ops import lookup_gather as tg

        info = tg.X1B_LISTS.unpack(lists)[5]
        return (bytes((ctypes.c_int64 * (4 * nwork)).from_address(work)),
                bytes((ctypes.c_int32 * 4).from_address(info)))


class _CallsGraph:
    """A graph that replays the library calls its capture made, with the
    arguments they were made with, pointers and all, as a CUDA graph does."""

    def __init__(self, lib, calls):
        self.lib, self.calls = lib, calls

    def replay(self):
        for args in self.calls:
            self.lib.calls.append(args)
            self.lib.reads.append(self.lib.read(*args))


class _CallsCapture:
    """A capturer whose graph is a ``_CallsGraph`` of its capture's calls."""

    def __init__(self, lib):
        self.lib = lib

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        start = len(self.lib.calls)
        with kernels.recording() as made:
            out = fn()
        return _CallsGraph(self.lib, self.lib.calls[start:]), out, dict(made)


def test_program_keeps_the_cached_plans_its_launches_read(monkeypatch):
    """A captured program holds the cached plan arrays its launches point
    into (X1b's work items, the partition's member rows: bounded caches
    made once per plan, named in ``kernels.launch``'s ``keep``).  After
    the capture the caches are cleared and fresh arrays of the same sizes
    written: each replay still reads the plan it was captured with, and
    once the program goes, nothing holds the arrays."""
    import gc
    import weakref

    from recom_tpu_torch.ops import item_lists
    from recom_tpu_torch.ops import lookup_gather as tg

    lib = _ReadingLib()
    monkeypatch.setattr(kernels, "library", lambda name: lib)
    kernels.reset_launches()
    key = (300, 8, np.asarray([0, 100], np.int64).tobytes(),
           np.asarray([99, 199], np.int64).tobytes(), 2048)
    info = tg._x1b_info_cached(*key)

    def forward(inputs):
        work = tg._x1b_work_on((key,), "cpu")
        info_d = item_lists.info_on(info, "cpu")
        lists = tg.X1B_LISTS.pack(0, 0, 0, 0, 0, info_d.data_ptr())
        kernels.launch("X1b", b"", 1, lists, work.data_ptr(),
                       work.shape[0], 0, keep=[work, info_d])
        return {"output": inputs["blob"].float()}

    tg._x1b_work_on.cache_clear()
    item_lists._info_on.cache_clear()
    prog, _ = Program.capture(_CallsCapture(lib), torch.device("cpu"),
                              {"blob": torch.zeros(4, dtype=torch.uint8)},
                              forward)
    want = lib.reads[-1]
    assert want == (tg.x1b_work([tg.x1b_plan(300, 8, [0, 100], [99, 199],
                                             2048)]).tobytes(),
                    info[0].tobytes())
    held = [tg._x1b_work_on((key,), "cpu"), item_lists.info_on(info, "cpu")]
    assert len(prog.kept) == 2 and all(
        any(k is h for k in prog.kept) for h in held)
    refs = [weakref.ref(t) for t in held]
    del held
    tg._x1b_work_on.cache_clear()
    item_lists._info_on.cache_clear()
    gc.collect()
    junk = [torch.full((n,), -1, dtype=dt) for _ in range(64)
            for n, dt in ((len(want[0]) // 8, torch.int64),
                          (4, torch.int32))]
    for _ in range(2):
        prog.replay()
        assert lib.reads[-1] == want
    assert all(r() is not None for r in refs)
    assert kernels.launches["X1b"] == 1 + 2      # the eager pass, 2 replays
    del prog, junk
    gc.collect()
    assert all(r() is None for r in refs)
    kernels.reset_launches()


@pytest.mark.parametrize("off", [{"X2": -1}, {"K1": -1}, {"X1": 1}])
def test_capture_raises_when_graph_lacks_a_recorded_launch(monkeypatch,
                                                           off):
    """A graph whose kernels are not the launches the forward made while
    it was captured (one left out, launched on another stream, say; or
    one the forward never launched) is refused, and the engine keeps no
    program for it."""
    monkeypatch.setattr(kernels, "library", lambda name: _FakeLib())
    kernels.reset_launches()

    def forward(inputs):
        kernels.launch("K1")
        for _ in range(3):
            kernels.launch("X2")
        return {"output": inputs["blob"].float()}

    host = {"blob": torch.arange(8, dtype=torch.uint8)}
    with pytest.raises(RuntimeError, match="captured graph holds"):
        Program.capture(StandIn(off=off), torch.device("cpu"), host,
                        forward)
    # the engine on the CPU launches no kernel: a graph holding one is
    # refused
    jm, _, _, eng = _pair("off")
    eng._capture = StandIn(off={"X1": 1})
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="captured graph holds"):
        eng.predict(make_random_batch(jm, 16, seed=1))
    assert eng._programs == {} and eng.stats["compiles"] == 0
    kernels.reset_launches()


@pytest.mark.parametrize("name,kid", [
    ("void (anonymous namespace)::onehot_lookup_kernel<int, float4, float4>"
     "(float4 const*, int const*, int const*, float4*, int, int, int, int)",
     "K1"),
    ("void (anonymous namespace)::onehot_lookup_kernel<long, unsigned short, "
     "float>(unsigned short const*, int const*, int const*, float*, long, "
     "long, long, int)", "K1-bf16"),
    ("void (anonymous namespace)::onehot_bucketize_kernel<int, float, "
     "float>(float const*, float const*)", "K2"),
    ("void (anonymous namespace)::onehot_bucketize_kernel<int, uint2, "
     "float4>(uint2 const*, float const*)", "K2-bf16"),
    ("_ZN12_GLOBAL__N_120pooled_gather_kernelILi0EEEvNS_8X1LaunchE", "X1"),
    ("_ZN12_GLOBAL__N_120pooled_gather_kernelILi1EEEvNS_8X1LaunchE",
     "X1-bf16"),
    ("void (anonymous namespace)::pooled_gather_kernel<2>((anonymous "
     "namespace)::X1Launch)", "X1-int8"),
    ("void (anonymous namespace)::hash_rows_kernel<true>(unsigned char "
     "const*, int const*)", "X2"),
    ("void (anonymous namespace)::onehot_grad_kernel<false, float4>(float "
     "const*)", "K3a"),
    ("void (anonymous namespace)::onehot_grad_kernel<true, float>(float "
     "const*)", "K3b"),
    ("void (anonymous namespace)::pooled_gather_grad_kernel((anonymous "
     "namespace)::X1bLaunch, (anonymous namespace)::Work const*)", "X1b"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>>(int, at::native::FillFunctor<float>)",
     None),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", None),
])
def test_kernel_of_names_each_csrc_function(name, kid):
    """How a graph's kernel nodes (mangled) and the profiler's events
    (demangled) are told apart: csrc/'s functions by kernel id, the
    template arguments naming the stored-dtype variant; anything else
    None."""
    assert kernels.kernel_of(name) == kid


# ---------------------------------------------------------------------------
# outputs and updates through the programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [(), ("concat", "pooled")])
def test_fetch_false_output_survives_next_dispatch(mode):
    jm, _, _, eng = _pair("ff")
    a, b = (make_random_batch(jm, 16, seed=s) for s in (1, 2))
    want_a = eng.predict(a, return_pooled="pooled" in mode,
                         return_concat="concat" in mode)  # captures
    pa, pb = eng.prepare(a), eng.prepare(b)
    assert pa.signature == pb.signature
    rec_a = eng.dispatch(pa, mode, fetch=False)
    rec_b = eng.dispatch(pb, mode, fetch=False)
    rec_a.wait()
    np.testing.assert_array_equal(rec_a.outputs["output"].numpy(),
                                  want_a["output"])
    if "concat" in mode:
        np.testing.assert_array_equal(rec_a.outputs["concat"].numpy(),
                                      want_a["concat"])
    assert not np.array_equal(rec_a.outputs["output"].numpy(),
                              rec_b.outputs["output"].numpy())
    np.testing.assert_array_equal(rec_b.outputs["output"].numpy(),
                                  eng.predict(b)["output"])
    assert sum(g.replays for g in eng._capture.graphs) >= 2


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_updates_after_warmup_served_by_next_predict(dtype):
    jm, params, jeng, eng = _pair("upd", table_dtype=dtype)
    batch = make_random_batch(jm, 30, seed=4)
    eng.warmup(batches=[batch])
    eng.predict(batch, return_pooled=True)
    compiles = eng.stats["compiles"]
    ptrs = [t.data_ptr() for t in tree_leaves(eng.device_params)]
    # rows of every table the model has
    rng = np.random.default_rng(0)
    for name, table in params["tables"].items():
        rows = rng.choice(table.shape[0], min(8, table.shape[0]),
                          replace=False)
        vals = rng.standard_normal((rows.size, table.shape[1]))
        eng.update_table_rows(name, rows, vals.astype(np.float32))
        jeng.update_table_rows(name, rows, vals.astype(np.float32))
    out = eng.predict(batch, return_pooled=True)
    _assert_out(out, jeng.predict(batch, return_pooled=True))
    ref = OracleModel(jm, export_params(eng)).forward(batch)
    for col, p in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], p, err_msg=col)
    # a full reload of other params: the next predict serves them
    new = {"tables": {k: v * 0.5 for k, v in params["tables"].items()},
           "tower": params["tower"]}
    eng.reload_params(new)
    fresh = JEngine(jm, JConfig(table_dtype=dtype, batch_buckets=BUCKETS,
                                interpret=True), params=new)
    _assert_out(eng.predict(batch, return_pooled=True),
                fresh.predict(batch, return_pooled=True))
    assert eng.stats["compiles"] == compiles
    assert [t.data_ptr() for t in tree_leaves(eng.device_params)] == ptrs


# ---------------------------------------------------------------------------
# warmed outputs against the JAX Engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    {},
    {"host_bucketize": False},
    {"wire_pack": False},
    {"use_pallas": False, "table_dtype": "bfloat16"},
], ids=["default", "device_bz", "structured", "gather_bf16"])
def test_warmed_outputs_match_jax_engine(cfg):
    jm, _, jeng, eng = _pair("jx", **cfg)
    batches = [make_random_batch(jm, bs, seed=10 + bs) for bs in (16, 40)]
    eng.warmup(batches=batches)
    replays = sum(g.replays for g in eng._capture.graphs)
    for i, b in enumerate(batches):
        out = eng.predict(b, return_pooled=True)     # a new mode: captured
        _assert_out(out, jeng.predict(b, return_pooled=True))
        # replayed on other rows of the same signature, and on b again
        for b2 in (_permuted(b, seed=i), b):
            assert eng.prepare(b2).signature == eng.prepare(b).signature
            jout = jeng.predict(b2, return_pooled=True)
            _assert_out(eng.predict(b2, return_pooled=True), jout)
            np.testing.assert_allclose(eng.predict(b2)["output"],
                                       jout["output"], rtol=1e-4, atol=1e-5)
    assert sum(g.replays for g in eng._capture.graphs) == replays + 8


def test_warmed_micro_k2_path_matches_jax_engine():
    jm = j_micro(12, random_boundary=True)
    tm = t_micro(12, random_boundary=True)
    params = init_model_params(jm)
    cfg = dict(host_bucketize=False, batch_buckets=(32,))
    eng = Engine(tm, EngineConfig(**cfg), params=params, device="cpu")
    eng._capture = StandIn()
    jeng = JEngine(jm, JConfig(interpret=True, **cfg), params=params)
    assert eng.warmup() == 1
    batches = [make_random_batch(jm, 32, seed=seed) for seed in (1, 2)]
    # the live signature (device-hash widths) may differ from the empty
    # arrays' of the bucket
    assert eng.warmup(batches=batches[:1]) in (0, 1)
    replays = sum(g.replays for g in eng._capture.graphs)
    for b in batches:
        out = eng.predict(b)
        np.testing.assert_array_equal(out["output"],
                                      jeng.predict(b)["output"])
    assert sum(g.replays for g in eng._capture.graphs) == replays + 2


# ---------------------------------------------------------------------------
# on the card: the real graphs
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_engine(cuda, name, cfg, model=None):
    jm = j_make_dlrm(*SHAPE, name=name, large_rows=4096)
    tm = model or t_make_dlrm(*SHAPE, name=name, large_rows=4096)
    params = init_model_params(jm) if model is None else None
    return jm, Engine(tm, EngineConfig(**cfg), params=params, device=cuda)


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _eager(eng, prepared, mode):
    with torch.inference_mode():
        out = eng._forward(eng.to_device(prepared), prepared.signature, mode)
    b = prepared.batch_size
    res = {"output": out["output"][:b].cpu().numpy()}
    if "concat" in mode:
        res["concat"] = out["concat"][:b].cpu().numpy()
    if "pooled" in mode:
        res["pooled_groups"] = [p[:b].cpu().numpy()
                                for p in out["pooled_groups"]]
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    {},
    {"host_bucketize": False},
    {"wire_pack": False},
    {"use_pallas": False},
    {"table_dtype": "bfloat16"},
    {"table_dtype": "int8"},
    {"device_hash": False},
    {"dedup_subcolumns": False},
], ids=["default", "device_bz", "structured", "gather", "bf16", "int8",
        "host_hash", "no_dedup"])
def test_replay_equals_eager_bit_for_bit(cuda, cfg):
    from recom_tpu_torch.runtime.graphs import CudaCapture

    jm, eng = _card_engine(cuda, "rq", dict(batch_buckets=BUCKETS, **cfg))
    assert isinstance(eng._capture, CudaCapture)
    mode = ("concat", "pooled")
    sigs = set()

    def held_to_eager(rec, p):
        got = rec.result()
        want = _eager(eng, p, mode)
        for k in ("output", "concat"):
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
        hosts = [h.numpy() for h in rec.host["pooled_groups"]]
        assert len(hosts) == len(want["pooled_groups"])
        for g, w in zip(hosts, want["pooled_groups"]):
            np.testing.assert_array_equal(_bits(g), _bits(w))
        return got

    for bs in (5, 16, 40, 64):
        b = make_random_batch(jm, bs, seed=bs)
        p = eng.prepare(b)
        sigs.add(p.signature)
        first = held_to_eager(eng.dispatch(p, mode), p)   # eager + capture
        kernels.reset_launches()
        rec = eng.dispatch(p, mode)                       # a replay
        assert kernels.launches == {**dict.fromkeys(kernels.launches, 0),
                                    **eng._programs[(p.signature,
                                                     mode)].launches}
        again = held_to_eager(rec, p)
        np.testing.assert_array_equal(_bits(again["output"]),
                                      _bits(first["output"]))
        # other rows in each row's place, same signature: a replay that
        # did not load its inputs, or lacked a kernel whose output buffer
        # still held the capture's values, would serve the first batch
        for seed in (1, 2):
            q = eng.prepare(_permuted(b, seed=100 * bs + seed))
            assert q.signature == p.signature
            moved = held_to_eager(eng.dispatch(q, mode), q)
            assert not np.array_equal(moved["output"], first["output"])
    # one program per signature served (a batch bucket, its rowlen and
    # string-width buckets)
    assert eng.stats["compiles"] == len(eng._programs) == len(sigs)
    assert all(isinstance(p, Program) for p in eng._programs.values())


@pytest.mark.cuda
def test_new_signature_while_pipeline_serves(cuda):
    jm, eng = _card_engine(cuda, "pl", dict(batch_buckets=BUCKETS))
    _, ref = _card_engine(cuda, "pl", dict(batch_buckets=BUCKETS))
    small = [make_random_batch(jm, 16, seed=s) for s in range(8)]
    big = [make_random_batch(jm, 60, seed=100 + s) for s in range(3)]
    eng.warmup(batch_sizes=(16,))
    eng.predict(small[0])
    before = eng.stats["compiles"]
    order = small[:4] + big[:1] + small[4:] + big[1:]
    want = [ref.predict(b)["output"] for b in order]
    got = [None] * len(order)
    with ServingPipeline(eng, prep_workers=2, max_inflight=4) as pipe:
        def submitter(k):
            futs = [(i, pipe.submit(order[i]))
                    for i in range(k, len(order), 2)]
            for i, f in futs:
                got[i] = f.result(timeout=120)

        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.stats["compiles"] == before + 1


@pytest.mark.cuda
def test_update_after_capture_served_by_next_replay(cuda):
    jm, eng = _card_engine(cuda, "up", dict(batch_buckets=BUCKETS))
    params = export_params(eng)
    batch = make_random_batch(jm, 40, seed=3)
    eng.warmup(batches=[batch])
    eng.predict(batch, return_pooled=True)              # captures
    rows = np.arange(16)
    for name, table in params["tables"].items():
        vals = np.full((min(16, table.shape[0]), table.shape[1]), 0.25,
                       np.float32)
        eng.update_table_rows(name, rows[: vals.shape[0]], vals)
        params["tables"][name][rows[: vals.shape[0]]] = vals
    kernels.reset_launches()
    out = eng.predict(batch, return_pooled=True)        # a replay
    assert sum(kernels.launches.values()) > 0
    fresh = Engine(eng.model, EngineConfig(batch_buckets=BUCKETS),
                   params=params, device=cuda)
    want = fresh.predict(batch, return_pooled=True)
    np.testing.assert_array_equal(out["output"], want["output"])
    for col, p in want["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][col], p, err_msg=col)
    half = {"tables": {k: v * 0.5 for k, v in params["tables"].items()},
            "tower": params["tower"]}
    eng.reload_params(half)
    again = eng.predict(batch, return_pooled=True)
    fresh.reload_params(half)
    want = fresh.predict(batch, return_pooled=True)
    np.testing.assert_array_equal(again["output"], want["output"])


@pytest.mark.cuda
def test_warmed_dispatch_makes_no_host_sync(cuda):
    jm, eng = _card_engine(cuda, "sy", dict(batch_buckets=BUCKETS))
    batch = make_random_batch(jm, 64, seed=5)
    eng.warmup(batches=[batch])
    prepared = eng.prepare(batch)
    want = eng.dispatch(prepared).result()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        recs = [eng.dispatch(prepared), eng.dispatch(prepared, fetch=False)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(recs[0].result()["output"], want["output"])
    recs[1].wait()
    np.testing.assert_array_equal(recs[1].outputs["output"].cpu().numpy(),
                                  want["output"])
