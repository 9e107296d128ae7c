"""The port's span recorder (recom_tpu_torch/utils/spans.py) and the spans
the Engine, the Trainer and the ServingPipeline record, on the CPU: off
it records nothing and reads no clock; on, each span has its parent and
its request's or step's number across the pipeline's threads, a
request's spans cover its submit-to-result time, a training step's tree
is its phases, the stamps sit on torch.profiler's clock, and the byte
counters count what is staged and fetched.  The ``cuda`` case times the
captured step's device phases on the card."""

import threading
from collections import deque

import numpy as np
import pytest
import torch

from recom_tpu_torch import Engine, EngineConfig, ServingPipeline, Trainer
from recom_tpu_torch.models import make_dlrm_model, make_random_batch
from recom_tpu_torch.runtime import wire
from recom_tpu_torch.train import dlrm_optimizer
from recom_tpu_torch.utils import spans
from recom_tpu_torch.utils.tree import tree_leaves

SRV = (6, 2, 2, 2, 1, 4, [8], [16, 1])
MINI = (6, 2, 2, 2, 1, 4, [8], [16])
CFG = dict(use_pallas=False, batch_buckets=(32,))
DEVICE_PHASES = ("device.forward", "device.backward", "device.optimizer")


@pytest.fixture
def traced():
    """The recorder on for the test, off after it."""
    spans.enable()
    yield spans
    spans.disable()


def _engine(**kw):
    m = make_dlrm_model(*SRV, name="srv", large_rows=2048)
    return m, Engine(m, EngineConfig(**CFG, **kw), device="cpu")


def _trainer(device="cpu"):
    m = make_dlrm_model(*MINI, name="mini", large_rows=2048)
    return m, Trainer(m, EngineConfig(**CFG), optimizer=dlrm_optimizer(),
                      device=device)


def _labels(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.float32)


def _by_sid(rows):
    return {r["sid"]: r for r in rows}


def _ancestors(row, by_sid):
    out = []
    while row["parent"] is not None:
        row = by_sid[row["parent"]]
        out.append(row["name"])
    return out


def _covered(intervals, lo, hi):
    """The length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    spans.enable()
    spans.disable()                       # forgets older records
    assert not spans.enabled()

    def no_clock():
        raise AssertionError("a clock was read with the recorder off")

    monkeypatch.setattr(spans, "now", no_clock)
    seen = []
    real = wire.prepare_batch_wire

    def watch(*a, **kw):
        seen.append(kw.get("timers"))
        return real(*a, **kw)

    monkeypatch.setattr(wire, "prepare_batch_wire", watch)
    m, eng = _engine()
    b = make_random_batch(m, 20, seed=1)
    eng.predict(b)
    with ServingPipeline(eng, prep_workers=2, max_inflight=2) as pipe:
        pipe.map_stream([b, b])
    tm, tr = _trainer()
    tr.step(make_random_batch(tm, 20, seed=2), _labels(20))
    assert seen and all(t is None for t in seen)   # no prep.* marks
    assert spans.records() == []
    assert eng.stats_report()["stage_latency"] == {}
    assert spans.span("x") is spans.NULL and spans.begin("x") is spans.NULL


def test_stage_latency_is_empty_once_disabled(traced):
    m, eng = _engine()
    eng.predict(make_random_batch(m, 20, seed=1))
    rep = eng.stats_report()["stage_latency"]
    assert {"prepare", "dispatch", "device.forward"} <= set(rep)
    assert set(rep["prepare"]) == {"count", "mean_ms", "p50_ms", "p99_ms"}
    spans.disable()
    assert eng.stats_report()["stage_latency"] == {}
    assert spans.records()                  # still readable


def test_records_are_bounded(traced, monkeypatch):
    monkeypatch.setattr(spans, "_records", deque(maxlen=4))
    for i in range(10):
        with spans.span(f"s{i}"):
            pass
    assert [r["name"] for r in spans.records()] == ["s6", "s7", "s8", "s9"]


# ---------------------------------------------------------------------------
# nesting, parents, ids
# ---------------------------------------------------------------------------

def test_nesting_parents_and_ids(traced):
    with spans.span("a", fresh=True) as a:
        with spans.span("b") as b:
            spans.add("b.sum", 0.001)
        req = spans.begin("req", fresh=True)
    out = {}

    def other():
        with spans.under(req), spans.span("c") as c:
            out["c"] = c.sid
        req.end()

    t = threading.Thread(target=other)
    t.start()
    t.join()
    rows = {r["name"]: r for r in spans.records()}
    assert rows["b"]["parent"] == a.sid and rows["b"]["id"] == a.rid
    assert rows["b.sum"]["parent"] == b.sid and rows["b.sum"]["kind"] == "sum"
    assert rows["a"]["parent"] is None and rows["a"]["id"] is not None
    assert rows["req"]["id"] != a.rid and rows["req"]["parent"] == a.sid
    assert rows["c"]["parent"] == req.sid and rows["c"]["id"] == req.rid
    assert rows["c"]["thread"] != rows["a"]["thread"]
    for r in rows.values():
        assert r["start_ns"] <= r["end_ns"]
    assert rows["a"]["start_ns"] <= rows["b"]["start_ns"] <= \
        rows["b"]["end_ns"] <= rows["a"]["end_ns"]


def test_pipeline_request_spans_cover_submit_to_result(traced):
    m, eng = _engine()
    batches = [make_random_batch(m, 24, seed=40 + i) for i in range(12)]
    eng.predict(batches[0])                  # the signature seen once
    spans.enable()
    lat = []
    with ServingPipeline(eng, prep_workers=3, max_inflight=2) as pipe:
        def client(bs):
            for b in bs:
                t0 = spans.now()
                pipe.submit(b).result()
                lat.append((t0, spans.now()))

        threads = [threading.Thread(target=client, args=(batches[i::2],))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    rows = spans.records()
    by_sid = _by_sid(rows)
    reqs = [r for r in rows if r["name"] == "serve.request"]
    assert len(reqs) == len(batches)
    assert len({r["id"] for r in reqs}) == len(batches)
    for req in reqs:
        mine = [r for r in rows if r["id"] == req["id"] and r is not req]
        names = {r["name"] for r in mine}
        assert {"serve.admit", "serve.queue", "prepare", "dispatch",
                "dispatch.stage", "dispatch.lock", "device.forward",
                "serve.wait", "serve.resolve"} <= names
        # every span of the request descends from it, on whatever thread
        for r in mine:
            assert "serve.request" in _ancestors(r, by_sid)
            assert req["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
                req["end_ns"]
        assert len({r["thread"] for r in mine}) >= 2
        assert by_sid[next(r["parent"] for r in mine
                           if r["name"] == "dispatch.lock")]["name"] == \
            "dispatch"
        # the request's own spans cover nearly all of its interval
        lo, hi = req["start_ns"], req["end_ns"]
        cov = _covered([(r["start_ns"], r["end_ns"]) for r in mine
                        if r["parent"] == req["sid"]], lo, hi)
        assert cov >= 0.9 * (hi - lo), (cov, hi - lo)
    # and the requests lie inside their clients' submit-to-result times
    assert len(lat) == len(batches)
    for req in reqs:
        assert any(t0 <= req["start_ns"] and req["end_ns"] <= t1
                   for t0, t1 in lat)


def test_prepare_holds_the_wire_prep_stages(traced):
    m, eng = _engine()
    eng.prepare(make_random_batch(m, 20, seed=3))
    rows = spans.records()
    prep = next(r for r in rows if r["name"] == "prepare")
    stages = [r for r in rows if r["name"].startswith("prep.")]
    assert stages and all(r["parent"] == prep["sid"] and r["kind"] == "sum"
                          for r in stages)
    assert sum(r["end_ns"] - r["start_ns"] for r in stages) <= \
        prep["end_ns"] - prep["start_ns"]


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _step_tree(rows):
    """{step id: {(name, parent name)}} of the ``step`` spans' trees."""
    by_sid = _by_sid(rows)
    out = {}
    for r in rows:
        if r["name"].startswith("prep."):
            continue
        anc = _ancestors(r, by_sid)
        if r["name"] == "step" or "step" in anc:
            parent = by_sid[r["parent"]]["name"] if r["parent"] else None
            out.setdefault(r["id"], set()).add((r["name"], parent))
    return out


def test_cpu_trainer_step_span_tree(traced):
    m, tr = _trainer()
    for k in range(2):
        tr.step(make_random_batch(m, 20, seed=k), _labels(20, k))
    trees = _step_tree(spans.records())
    assert len(trees) == 2
    for tree in trees.values():
        assert tree == {("step", None), ("prepare", "step"),
                        ("device.forward", "step"),
                        ("device.backward", "step"),
                        ("device.optimizer", "step"),
                        ("step.loss_wait", "step")}
    assert tr.engine.stats["d2h_bytes"] == 2 * 4


class _Graph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        for o, n in zip(tree_leaves(self.out), tree_leaves(self.fn())):
            o.copy_(n)


class _StandIn:
    """A capturer for the CPU: the program path with eager replays."""

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        out = fn()
        return _Graph(fn, out), out, {}


def test_program_step_span_tree_on_the_cpu(traced):
    """The captured step's path (a stand-in capture that replays by running
    the step again): stage, capture or load and replay, the device phases
    as host spans inside them, and the loss read."""
    m, tr = _trainer()
    tr._capture = _StandIn()
    for k in range(3):
        tr.step(make_random_batch(m, 20, seed=k), _labels(20, k))
    trees = list(_step_tree(spans.records()).values())
    assert len(trees) == 3
    phases = {(p, "step.replay") for p in DEVICE_PHASES}
    common = {("step", None), ("prepare", "step"), ("step.stage", "step"),
              ("step.loss_wait", "step")}
    assert trees[0] == common | {("capture", "step")} | {
        (p, "capture") for p in DEVICE_PHASES}
    for tree in trees[1:]:
        assert tree == common | {("step.load", "step"),
                                 ("step.replay", "step")} | phases


# ---------------------------------------------------------------------------
# the clock and the counters
# ---------------------------------------------------------------------------

def test_spans_sit_on_the_profilers_clock():
    """Each span's stamps and its ``record_function`` range's agree: after
    one warm-up span, their median gaps lie within 0.2 ms (a gap of one
    span can hold the thread's preemption, not the clocks' offset)."""
    from torch.profiler import ProfilerActivity, profile

    spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(9):
                with spans.span(f"clock{i}"):
                    sum(range(20_000))
        rows = {r["name"]: r for r in spans.records()}
    finally:
        spans.disable()
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock")}
    assert set(ranges) == set(rows)
    names = [f"clock{i}" for i in range(1, 9)]
    starts = [rows[n]["start_ns"] - ranges[n][0] for n in names]
    ends = [rows[n]["end_ns"] - ranges[n][1] for n in names]
    assert abs(np.median(starts)) < 200_000, starts
    assert abs(np.median(ends)) < 200_000, ends


@pytest.mark.parametrize("wire_pack", [True, False])
def test_byte_counters(wire_pack):
    m, eng = _engine(wire_pack=wire_pack)
    prepared = eng.prepare(make_random_batch(m, 20, seed=5))
    staged = sum(t.nbytes for t in tree_leaves(eng._stage(prepared)[0]))
    assert eng.stats["h2d_bytes"] == eng.stats["d2h_bytes"] == 0
    out = eng.dispatch(prepared, ("pooled",)).result()
    assert eng.stats["h2d_bytes"] == staged
    fetched = out["output"].nbytes + sum(
        p.nbytes for p in eng.dispatch(prepared, ("pooled",)).host[
            "pooled_groups"])
    assert eng.stats["h2d_bytes"] == 2 * staged
    assert eng.stats["d2h_bytes"] == 2 * fetched
    eng.dispatch(prepared, fetch=False)
    assert eng.stats["d2h_bytes"] == 2 * fetched


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_step_device_phases_on_card(cuda, traced):
    """The three event phases of a replayed step are positive and sum to
    within 10% of the step's device time, from events around the replay."""
    from recom_tpu_torch.runtime.graphs import Program

    m, tr = _trainer(cuda)
    batch, lab = make_random_batch(m, 32, seed=1), _labels(32)
    for _ in range(3):
        tr.step(batch, lab)
    real = Program.replay
    timed = []

    def replay(self):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = real(self)
        t1.record()
        timed.append((t0, t1))
        return out

    Program.replay = replay
    try:
        spans.enable()
        for _ in range(5):
            tr.step(batch, lab)
    finally:
        Program.replay = real
    rows = spans.records()
    steps = [r["id"] for r in rows if r["name"] == "step"]
    assert len(steps) == len(timed) == 5
    for sid, (t0, t1) in zip(steps, timed):
        ph = {r["name"]: (r["end_ns"] - r["start_ns"]) / 1e6 for r in rows
              if r["id"] == sid and r["kind"] == "device"}
        assert set(ph) == set(DEVICE_PHASES)
        assert all(v > 0 for v in ph.values()), ph
        whole = t0.elapsed_time(t1)
        assert abs(sum(ph.values()) - whole) <= 0.1 * whole, (ph, whole)
