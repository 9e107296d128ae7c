"""Protocol tests for the port's serving loop (tools/serve_loops.py, after
recom_tpu/tools/serve_loops.py): the two FakeEngine tests of
tests/test_serve_loops.py on ``Engine.dispatch`` and the record's wait,
and the loop on a real Engine on the CPU."""

import numpy as np

from recom_tpu_torch.tools.serve_loops import loop_windows


class FakeEngine:
    """Counts prepares, dispatches and waits; fabricates records."""

    def __init__(self):
        self.prepared = []
        self.executed = []
        self.waited = []

    def prepare(self, b):
        self.prepared.append(b)
        return b

    def dispatch(self, prepared, mode=(), fetch=True):
        self.executed.append(prepared)
        eng = self

        class Record:
            def wait(self):
                eng.waited.append(prepared)

        return Record()


def test_loop_windows_serves_each_batch_exactly_once():
    eng = FakeEngine()
    warm = ["w0", "w1"]
    bats = [f"b{i}" for i in range(23)]
    med, win_ms, req_ms = loop_windows(eng, warm, bats, confirm_every=4,
                                       windows=5)
    # warm batches execute but are NOT timed; each timed batch exactly once
    assert eng.executed[:2] == warm
    served = eng.executed[2:]
    # windows=5 over 23: EVERY batch served exactly once (near-equal
    # windows of 5/4/5/4/5 -- no floor-division tail drop)
    assert served == bats
    assert len(served) == len(set(served))
    assert len(win_ms) == 5 and len(req_ms) == 23
    assert med > 0
    # one wait per confirm group, on its newest dispatch, and one at each
    # window's end for its remainder
    # (windows b0-b4, b5-b8, b9-b13, b14-b17, b18-b22)
    assert eng.waited[:2] == warm
    assert eng.waited[2:] == ["b3", "b4", "b8", "b12", "b13", "b17", "b21",
                              "b22"]


def test_loop_windows_sync_mode_returns_per_request_latencies():
    eng = FakeEngine()
    bats = [f"s{i}" for i in range(7)]
    med, win_ms, req_ms = loop_windows(eng, [], bats, confirm_every=1,
                                       windows=1)
    assert eng.executed == bats
    assert eng.waited == bats          # confirm_every=1: every request
    assert len(req_ms) == 7 and len(win_ms) == 1


def test_loop_windows_factory_on_a_cpu_engine():
    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.models import make_dlrm_model, make_random_batch

    m = make_dlrm_model(2, 1, 1, 1, 0, 2, [4], [8, 1], name="loop")
    eng = Engine(m, EngineConfig(batch_buckets=(16,)), device="cpu")
    made = []

    def factory(k):
        made.append(k)
        return [make_random_batch(m, 16, seed=len(made) * 100 + i)
                for i in range(k)]

    med, win_ms, req_ms = loop_windows(
        eng, [make_random_batch(m, 16, seed=1)], None, confirm_every=3,
        windows=3, factory=factory, total=10)
    assert made == [3, 4, 3] and len(req_ms) == 10 and len(win_ms) == 3
    assert med > 0 and np.isfinite(med)
    assert eng.stats["calls"] == 11
