"""Dynamic micro-batching: coalesce small serving requests into one
device batch.  A copy of recom_tpu/runtime/batcher.py: numpy and
``engine.predict`` only.

Production recsys traffic arrives as many small requests (one user's
candidate list per RPC), but the card wants large batches: the tower's
products and each request's fixed dispatch cost amortize over rows (the
premise of the reference's batch-latency sweep, AE/build_and_run.py:57-71).
The shape-bucket ladder makes coalescing natural here: merged requests pad
to the same bucket a native big batch would, so no new programs compile.

    mb = MicroBatcher(engine, max_delay_ms=2.0)
    fut = mb.submit({"f": np.array([...]), ...})   # one small request
    rows = fut.result()                            # [n_request_rows, out]

Semantics: row-wise ops (lookups, pooling, tower matmuls) are
batch-size-invariant, so a coalesced request's rows are BIT-identical to
serving it alone (tested), also where the two pad to different buckets:
the port's Engine runs every row-wise product on fixed row chunks
(runtime/executor.py ``row_linear``).  Requests flush when the pending
group reaches ``max_batch`` rows or the oldest request has waited
``max_delay_ms``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np


def _request_rows(model, request: Dict) -> int:
    for col in model.columns:
        if col.source.field and col.source.field in request:
            return len(request[col.source.field])
        for f in col.source.fields or ():
            if f in request:
                return len(request[f])
    raise ValueError("cannot infer request size from request dict")


def _merge_field(vals: List):
    if all(isinstance(v, np.ndarray) for v in vals):
        return np.concatenate(vals, axis=0)
    out: List = []
    for v in vals:
        out.extend(v.tolist() if isinstance(v, np.ndarray) else list(v))
    return out


def merge_requests(requests: List[Dict]) -> Dict:
    """Concatenate feature dicts row-wise.  Every request must carry the
    same field set (a missing field would silently serve zeros for some
    rows — refuse instead)."""
    keys = set(requests[0])
    for r in requests[1:]:
        if set(r) != keys:
            raise ValueError(
                f"requests disagree on fields: {sorted(keys)} vs "
                f"{sorted(set(r))}"
            )
    return {k: _merge_field([r[k] for r in requests]) for k in keys}


class MicroBatcher:
    def __init__(
        self,
        engine,
        max_batch: Optional[int] = None,
        max_delay_ms: float = 2.0,
    ):
        """``max_batch``: flush threshold in rows (default: the engine's
        largest batch bucket).  ``max_delay_ms``: the oldest pending
        request never waits longer than this before its group flushes —
        the latency/throughput knob (TF-Serving/Triton-style dynamic
        batching)."""
        self.engine = engine
        self.max_batch = int(
            max_batch or max(engine.config.batch_buckets)
        )
        self.max_delay = max_delay_ms / 1e3
        self._lock = threading.Lock()
        self._pending: List = []        # (request, n_rows, Future)
        self._pending_rows = 0
        self._oldest = 0.0
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self.stats = {"requests": 0, "flushes": 0, "rows": 0}
        self._runner = threading.Thread(
            target=self._loop, name="recom-microbatch", daemon=True
        )
        self._runner.start()

    def submit(self, request: Dict) -> "Future[np.ndarray]":
        """Returns a Future of this request's output rows [n, out_dim]."""
        n = _request_rows(self.engine.model, request)
        fut: "Future[np.ndarray]" = Future()
        with self._wake:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if not self._pending:
                self._oldest = time.perf_counter()
            self._pending.append((request, n, fut))
            self._pending_rows += n
            self.stats["requests"] += 1
            self.stats["rows"] += n
            self._wake.notify()
        return fut

    def _take_group(self):
        """Under the lock: pop a flushable prefix, or None to keep
        waiting.  Flush when rows >= max_batch (taking whole requests up
        to the threshold) or the oldest request exceeded max_delay."""
        if not self._pending:
            return None
        now = time.perf_counter()
        if (
            self._pending_rows < self.max_batch
            and now - self._oldest < self.max_delay
            and not self._closed
        ):
            return None
        group: List = []
        rows = 0
        while self._pending:
            req, n, fut = self._pending[0]
            if group and rows + n > self.max_batch:
                break
            group.append((req, n, fut))
            rows += n
            self._pending.pop(0)
        self._pending_rows -= rows
        if self._pending:
            self._oldest = now
        return group

    def _loop(self):
        while True:
            with self._wake:
                group = self._take_group()
                if group is None:
                    if self._closed and not self._pending:
                        return
                    timeout = None
                    if self._pending:
                        timeout = max(
                            1e-4,
                            self._oldest + self.max_delay
                            - time.perf_counter(),
                        )
                    self._wake.wait(timeout=timeout)
                    continue
            self._serve_group(group)

    def _serve_group(self, group):
        try:
            merged = merge_requests([req for req, _, _ in group])
            out = np.asarray(self.engine.predict(merged)["output"])
            self.stats["flushes"] += 1
            off = 0
            for _, n, fut in group:
                fut.set_result(out[off : off + n])
                off += n
        except Exception as e:
            for _, _, fut in group:
                if not fut.done():
                    fut.set_exception(e)

    def close(self):
        with self._wake:
            self._closed = True
            self._wake.notify()
        self._runner.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
