"""Pipelined serving: overlap host preprocessing with device execution.

The port of recom_tpu/runtime/server.py.  A thread pool runs host prep
(numpy and the native C++ hash loops, which release the GIL) and queues each
batch's forward with ``Engine.dispatch``, which returns before the card
finishes (inputs staged in pinned memory, outputs copied back into pinned
memory by non-blocking copies, an event after them).  So the card runs
request k while the host packs request k+1.

    pipe = ServingPipeline(engine, prep_workers=4)
    futs = [pipe.submit(b) for b in batches]
    outs = [f.result() for f in futs]     # np arrays, sliced to true batch

``max_inflight`` bounds device-queue depth (memory + tail-latency control:
an unbounded queue turns p99 into queue depth x step time).

On a mesh every rank runs the same pipeline and submits the same batches
in the same order.  Each forward's collectives pair with the other ranks'
in dispatch order, so a rank that dispatched batch k+1 before batch k
would pair its collectives with another rank's batch k: wrong results, or
a hang.  So on a mesh each request takes a ticket when it is submitted,
and its worker dispatches only in its ticket's turn; prep still runs in
parallel.  A mesh request that fails is not retried: a retry would enter
the collective order at a place the other ranks cannot know.
``_resolve_overflow`` applies ``a2a_overflow_policy`` as
recom_tpu/runtime/server.py:182-234 does (the "recompute" forward itself
runs inside ``Engine.dispatch``, in its turn).

Left out of the reference: the completer's adaptive linger on the cost of
its waits (server.py:134-146), which exists for a remote device's RPC
waits.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional

import numpy as np


class ServingPipeline:
    def __init__(
        self,
        engine,
        prep_workers: int = 4,
        max_inflight: int = 4,
        fetch_outputs: bool = True,
        retries: int = 1,
    ):
        """``fetch_outputs=False`` leaves each result on the device (the
        ``[batch, out]`` output tensor, resolved once its forward is done),
        for a next stage that consumes device-resident outputs.

        ``retries``: each failed request (prep, a kernel that fails to build
        or launch, an error the device reports) is retried up to this many
        times before its Future carries the exception; retry counts land in
        ``stats["retries"]``.  No error becomes a ``None`` result.

        Completion is BATCHED: prep workers dispatch and hand the in-flight
        records to one completer thread, which drains every record queued
        so far, waits once on the newest one's event (the forwards and
        copies all run on the one current stream, so it covers the earlier
        ones) and resolves their futures in FIFO order."""
        self.engine = engine
        self.fetch_outputs = fetch_outputs
        self.retries = max(0, int(retries))
        # ADMISSION CONTROL for host prep: more concurrent preps than the
        # host has cores thrash instead of overlapping (host prep is many
        # short native calls that bounce the GIL; the reference measured
        # the collapse on its serving hosts, server.py:59-72).  Cap the
        # pool at cores + 1: N CPU-bound preps + one overlapping the
        # GIL-releasing dispatch and waits.  Extra submissions queue in the
        # pool, so offered load beyond the knee plateaus.
        cores = os.cpu_count() or 1
        try:
            cores = len(os.sched_getaffinity(0)) or cores
        except (AttributeError, OSError):
            pass
        self.effective_prep_workers = max(1, min(prep_workers, cores + 1))
        self._pool = ThreadPoolExecutor(
            max_workers=self.effective_prep_workers,
            thread_name_prefix="recom-prep",
        )
        self._inflight = threading.Semaphore(max_inflight)
        # dispatch turns on a mesh: the ticket a submit takes, and the
        # ticket whose turn it is
        self._mesh = getattr(engine, "mesh", None) is not None
        self._turn = threading.Condition()
        self._tickets = [0, 0]
        self._stats_lock = threading.Lock()
        self.stats = {"submitted": 0, "completed": 0, "retries": 0}
        self._done_q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._completer = threading.Thread(
            target=self._complete_loop, name="recom-complete", daemon=True
        )
        self._completer.start()

    def _bump(self, key: str):
        with self._stats_lock:
            self.stats[key] += 1

    # ------------------------------------------------------------------
    def _complete_loop(self):
        """Drain the dispatched requests, wait on all of them with one wait
        (``_wait_batch``), then resolve their futures in FIFO order."""
        shutdown = False
        while True:
            item = self._done_q.get()
            if item is None:
                return
            batch_items = [item]
            while True:
                try:
                    nxt = self._done_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    shutdown = True
                    break
                batch_items.append(nxt)
            try:
                self._wait_batch(batch_items)
            except Exception as e:
                for _, fut, work in batch_items:
                    self._retry_or_fail(fut, work, e)
                if shutdown:
                    return
                continue
            for rec, fut, _ in batch_items:
                try:
                    self._resolve_overflow(rec)
                    if self.fetch_outputs:
                        out = rec.result()["output"]
                    else:
                        out = rec.outputs["output"]
                    self._bump("completed")
                    fut.set_result(out)
                except Exception as e:
                    fut.set_exception(e)
                finally:
                    self._inflight.release()
            if shutdown:
                return

    @staticmethod
    def _wait_batch(batch_items) -> None:
        """One wait for every drained request: the event of the newest
        dispatch among them (``InFlight.seq`` is the order in which the
        engine queued them on its stream)."""
        max(batch_items, key=lambda it: it[0].seq)[0].wait()

    def _resolve_overflow(self, rec) -> None:
        """Apply ``a2a_overflow_policy`` to a request whose all-to-all
        exchange dropped ids, as ``Engine.predict`` does: count it, then
        ``InFlight.check_overflow`` ("raise" fails the request; "recompute"
        already ran the lossless forward in its dispatch).  A single-device
        record never overflows."""
        if not rec.a2a_overflow:
            return
        with self._stats_lock:
            self.stats["a2a_overflow"] = (
                self.stats.get("a2a_overflow", 0) + rec.a2a_overflow)
            if rec.recomputed:
                self.stats["a2a_recomputes"] = (
                    self.stats.get("a2a_recomputes", 0) + 1)
        rec.check_overflow()

    def _retry_or_fail(self, fut, work, exc):
        if work["attempt"] < self.retries and not self._closed \
                and not self._mesh:
            work["attempt"] += 1
            self._bump("retries")
            try:
                self._pool.submit(self._work, work)
                return
            except RuntimeError:
                pass    # pool shut down while scheduling: fail the request
        fut.set_exception(exc)
        self._inflight.release()

    def _dispatch(self, batch: Dict, batch_size: Optional[int]):
        """Prep + asynchronous dispatch; returns the in-flight record
        (``Engine.dispatch``).  The retry seam: errors raised here re-enter
        the retry loop."""
        eng = self.engine
        prepared = eng.prepare(batch, batch_size)
        return eng.dispatch(prepared, fetch=self.fetch_outputs)

    def _dispatch_in_turn(self, batch: Dict, batch_size: Optional[int],
                          ticket: int):
        """On a mesh: prep at once, then dispatch in ``ticket``'s turn; the
        turn passes on whether prep and dispatch succeed or not."""
        eng = self.engine
        try:
            prepared = eng.prepare(batch, batch_size)
            with self._turn:
                self._turn.wait_for(lambda: self._tickets[1] == ticket)
            return eng.dispatch(prepared, fetch=self.fetch_outputs)
        finally:
            with self._turn:
                self._turn.wait_for(lambda: self._tickets[1] == ticket)
                self._tickets[1] += 1
                self._turn.notify_all()

    def _work(self, work):
        fut = work["future"]
        try:
            if "ticket" in work:
                rec = self._dispatch_in_turn(work["batch"],
                                             work["batch_size"],
                                             work["ticket"])
            else:
                rec = self._dispatch(work["batch"], work["batch_size"])
            self._done_q.put((rec, fut, work))
        except Exception as e:  # prep/dispatch errors
            self._retry_or_fail(fut, work, e)
        except BaseException as e:
            fut.set_exception(e)
            self._inflight.release()
            raise

    def submit(
        self, batch: Dict, batch_size: Optional[int] = None
    ) -> "Future[np.ndarray]":
        """Returns a Future of the output array.  Applies BACKPRESSURE:
        when ``max_inflight`` requests are already in flight, the call
        blocks in the submitting thread until a slot frees (bounding both
        device-queue depth and submitter memory)."""
        self._inflight.acquire()
        self._bump("submitted")
        result: "Future[np.ndarray]" = Future()
        work = {"batch": batch, "batch_size": batch_size, "future": result,
                "attempt": 0}
        with self._turn:
            if self._mesh:
                # the pool takes work in submission order, so the lowest
                # ticket waiting for its turn always holds a worker
                work["ticket"] = self._tickets[0]
                self._tickets[0] += 1
            self._pool.submit(self._work, work)
        return result

    def map_stream(self, batches: Iterable[Dict]) -> List[np.ndarray]:
        """Submit every batch, preserving order; blocks for all results."""
        futs = [self.submit(b) for b in batches]
        return [f.result() for f in futs]

    def close(self):
        self._closed = True      # retries after this point fail fast
        self._pool.shutdown(wait=True)
        self._done_q.put(None)
        self._completer.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def throughput_under_sla(
    engine,
    batches: List[Dict],
    sla_ms: float,
    num_iterations: int = 50,
    worker_ladder=(1, 2, 4, 8, 16),
    prep_workers: int = 8,
    batch_factory=None,
) -> Dict:
    """The reference benchmark_throughput analogue (recom_tpu/runtime/
    server.py:311-389): raise offered concurrency until p99 latency
    violates the SLA; report the highest sustainable throughput and the
    knee point.

    ``batch_factory(k) -> batch`` supplies DISTINCT content for every
    timed request (k is a global counter), so no request repeats an
    earlier one's inputs; without it, workers replay ``batches``
    round-robin."""
    results = []
    best = None
    req_counter = [0]
    counter_lock = threading.Lock()

    def next_batch(idx: int):
        if batch_factory is None:
            return batches[idx % len(batches)]
        with counter_lock:
            k = req_counter[0]
            req_counter[0] += 1
        return batch_factory(k)

    for workers in worker_ladder:
        lat: List[float] = []
        lock = threading.Lock()
        with ServingPipeline(
            engine, prep_workers=prep_workers, max_inflight=workers
        ) as pipe:
            # warm all signatures once (every distinct batch, not just the
            # first: mixed batch-size/rowlen inputs would otherwise meet
            # their first launch inside the timed window and skew the
            # first rung's p99)
            for b in batches:
                pipe.submit(b).result()

            def worker(idx: int):
                for _ in range(num_iterations):
                    b = next_batch(idx)     # built OUTSIDE the timed span
                    t0 = time.perf_counter()
                    pipe.submit(b).result()
                    dt = time.perf_counter() - t0
                    with lock:
                        lat.append(dt)

            t_start = time.perf_counter()
            threads = [
                threading.Thread(target=worker, args=(i,))
                for i in range(workers)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t_start

        arr = np.asarray(lat) * 1e3
        bsz = len(next(iter(batches[0].values())))
        row = {
            "workers": workers,
            "p50_ms": round(float(np.percentile(arr, 50)), 3),
            "p99_ms": round(float(np.percentile(arr, 99)), 3),
            "examples_per_s": round(workers * num_iterations * bsz / wall, 1),
            "meets_sla": bool(np.percentile(arr, 99) <= sla_ms),
        }
        results.append(row)
        if row["meets_sla"]:
            best = row
        else:
            break  # pressure ladder: once SLA breaks, higher load won't help
    return {"sla_ms": sla_ms, "ladder": results, "best_under_sla": best}
