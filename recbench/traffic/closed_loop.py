"""Closed-loop serving: ``clients`` threads share one ``ServingPipeline``,
each sending its next request only once its last one returned, as a
ranking tier's request threads wait on their scores.  A request is one
batch of the pool (client c sends batches c, c + clients, ... in turn),
submitted as ``pipeline.submit(batch).result()``; its latency runs from the
submit to the scores on the host.  The pattern of
``recom_tpu_torch/runtime/server.py::throughput_under_sla``'s workers, for
a fixed window instead of a fixed count.

Set-up builds the Engine from the seed's weights, captures the program of
every signature the pool has (``Engine.warmup``), and sends
``warm_rounds`` requests a client through the pipeline; the window then
runs for ``--seconds``.  Requests answered in the window count; the
answers of the requests still in flight at its close are waited for and
judged with the others.  After the window the program is freed and the
reference scores each pool batch once; every returned answer is held to its
batch's scores.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from recbench import check, port, weights
from recbench.reference.model import Reference
from recbench.traffic import batches


class Cell:
    kind = "serve"

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, log):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = device
        self.log = log
        self.parts: Dict[str, float] = {}
        self.spans: Optional[port.Spans] = None

    def setup(self) -> None:
        t = time.perf_counter()
        self.pool = batches.make_pool(self.cfg, self.mix, self.seed)
        self.parts["traffic_pool_s"] = time.perf_counter() - t
        t = time.perf_counter()
        params = weights.program_params(self.cfg, self.seed, self.device)
        self.parts["weights_s"] = time.perf_counter() - t
        port.reset_memory_peak(self.device)
        t = time.perf_counter()
        self.engine = port.make_engine(self.cfg, params, self.device)
        del params
        self.parts["engine_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.engine.warmup(batches=self.pool)
        self.parts["capture_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.pipe = port.make_pipeline(self.engine, self.mix)
        self._drive(None, self.mix["warm_rounds"])
        self.parts["warm_requests_s"] = time.perf_counter() - t

    def _drive(self, seconds: Optional[float], rounds: int = 0) -> List:
        """Run the clients, for ``seconds`` or ``rounds`` requests each;
        returns their records (pool index, submit, return, scores or
        None)."""
        n = self.mix["clients"]
        pool, pipe, spans = self.pool, self.pipe, self.spans
        records: List[List] = [[] for _ in range(n)]
        start = threading.Barrier(n + 1)
        window = {}

        def client(c: int) -> None:
            start.wait()
            t_end = window.get("end")
            k = c
            while True:
                t0 = time.perf_counter()
                if (t_end is not None and t0 >= t_end) or (
                        t_end is None and len(records[c]) >= rounds):
                    return
                batch = dict(pool[k % len(pool)])
                if spans is not None:
                    spans.submitted(batch, t0)
                try:
                    out = np.array(pipe.submit(batch).result(),
                                   np.float32).reshape(-1)
                except Exception as e:  # a failed request counts as missing
                    self.log(f"request failed: {e!r}")
                    out = None
                records[c].append((k % len(pool), t0, time.perf_counter(),
                                   out))
                k += n

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"recbench-client{c}")
                   for c in range(n)]
        for th in threads:
            th.start()
        if seconds is not None:
            self.t_start = time.perf_counter()
            window["end"] = self.t_end = self.t_start + seconds
        start.wait()
        for th in threads:
            th.join()
        return [r for rs in records for r in rs]

    def window(self, seconds: float) -> None:
        self.records = self._drive(seconds)

    def traced(self, spans: port.Spans) -> None:
        """Wrap the program's calls in ``spans`` for the window."""
        self.spans = spans
        spans.install(self.engine)

    def memory_peak(self) -> int:
        return port.memory_peak(self.device)

    def release(self) -> None:
        if self.spans is not None:
            self.spans.uninstall()
        self.pipe.close()
        self.pipe = self.engine = None
        port.free_device_memory()

    # -- what the metrics read ---------------------------------------------
    def end_to_end(self) -> Dict[str, float]:
        rows = self.mix["batch"]
        done = [r for r in self.records
                if r[3] is not None and r[2] <= self.t_end]
        failed = [r for r in self.records if r[3] is None]
        lat = np.asarray([(r[2] - r[1]) * 1e3 for r in done]
                         + [1e12] * len(failed))
        return {
            "examples": float(rows * len(done)),
            "window_s": self.t_end - self.t_start,
            "p95_ms": float(np.percentile(lat, 95)) if len(lat) else 1e12,
        }

    @property
    def attempted(self) -> int:
        return len(self.records)

    @property
    def failed(self) -> int:
        return sum(r[3] is None for r in self.records)

    @property
    def forwards(self) -> int:
        return sum(r[3] is not None for r in self.records)

    def numbers(self) -> Dict[str, float]:
        ref = Reference(self.cfg, self.seed, self.device)
        scores = {k: ref.scores(batch) for k, batch in enumerate(self.pool)}
        ref.release()
        answers = [(r[0], r[3]) for r in self.records if r[3] is not None]
        return {"score_gap": check.score_gap(answers, scores),
                "missing_answers": float(self.failed)}
