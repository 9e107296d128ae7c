"""Training step after step: one ``Trainer`` takes ``Trainer.step(batch,
labels)`` back to back over the pool's batches in turn, each step ending in
its loss read on the host, as a training job's loop does.

Set-up builds the Trainer from the seed's weights and drives its first
``checked_steps`` steps through the same call and feed as the window (the
first captures the step's program): the optimizer's state after the first
gives each leaf's first gradient, and the params after the last their
change, which the reference's same steps are held to after the window.
The window then steps on from the next batch until ``--seconds`` are up;
its rate is the examples of its steps over the time they took.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

from recbench import check, port, spec, weights
from recbench.reference.model import Reference
from recbench.traffic import batches


class Cell:
    kind = "train"

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, log):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = device
        self.log = log
        self.parts: Dict[str, float] = {}
        self.spans = None

    def setup(self) -> None:
        cfg, mix, seed = self.cfg, self.mix, self.seed
        t = time.perf_counter()
        self.pool = batches.make_pool(cfg, mix, seed)
        self.labels = [batches.make_labels(mix, seed, k)
                       for k in range(mix["pool"])]
        self.parts["traffic_pool_s"] = time.perf_counter() - t
        t = time.perf_counter()
        params = weights.program_params(cfg, seed, self.device)
        self.parts["weights_s"] = time.perf_counter() - t
        port.reset_memory_peak(self.device)
        t = time.perf_counter()
        self.trainer = port.make_trainer(cfg, params, self.device)
        del params
        self.parts["engine_s"] = time.perf_counter() - t
        eng = self.trainer.engine
        tower0 = {k: v.detach().clone()
                  for k, v in port.tower_views(eng).items()}
        n = mix["checked_steps"]
        self.losses: List[float] = []
        t = time.perf_counter()
        self.losses.append(self.trainer.step(self.pool[0], self.labels[0]))
        self.parts["capture_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.grad_norms = port.first_grad_norms(self.trainer, cfg)
        for k in range(1, n):
            self.losses.append(self.trainer.step(self.pool[k],
                                                 self.labels[k]))
        self.setup_peak = port.memory_peak(self.device)
        self.update_norms = port.change_norms(eng, tower0)
        del tower0
        for ci, cls in enumerate(spec.classes(cfg)):
            flat = weights.class_table(cfg, ci, seed, self.device)
            self.update_norms.update(port.change_norms(eng, {
                name: flat[off:off + rows] for name, off, rows
                in zip(cls.tables, cls.offsets, cls.rows)}))
            del flat
        port.free_device_memory()
        port.reset_memory_peak(self.device)
        self.parts["checked_steps_s"] = time.perf_counter() - t

    def window(self, seconds: float) -> None:
        pool, labels, n0 = self.pool, self.labels, self.mix["checked_steps"]
        self.records = []
        k = n0
        self.t_start = time.perf_counter()
        t_end = self.t_start + seconds
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            i = k % len(pool)
            loss = self.trainer.step(pool[i], labels[i])
            self.records.append((t0, time.perf_counter(), loss))
            k += 1

    def traced(self, spans: port.Spans) -> None:
        """Wrap the program's calls in ``spans`` for the window."""
        self.spans = spans
        spans.install(self.trainer.engine, self.trainer)

    def memory_peak(self) -> int:
        return max(self.setup_peak, port.memory_peak(self.device))

    def release(self) -> None:
        if self.spans is not None:
            self.spans.uninstall()
        self.trainer = None
        port.free_device_memory()

    def end_to_end(self) -> Dict[str, float]:
        return {"examples": float(self.mix["batch"] * len(self.records)),
                "window_s": self.records[-1][1] - self.t_start}

    @property
    def attempted(self) -> int:
        return len(self.records)

    @property
    def failed(self) -> int:
        return sum(not math.isfinite(r[2]) for r in self.records)

    @property
    def forwards(self) -> int:
        return len(self.records)

    def numbers(self) -> Dict[str, float]:
        n = self.mix["checked_steps"]
        ref = Reference(self.cfg, self.seed, self.device)
        got = ref.train(self.pool[:n], self.labels[:n])
        prog = {"losses": self.losses, "grad_norms": self.grad_norms,
                "update_norms": self.update_norms}
        out = check.train_numbers(prog, got)
        out["nonfinite_losses"] = float(self.failed)
        return out

