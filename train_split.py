#!/usr/bin/env python3
"""The eager training step of the Criteo DLRM through the PyTorch/CUDA
port, split into forward, backward and optimizer, with nothing else run
in the process.

Run from a checkout's root on a machine with an NVIDIA GPU:

    python3 train_split.py

It uses only ``Trainer`` calls that every slice of the port since its
captured training step has (``engine.prepare``, ``loss``, ``optimizer``),
so the same script times any such tree: to compare two trees in the same
process state, copy the script into the other checkout and run the two in
turns.  The Trainer steps eagerly (``_capture = None``).  Random weights
from the model's seed, ``chip_smoke.criteo_batch`` traffic, batch 512 and
2048.  For each batch size and each part of the step (``zero_grad`` and
``loss`` as the forward, ``loss.backward()``, ``optimizer.step()``), over
CALLS steps:

* ``host_ms``: the host time of the part's calls, from an idle card
  (median; each step waits for the card after the clock stops);
* ``events_ms``: CUDA events around the part, host-paced as
  ``chip_smoke.step_times`` reads it (median);
* ``device_ops`` and ``device_busy_ms``: the device operations the part
  ran and their summed time under ``torch.profiler`` (per step);
* ``top_host_ops``: the part's host operations with the most self time
  under ``torch.profiler`` (name, calls per step, self ms per step).

The first line is the card's name and power limit; the last line is one
JSON object of every reading, by batch size and part.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

CALLS, WARM, TOP = 10, 3, 8
PARTS = ("forward", "backward", "optimizer")


def step_parts(tr, prepared, labels, hook):
    """One eager step, ``hook(part, fn)`` running each part's calls."""
    box = {}

    def forward():
        tr.optimizer.zero_grad(set_to_none=True)
        box["loss"] = tr.loss(prepared, labels)

    hook("forward", forward)
    hook("backward", lambda: box["loss"].backward())
    hook("optimizer", tr.optimizer.step)


def readings(torch, tr, batch, labels) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prepared = tr.engine.prepare(batch)
    for _ in range(WARM):
        step_parts(tr, prepared, labels, lambda part, fn: fn())
    torch.cuda.synchronize()
    host = {p: [] for p in PARTS}
    events = {p: [] for p in PARTS}

    def timed(part, fn):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t = time.perf_counter()
        ev[0].record()
        fn()
        ev[1].record()
        host[part].append((time.perf_counter() - t) * 1e3)
        ev[1].synchronize()
        events[part].append(ev[0].elapsed_time(ev[1]))

    for _ in range(CALLS):
        step_parts(tr, prepared, labels, timed)
    res = {p: {"host_ms": statistics.median(host[p]),
               "events_ms": statistics.median(events[p])} for p in PARTS}
    for part in PARTS:
        def profiled(p, fn, part=part):
            if p != part:
                fn()
                return
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            profs.append(prof)

        profs = []
        for _ in range(CALLS):
            step_parts(tr, prepared, labels, profiled)
        spans, host_ops = [], {}
        for prof in profs:
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA:
                    spans.append(ev.time_range.end - ev.time_range.start)
            for avg in prof.key_averages():
                if avg.device_type == DeviceType.CPU:
                    n, us = host_ops.get(avg.key, (0, 0.0))
                    host_ops[avg.key] = (n + avg.count,
                                         us + avg.self_cpu_time_total)
        top = sorted(host_ops.items(), key=lambda kv: -kv[1][1])[:TOP]
        res[part].update(
            device_ops=len(spans) / CALLS,
            device_busy_ms=sum(spans) / 1e3 / CALLS,
            top_host_ops=[(k, n / CALLS, us / 1e3 / CALLS)
                          for k, (n, us) in top])
    return res


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_split: no CUDA device", file=sys.stderr)
        return 2

    from chip_smoke import criteo_batch
    from recom_tpu_torch import EngineConfig, Trainer
    from recom_tpu_torch.models import make_criteo_dlrm
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.train import dlrm_optimizer
    from recom_tpu_torch.utils.device import card_line
    from recom_tpu_torch.utils.params import init_model_params

    print(card_line("cuda"), flush=True)
    kernels.build_all()
    model = make_criteo_dlrm()
    tr = Trainer(model, EngineConfig(),
                 optimizer=dlrm_optimizer(tower_lr=1e-5),
                 params=init_model_params(model), device="cuda")
    tr._capture = None
    rng = np.random.default_rng(5)
    res = {}
    for bs in (512, 2048):
        batch = criteo_batch(model, bs, seed=1)
        labels = rng.integers(0, 2, bs).astype(np.float32)
        res[bs] = readings(torch, tr, batch, labels)
        for part in PARTS:
            r = res[bs][part]
            print(f"Criteo {bs} {part}: host {r['host_ms']:.3f} ms, events "
                  f"{r['events_ms']:.3f} ms, {r['device_ops']:.1f} device "
                  f"ops busy {r['device_busy_ms']:.3f} ms; top host ops "
                  + ", ".join(f"{k} x{n:g} {ms:.3f} ms"
                              for k, n, ms in r["top_host_ops"]),
                  flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
