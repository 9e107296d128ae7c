#!/usr/bin/env python3
"""The single-device serving path's readings through the PyTorch/CUDA
port, with nothing else run in the process.

Run from a checkout's root on a machine with an NVIDIA GPU:

    python3 graph_latency.py

It uses only ``Engine`` calls that every slice of the port has
(``prepare``, ``dispatch``, ``predict``, ``warmup``, ``benchmark``), so
the same script times a tree that serves through one captured CUDA graph
per shape signature and one that runs the forward eagerly: to compare two
trees in the same process state, copy the script into the other checkout
and run the two in turns.  Random weights from each model's seed.

Cases: full-size model E in the default ``EngineConfig()`` at batch 512
and 2048; model E under ``host_bucketize=False`` at 2048; the
microbenchmark model at 1000 columns under ``host_bucketize=False`` at
2048; the Criteo DLRM at 2048 on ``chip_smoke.criteo_batch`` traffic.
For model E in the default config it first times ``warmup()`` over the
config's 7 batch buckets on the fresh engine and reads the device memory
allocated and reserved after it.  For each case, on one prepared batch:

* ``first_ms``: the first request of its signature, ``dispatch`` to
  ``result`` (host clock; a graph's eager pass and capture, or the first
  eager forward);
* ``dispatch_host_ms``: the host time of one ``dispatch`` call (median of
  CALLS; each waited on after the clock stops);
* ``device_queued_ms``: CUDA events around CALLS ``dispatch(fetch=False)``
  calls queued behind a sleep kernel, per call (staging's copy, the
  forward, the output's clone where the tree makes one);
* ``device_paced_ms``: the same with a wait after each call;
* ``device_ops`` and ``device_busy_ms``: the device operations and their
  summed time per ``dispatch`` under ``torch.profiler`` (CALLS calls);
* ``predict_p50_ms``: the median of CALLS ``predict`` calls;
* ``benchmark_ms``: ``Engine.benchmark(batch, iters=CALLS)``.

The first line is the card's name and power limit; the last line is one
JSON object of every reading, by case.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time

CALLS, WARM = 20, 3
SLEEP_CYCLES = 200_000_000          # about 0.1 s of the card's clock


def events_ms(torch, fn, queued: bool) -> float:
    """Mean device time of CALLS calls of ``fn`` between two CUDA events,
    queued behind a sleep kernel or paced by the host."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(CALLS):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / CALLS


def profiled(torch, fn) -> tuple:
    """(device ops per call, their summed ms per call) of CALLS calls of
    ``fn`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    spans = [ev.time_range.end - ev.time_range.start for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    return len(spans) / CALLS, sum(spans) / 1e3 / CALLS


def readings(torch, eng, batch) -> dict:
    prep = eng.prepare(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.dispatch(prep).result()
    res = {"first_ms": (time.perf_counter() - t) * 1e3}
    for _ in range(WARM):
        eng.dispatch(prep).result()
    host = []
    for _ in range(CALLS):
        t = time.perf_counter()
        rec = eng.dispatch(prep)
        host.append((time.perf_counter() - t) * 1e3)
        rec.wait()
    res["dispatch_host_ms"] = statistics.median(host)
    res["device_queued_ms"] = events_ms(
        torch, lambda: eng.dispatch(prep, fetch=False), queued=True)
    res["device_paced_ms"] = events_ms(
        torch, lambda: eng.dispatch(prep, fetch=False).wait(), queued=False)
    res["device_ops"], res["device_busy_ms"] = profiled(
        torch, lambda: eng.dispatch(prep, fetch=False).wait())
    lat = []
    for _ in range(CALLS):
        t = time.perf_counter()
        eng.predict(batch)
        lat.append((time.perf_counter() - t) * 1e3)
    res["predict_p50_ms"] = statistics.median(lat)
    res["benchmark_ms"] = eng.benchmark(batch, iters=CALLS,
                                        warmup=WARM)["latency_ms"]
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("graph_latency: no CUDA device", file=sys.stderr)
        return 2

    from chip_smoke import criteo_batch
    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import (
        make_criteo_dlrm,
        make_model_e,
        make_random_batch,
    )
    from recom_tpu_torch.models.synthetic import make_microbenchmark_model
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.utils.device import card_line
    from recom_tpu_torch.utils.params import init_model_params

    print(card_line("cuda"), flush=True)
    kernels.build_all()
    model_e = make_model_e(seed=0)
    params_e = init_model_params(model_e)
    micro = make_microbenchmark_model(1000, random_boundary=True, seed=0)
    criteo = make_criteo_dlrm()
    cases = [
        ("model E", model_e, params_e, EngineConfig(), {
            512: make_random_batch(model_e, 512, seed=2),
            2048: make_random_batch(model_e, 2048, seed=1)}),
        ("model E host_bucketize=False", model_e, params_e,
         EngineConfig(host_bucketize=False),
         {2048: make_random_batch(model_e, 2048, seed=1)}),
        ("micro-1000 host_bucketize=False", micro, init_model_params(micro),
         EngineConfig(host_bucketize=False),
         {2048: make_random_batch(micro, 2048, seed=1)}),
        ("Criteo DLRM", criteo, init_model_params(criteo), EngineConfig(),
         {2048: criteo_batch(criteo, 2048, seed=1)}),
    ]
    res = {}
    for name, model, params, cfg, batches in cases:
        eng = Engine(model, cfg, params=params, device="cuda")
        torch.cuda.synchronize()
        if name == "model E":
            t = time.perf_counter()
            n = eng.warmup()
            res["model E warmup"] = {
                "programs": n, "s": time.perf_counter() - t,
                "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30,
                "memory_reserved_gib": torch.cuda.memory_reserved() / 2**30}
            print(f"model E warmup(): {res['model E warmup']}", flush=True)
        for bs, batch in batches.items():
            key = f"{name} {bs}"
            res[key] = readings(torch, eng, batch)
            print(f"{key}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in res[key].items()), flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
