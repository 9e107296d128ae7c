#!/usr/bin/env python3
"""The PostPool models' served and trained times through the PyTorch/CUDA
port, with nothing else run in the process.

Run from a checkout's root on a machine with an NVIDIA GPU:

    python3 postpool_latency.py

For each model of ``models/postpool.py`` (random weights from its init
seeds), at batch 64 and at batch 2048 (each its own one bucket), it
serves ``predict`` (pooled outputs and concat) and takes ``Trainer.step``
(``dlrm_optimizer``), WARM times each; then it times CALLS calls of each on
the host clock, every call ending in ``torch.cuda.synchronize()``, and
CALLS more under ``torch.profiler``: the summed time of the device ops
(kernels, copies) per call and their number per call.  The package it
times is the one beside the script, so to compare two trees in the same
process state, copy the script into the other checkout and run the two in
turns.  The first line is the card's name and power limit; the last line
is one JSON object: per model, batch and call, the host median (ms), the
device time per call (ms) and the device ops per call.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

BATCHES, WARM, CALLS = (64, 2048), 3, 20


def device_per_call(torch, fn, calls: int) -> tuple:
    """(device ms per call, device ops per call) of ``calls`` calls of
    ``fn`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [ev.time_range.end - ev.time_range.start for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    if not spans:
        raise RuntimeError("postpool_latency: the profiler saw no device op")
    return sum(spans) / 1e3 / calls, len(spans) / calls


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("postpool_latency: no CUDA device", file=sys.stderr)
        return 2

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import (
        make_every_post_model,
        make_matmul_model,
        make_post_model,
        make_random_batch,
        make_softmax_mul_model,
    )
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.train import Trainer, dlrm_optimizer
    from recom_tpu_torch.utils.device import card_line
    from recom_tpu_torch.utils.params import init_model_params

    print(card_line("cuda"), flush=True)
    res = {}
    for make in (make_post_model, make_softmax_mul_model, make_matmul_model,
                 make_every_post_model):
        model = make()
        params = init_model_params(model)
        for bs in BATCHES:
            cfg = EngineConfig(batch_buckets=(bs,))
            batch = make_random_batch(model, bs, seed=bs)
            labels = np.random.default_rng(bs).integers(0, 2, bs).astype(
                np.float32)
            eng = Engine(model, cfg, params=params, device="cuda")
            tr = Trainer(model, cfg, optimizer=dlrm_optimizer(),
                         params=params, device="cuda")
            calls = {
                "predict": lambda: eng.predict(
                    batch, return_pooled=True, return_concat=True),
                "step": lambda: tr.step(batch, labels)}
            for what, fn in calls.items():
                for _ in range(WARM):
                    fn()
                torch.cuda.synchronize()
                host = []
                for _ in range(CALLS):
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    host.append((time.perf_counter() - t) * 1e3)
                dev_ms, ops = device_per_call(torch, fn, CALLS)
                key = f"{model.name} {bs} {what}"
                res[key] = {"host_p50_ms": statistics.median(host),
                            "device_ms": dev_ms, "device_ops": ops}
                print(f"{key}: host p50 {res[key]['host_p50_ms']:.4f} ms, "
                      f"device {dev_ms:.4f} ms in {ops:.1f} ops per call",
                      flush=True)
            del eng, tr
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
