#!/usr/bin/env python3
"""Model E's ``predict`` latency through the PyTorch/CUDA port, with nothing
else run in the process.

Run from a checkout's root on a machine with an NVIDIA GPU:

    python3 predict_latency.py

It builds full-size model E (random weights from seed 0) with the default
``EngineConfig()`` on the card; then, for ROUNDS rounds, for batch 512 and
2048 in turn, it makes two warm-up calls and times CALLS calls of
``Engine.predict`` on the host clock.  For each round and batch it prints
the median ``predict`` latency and the stage p50s of ``Engine.timers``.
The package it times is the one beside the script, so to compare two trees
in the same process state, copy the script into the other checkout and run
the two in turns.  The last line is one JSON object: per batch size, the
median over rounds of each round's median.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

ROUNDS, CALLS = 5, 20


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("predict_latency: no CUDA device", file=sys.stderr)
        return 2

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import make_model_e, make_random_batch
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.utils.logging import StageTimer
    from recom_tpu_torch.utils.params import init_model_params

    model = make_model_e(seed=0)
    eng = Engine(model, EngineConfig(), params=init_model_params(model),
                 device="cuda")
    batches = {512: make_random_batch(model, 512, seed=2),
               2048: make_random_batch(model, 2048, seed=1)}
    medians = {bs: [] for bs in batches}
    for r in range(ROUNDS):
        for bs, batch in batches.items():
            for _ in range(2):
                eng.predict(batch)
            eng.timers = StageTimer()
            lat = []
            for _ in range(CALLS):
                t = time.perf_counter()
                eng.predict(batch)
                lat.append((time.perf_counter() - t) * 1e3)
            medians[bs].append(statistics.median(lat))
            stages = eng.timers.summary()
            print(f"round {r} batch {bs}: predict median "
                  f"{medians[bs][-1]:.3f} ms (min {min(lat):.3f}, max "
                  f"{max(lat):.3f}, {CALLS} calls); stage p50 ms: "
                  + ", ".join(f"{k} {v['p50_ms']}"
                              for k, v in sorted(stages.items())),
                  flush=True)
    print(json.dumps({f"predict_p50_ms_{bs}": statistics.median(m)
                      for bs, m in medians.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
