"""The readings that a cell's limits are set against: the control (the
reference put in the program's place, in TF32, the precision just below the
configuration's f32 with TF32 off) and the planted faults, each held to the
f32 reference at the cell's own sizes.

    python3 -m recbench.control --workload <cell> --seeds 1,2,3

prints one JSON line a seed: the numbers that decide ``correct`` (check.py)
for the control, and for a training cell also for the step whose loss is
the mean over half the batch.  A step that returns its state unchanged
reads 1 by the change's measure and needs no run.  The benchmark's own runs
do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

from recbench import check, spec
from recbench.reference.model import Reference
from recbench.traffic import batches


def serve_readings(cfg: Dict, mix: Dict, seed: int, device) -> Dict:
    pool = batches.make_pool(cfg, mix, seed)
    scores = {}
    for precision in ("float32", "tf32"):
        ref = Reference(cfg, seed, device, precision)
        scores[precision] = {k: ref.scores(b) for k, b in enumerate(pool)}
        ref.release()
    answers = list(scores["tf32"].items())
    return {"control": {"score_gap": check.score_gap(answers,
                                                     scores["float32"])}}


def train_readings(cfg: Dict, mix: Dict, seed: int, device) -> Dict:
    n = mix["checked_steps"]
    pool = [batches.make_batch(cfg, mix["values"], mix["batch"], seed, k)
            for k in range(n)]
    labels = [batches.make_labels(mix, seed, k) for k in range(n)]
    base = Reference(cfg, seed, device).train(pool, labels)
    out = {}
    for name, precision, half in (("control", "tf32", False),
                                  ("half_batch", "float32", True)):
        got = Reference(cfg, seed, device, precision).train(
            pool, labels, half_batch=half)
        out[name] = check.train_numbers(got, base)
    return out


def readings(cfg: Dict, mix: Dict, seed: int, device) -> Dict:
    if mix["kind"] == "closed_loop":
        return serve_readings(cfg, mix, seed, device)
    return train_readings(cfg, mix, seed, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    work = spec.workload(args.workload)
    cfg = spec.config(work["config"])
    mix = spec.mix(work["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(cfg, mix, seed, args.device)
        for name, numbers in got.items():
            verdict = check.judge(numbers, {
                k: v for k, v in work["limits"].items() if k in numbers})
            got[name] = {"numbers": numbers, "fails": not verdict["correct"]}
        print(json.dumps({"workload": args.workload, "seed": seed, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
