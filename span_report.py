#!/usr/bin/env python3
"""Where a benchmark cell's time goes, by the spans the port records
(``recom_tpu_torch/utils/spans.py``), on the card.

Run from a checkout's root on a machine with an NVIDIA GPU:

    python3 span_report.py --workload e_train_b2048 --seed 7 --seconds 10 [--onoff 3]

It builds the cell as ``python3 -m recbench.run`` does (the same seed, the
same traffic, the same re-execution with ``PYTHONHASHSEED=0`` and the
host's threads capped) with the span recorder on from the start, and
prints set-up's spans (``engine.*``, ``trainer.*``).  Then one window of
``--seconds`` runs under ``torch.profiler`` with the recorder on and the
benchmark's own spans (``recbench/port.py::Spans``) installed, and the
report gives:

- for a training cell, each span's mean ms a step; ``launch_ms``: the host
  ms a step of ``step.stage`` + ``step.load`` + ``step.replay``;
  ``backward_ms`` and ``optimizer_ms``, the card's ms a step of
  ``device.backward`` and ``device.optimizer``; the three device phases
  summed over the window against the trace's busy time; and how much of
  each benchmark ``step`` span the program's spans inside it cover;
- for a serving cell, each span's mean ms a request and its share of a
  request's latency;
- for both, the device's idle gaps put down to the innermost program span
  over them (the program's stamps are on the trace's own clock) and to the
  benchmark's spans, as ``recbench/trace.py`` labels them.

With ``--onoff N`` (training cells) it then runs N windows with the
recorder off and N with it on, in turns, without the profiler, and gives
each window's examples/s and mean ``Engine.prepare`` ms (the benchmark's
span).  The report is printed as JSON (and written to ``--out``, where
given).  ``--device cpu`` runs it with the kernels' plain versions, to
rehearse it: its times are the CPU's.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

T_PROCESS = float(os.environ.get("RECBENCH_T_PROCESS", time.perf_counter()))


def log(msg: str) -> None:
    print(f"[span_report] {msg}", file=sys.stderr, flush=True)


def pinned(argv) -> None:
    """Re-execute once under the benchmark's environment (recbench/run.py
    ``pinned_process``)."""
    from recbench.run import host_threads

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    known, _ = p.parse_known_args(argv)
    n = str(host_threads(known.workload))
    want = {"PYTHONHASHSEED": "0", "RECOM_TPU_NATIVE_THREADS": n,
            "OMP_NUM_THREADS": n}
    if all(os.environ.get(k) == v for k, v in want.items()):
        return
    env = dict(os.environ, RECBENCH_T_PROCESS=repr(T_PROCESS), **want)
    os.execve(sys.executable, [sys.executable, __file__] + list(argv), env)


def ms(r) -> float:
    return (r["end_ns"] - r["start_ns"]) / 1e6


def by_name(rows, ids=None):
    out = {}
    for r in rows:
        if ids is None or r["id"] in ids:
            out.setdefault(r["name"], []).append(ms(r))
    return out


def union_ns(intervals, lo, hi) -> int:
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def device_gaps(tracer):
    """The window's device idle gaps [(start, end)] in ns on the trace's
    clock, as ``recbench/trace.py`` finds them."""
    from torch.autograd import DeviceType

    from recbench.trace import WINDOW

    dev, window = [], None
    for ev in tracer._prof.profiler.kineto_results.events():
        s, d = ev.start_ns(), ev.duration_ns()
        if ev.is_user_annotation() or ev.name().startswith("recbench."):
            if ev.name() == WINDOW and ev.device_type() == DeviceType.CPU:
                window = (s, s + d)
        elif ev.device_type() == DeviceType.CUDA and d > 0:
            dev.append((s, s + d))
    lo, hi = window
    gaps, cur = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in dev
                       if e > lo and s < hi):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps, (lo, hi)


def idle_by_program(tracer, rows):
    """Idle seconds by the innermost host span of the program over them."""
    from recbench.trace import Tracer

    gaps, _ = device_gaps(tracer)
    host = [(r["start_ns"], r["end_ns"], r["name"]) for r in rows
            if r["kind"] == "host"]
    out = Tracer._label_gaps(gaps, host)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def train_report(rows, bench_spans, summary, offset_ns):
    steps = [r for r in rows if r["name"] == "step"]
    ids = {r["id"] for r in steps}
    names = by_name(rows, ids)
    n = len(steps)
    per_step = {k: sum(v) / n for k, v in sorted(names.items())}
    launch = sum(per_step.get(k, 0.0) for k in
                 ("step.stage", "step.load", "step.replay"))
    phases = ("device.forward", "device.backward", "device.optimizer")
    device_s = sum(sum(names.get(k, [])) for k in phases) / 1e3
    # the program's spans directly under each step, over the benchmark's
    # own span of that call (host clock perf_counter, put on the
    # recorder's clock by its offset)
    kids = {}
    for r in rows:
        if r["kind"] == "host" and r["parent"] is not None:
            kids.setdefault(r["parent"], []).append(
                (r["start_ns"], r["end_ns"]))
    covers = []
    bench_steps = sorted(bench_spans["step"])
    for st in steps:
        lo = st["start_ns"]
        match = [b for b in bench_steps
                 if b[0] * 1e9 + offset_ns <= lo <= b[1] * 1e9 + offset_ns]
        if not match:
            continue
        b0, b1 = (int(match[0][0] * 1e9 + offset_ns),
                  int(match[0][1] * 1e9 + offset_ns))
        covers.append(union_ns(kids.get(st["sid"], []), b0, b1)
                      / max(b1 - b0, 1))
    return {
        "steps": n,
        "per_step_ms": per_step,
        "launch_ms.train": launch,
        "backward_ms.train": per_step.get("device.backward"),
        "optimizer_ms.train": per_step.get("device.optimizer"),
        "forward_ms.train": per_step.get("device.forward"),
        "device_phases_s": device_s,
        "busy_s": summary["busy_s"],
        "phases_over_busy": (device_s / summary["busy_s"]
                             if summary["busy_s"] else None),
        "coverage_of_step_mean": (statistics.mean(covers)
                                  if covers else None),
        "coverage_of_step_min": min(covers) if covers else None,
    }


def serve_report(rows):
    reqs = [r for r in rows if r["name"] == "serve.request"]
    ids = {r["id"] for r in reqs}
    names = by_name(rows, ids)
    n = len(reqs)
    lat = statistics.mean(ms(r) for r in reqs)
    top = {}
    by_sid = {r["sid"]: r for r in rows}
    for r in rows:
        if r["id"] in ids and r["parent"] in by_sid and \
                by_sid[r["parent"]]["name"] == "serve.request":
            top[r["name"]] = top.get(r["name"], 0.0) + ms(r)
    covers = []
    kids = {}
    for r in rows:
        if r["id"] in ids and r["name"] != "serve.request" and \
                by_sid.get(r["parent"], {}).get("name") == "serve.request":
            kids.setdefault(r["parent"], []).append(
                (r["start_ns"], r["end_ns"]))
    for q in reqs:
        covers.append(union_ns(kids.get(q["sid"], []), q["start_ns"],
                               q["end_ns"]) / max(q["end_ns"] -
                                                  q["start_ns"], 1))
    return {
        "requests": n,
        "latency_mean_ms": lat,
        "per_request_ms": {k: sum(v) / n for k, v in sorted(names.items())},
        "top_level_share": {k: v / n / lat for k, v in sorted(
            top.items(), key=lambda kv: -kv[1])},
        "coverage_of_request_mean": statistics.mean(covers) if covers
        else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--onoff", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)

    import importlib

    import torch

    from recbench import port, run as brun, spec
    from recbench.trace import Tracer

    brun._cache_dirs()
    work = spec.workload(args.workload)
    cfg = spec.config(work["config"])
    mix = spec.mix(work["traffic"])
    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        log("needs a CUDA card")
        return 2
    from recom_tpu_torch.utils import spans

    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0) if cuda else "cpu"}
    if cuda:
        from recbench import hardware

        out["power.limit"] = hardware.smi().get("power.limit")
    spans.enable()
    kind = importlib.import_module(f"recbench.traffic.{mix['kind']}")
    cell = kind.Cell(cfg, mix, args.seed, args.device, log)
    port.program()
    if cuda:
        port.load_kernels()
    t = time.perf_counter()
    cell.setup()
    out["setup_parts"] = dict(cell.parts)
    out["setup_s_from_cell"] = time.perf_counter() - t
    setup_rows = spans.records()
    out["setup_spans_s"] = {
        k: sum(v) / 1e3 for k, v in by_name(setup_rows).items()
        if k.split(".")[0] in ("engine", "trainer", "capture")}

    bench = port.Spans()
    cell.traced(bench)
    # as recbench/run.py: set-up's objects leave the collector's
    # generations before the windows
    gc.collect()
    gc.freeze()
    spans.enable()
    with Tracer() as tracer:
        cell.window(args.seconds)
    summary = tracer.summary(bench.records)
    rows = spans.records()
    spans.disable()
    out["window"] = cell.end_to_end()
    out["busy_s"], out["window_s"] = summary["busy_s"], summary["window_s"]
    out["idle_by_benchmark_span"] = dict(summary["idle_gaps"])
    out["idle_by_program_span"] = idle_by_program(tracer, rows)
    offset = spans._offset
    if cell.kind == "train":
        out.update(train_report(rows, bench.records, summary, offset))
        out["host_prep_ms.train (benchmark span)"] = statistics.mean(
            (e - s) * 1e3 for s, e in bench.records["prepare"])
    else:
        out.update(serve_report(rows))
        # the window outside any call of the program's, by the program's
        # spans: time no request spent in a program span
        _, (lo, hi) = device_gaps(tracer)
        host = [(r["start_ns"], r["end_ns"]) for r in rows
                if r["kind"] == "host" and r["name"] != "serve.request"]
        out["window_in_no_program_span_s"] = (
            (hi - lo) - union_ns(host, lo, hi)) / 1e9
        bench_host = [(s * 1e9 + offset, e * 1e9 + offset)
                      for name, recs in bench.records.items()
                      if name != "queue_wait" for s, e in recs]
        out["window_in_no_benchmark_span_s"] = (
            (hi - lo) - union_ns(bench_host, lo, hi)) / 1e9
    if args.onoff and cell.kind == "train":
        rounds = []
        for i in range(args.onoff):
            for on in (False, True):
                bench.records["prepare"].clear()
                if on:
                    spans.enable()
                cell.window(args.seconds)
                spans.disable()
                e2e = cell.end_to_end()
                rounds.append({
                    "recorder": "on" if on else "off",
                    "steps": len(cell.records),
                    "examples_per_s": e2e["examples"] / e2e["window_s"],
                    "host_prep_ms": statistics.mean(
                        (e - s) * 1e3 for s, e in bench.records["prepare"])})
        out["onoff"] = rounds
    cell.release()
    text = json.dumps(out, indent=1, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    pinned(sys.argv[1:])
    sys.exit(main())
