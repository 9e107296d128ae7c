"""AE-protocol latency/throughput sweep against real TF-CPU: the port of
recom_tpu/tools/ae_sweep.py on the port's Engine and ServingPipeline.

The reference's artifact-evaluation harness sweeps {models E, F} x
{batch 32..2048} x {systems} plus a serve_workers {2,4,8} throughput sweep
(reference AE/build_and_run.py:57-80).  This mirrors the matrix for
recom_tpu_torch, with the real TensorFlow-CPU baseline measured at every
cell where ``tensorflow`` imports (the artifact says so where it does not:
``tf_cpu_ms`` null and a top-level ``tf_baseline`` string with the error).

Each cell measures two serving protocols over distinct-content batches
(on the H100 distinct batches keep the 50 MB L2 honest: repeated ids into
model E's 41.9 M-row group would hit in it), both through
tools/serve_loops.loop_windows:

  * async serving loop (the headline protocol): prep + dispatch inline,
    confirming the backlog every 8 requests with one wait, so host prep of
    the next request overlaps the device's work on the last;
  * strict sync loop: prep + dispatch + one wait per request.

Request times are host clocks that end in a wait on the card.  The kernels
are built before any cell starts, so ``warm_compile_s`` is each cell's
warm-up (a dispatch of two batches, waited on), never the nvcc build.

The naive arm (``--naive-arm``, tools/naive_gpu.py) is the reference's
TF-GPU comparison: the same model, per column and unfused, on the same
card.  On a card on the host's own bus both of its forms are measurable, so
both are recorded: the device step (host prep and H2D given to it) and the
end-to-end request (per-column host prep and per-column H2D).

Usage (on the card by default; ``--device cpu`` runs the plain versions):
  python -m recom_tpu_torch.tools.ae_sweep --models E F --out AE.json
  python -m recom_tpu_torch.tools.ae_sweep --models E --workers-sweep
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from recom_tpu_torch.tools.serve_loops import loop_windows


def _make_model(name: str):
    from recom_tpu_torch.models import make_model_e, make_model_f

    kind, _, scale = name.partition("@")
    scale = float(scale) if scale else 1.0
    if kind == "E":
        return make_model_e(scale=scale)
    if kind == "F":
        return make_model_f(scale=scale)
    raise SystemExit(f"unknown model {name!r} (expected E[@s] or F[@s])")


def _distinct_batches(model, bs: int, n: int, seed0: int):
    from recom_tpu_torch.models import make_random_batch

    return [make_random_batch(model, bs, seed=seed0 + i) for i in range(n)]


def _tf_cpu_cell(tfn, make_feed, batches, iters=3):
    """Median TF-CPU latency (s) over distinct batches."""
    feeds = [make_feed(b) for b in batches[: max(2, iters)]]
    tfn(feeds[0])                       # trace + compile
    lats = []
    for f in feeds:
        t0 = time.perf_counter()
        tfn(f)
        lats.append(time.perf_counter() - t0)
    return float(np.median(lats))


def _engine(model, params, device):
    """(engine, params, build seconds) on ``device``, the kernels built
    first on the card (so no cell's warm-up holds an nvcc build)."""
    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.utils.device import resolve_device
    from recom_tpu_torch.utils.params import init_model_params

    dev = resolve_device(device)
    if dev.type == "cuda":
        from recom_tpu_torch.ops import kernels

        kernels.build_all()
    np_params = params if params is not None else init_model_params(model)
    t0 = time.perf_counter()
    eng = Engine(model, EngineConfig(), params=np_params, device=dev)
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize()
    return eng, np_params, time.perf_counter() - t0


def tf_arm(model, np_params):
    """(tf_fn, make_feed, None) of the TF-CPU baseline, or (None, None,
    error string) where it cannot be built: no ``tensorflow``, or a column
    the baseline's graph builder does not cover."""
    try:
        from recom_tpu_torch.tools.tf_baseline import build_tf_baseline

        return (*build_tf_baseline(model, np_params), None)
    except (ImportError, NotImplementedError) as e:
        return None, None, f"TF baseline unavailable: {e!r}"


def sweep_model(name: str, batches, n_inputs: int, out_rows, tf_iters=3,
                naive_arm: bool = False, params=None, factory=None,
                min_inputs: int = 10, device=None):
    """One model's latency matrix over ``batches``: a row per batch size,
    then ``{"model", "engine_build_s"}``.  Returns the TF baseline's error
    string, or None where it ran.

    ``params``: the numpy params (default ``init_model_params``);
    ``factory(model, bs, n, seed0)``: n distinct batches (default
    ``make_random_batch`` per seed); ``min_inputs``: the fewest distinct
    batches a cell's async loop serves (the sync loop serves half as many,
    at least 5)."""
    model = _make_model(name) if isinstance(name, str) else name
    make_batches = factory or _distinct_batches
    eng, np_params, build_s = _engine(model, params, device)
    tf_fn, tf_feed, tf_error = tf_arm(model, np_params)
    if naive_arm:
        from recom_tpu_torch.tools.naive_gpu import (
            build_naive_fn,
            measure_naive,
            measure_naive_device,
            naive_params,
        )

        # the naive arm's own tables, on the card once for every cell
        naive_on = naive_params(np_params, eng.device)
        naive_fn = build_naive_fn(model)

    for bs in batches:
        # distinct inputs: bounded total example volume so batch synthesis
        # does not dominate the sweep's wall time
        n = max(min_inputs, min(n_inputs, (n_inputs * 512) // bs))
        n_sync = max(5, n // 2)
        # the async and sync loops get disjoint batches; each window's
        # batches are made just before it (loop_windows' factory)
        seed_ctr = [10_000 + bs]

        def make(k):
            out = make_batches(model, bs, k, seed_ctr[0])
            seed_ctr[0] += k
            return out

        warm = make(2)
        t0 = time.perf_counter()
        for wb in warm:                 # allocator caches + rowlen hints
            eng.dispatch(eng.prepare(wb)).result()
        compile_s = time.perf_counter() - t0
        # a backlog as deep as the async loop's, so the pinned staging
        # blocks it holds in flight are cached before any timed request
        burst = [eng.dispatch(eng.prepare(warm[i % 2]), fetch=False)
                 for i in range(8)]
        burst[-1].wait()
        del warm, burst

        async_s, async_w, _ = loop_windows(
            eng, [], None, confirm_every=8, factory=make, total=n,
        )
        _, _, sync_w = loop_windows(
            eng, [], None, confirm_every=1, windows=1,
            factory=make, total=n_sync,
        )
        # per-request median: one slow request must not skew the cell
        sync_s = float(np.median(sync_w)) / 1e3

        row = {
            "model": model.name,
            "batch": bs,
            "examples_per_s": round(bs / async_s, 1),
            "request_ms_async": round(async_s * 1e3, 3),
            "async_windows_ms": async_w,
            "request_ms_sync": round(sync_s * 1e3, 3),
            "sync_windows_ms": sync_w[:10],
            "distinct_inputs": n,
            "protocol": "async_serving_loop(confirm_every=8)",
            "warm_compile_s": round(compile_s, 1),
            "tf_cpu_ms": None,
            "vs_tf_cpu": None,
        }
        if tf_fn is not None:
            tf_s = _tf_cpu_cell(
                tf_fn, tf_feed, make(max(2, tf_iters)), iters=tf_iters
            )
            row["tf_cpu_ms"] = round(tf_s * 1e3, 2)
            row["vs_tf_cpu"] = round(tf_s / async_s, 2)
        if naive_arm:
            nrow = measure_naive_device(model, np_params, bs, n=16,
                                        device=eng.device, on_device=naive_on)
            row["naive_device_step_ms"] = nrow["device_step_ms"]
            row["naive_warm_compile_s"] = nrow["warm_compile_s"]
            row["naive_protocol"] = nrow["protocol"]
            # the naive device step (its prep and H2D given to it) against
            # the framework's full request
            row["vs_naive_gpu"] = round(
                nrow["device_step_ms"] / (async_s * 1e3), 2
            )
            erow = measure_naive(model, np_params, make(9), bs, fn=naive_fn,
                                 device=eng.device, on_device=naive_on)
            row["naive_request_ms_async"] = erow["request_ms_async"]
            row["naive_host_prep_ms"] = erow["host_prep_ms"]
            row["naive_e2e_protocol"] = erow["protocol"]
            # both full requests: per-column prep and H2D against the
            # framework's one blob
            row["vs_naive_gpu_e2e"] = round(
                erow["request_ms_async"] / (async_s * 1e3), 2
            )
        out_rows.append(row)
        print(json.dumps(row), flush=True)
    out_rows.append(
        {"model": model.name, "engine_build_s": round(build_s, 1)}
    )
    return tf_error


def workers_sweep(name: str, batch: int, n_inputs: int, workers, out_rows,
                  params=None, factory=None, device=None):
    """serve_workers throughput sweep (reference AE/build_and_run.py:73-80):
    N prep workers feed one engine through ServingPipeline.

    Rungs are interleaved within each measurement window, and the rung
    order rotates per window: a shared host's clock can drift 2-4x within
    minutes, so rung-after-rung measurement would attribute the host's
    drift to the worker count.  A rung whose windows drift (last /
    first > 1.5) or whose median is 3x its best window is flagged in
    ``squall_retry`` (with its reasons); nothing is re-run."""
    from recom_tpu_torch.runtime.server import ServingPipeline

    model = _make_model(name) if isinstance(name, str) else name
    make_batches = factory or _distinct_batches
    eng, _, _ = _engine(model, params, device)
    windows = 5
    per = max(2, n_inputs // windows)
    worker_list = list(workers)

    def one_round(seed0: int, pipes) -> dict:
        chunks = {}
        for nw in worker_list:
            bats = make_batches(model, batch, windows * per + 2,
                                seed0 + nw * 7_919)
            for wb in bats[:2]:
                pipes[nw].submit(wb).result()
            chunks[nw] = bats[2:]
        samples = {nw: [] for nw in worker_list}
        for w in range(windows):
            rot = worker_list[w % len(worker_list):] + \
                worker_list[: w % len(worker_list)]
            for nw in rot:
                chunk = chunks[nw][w * per: (w + 1) * per]
                if not chunk:
                    continue
                t0 = time.perf_counter()
                futs = [pipes[nw].submit(b) for b in chunk]
                for f in futs:
                    f.result()
                samples[nw].append(
                    (time.perf_counter() - t0) / len(chunk)
                )
        return samples

    def drift_reasons(ws) -> list:
        reasons = []
        if len(ws) >= 2 and ws[0] and ws[-1] / ws[0] > 1.5:
            reasons.append(f"window_drift={round(ws[-1] / ws[0], 2)}")
        if ws and float(np.median(ws)) > 3 * min(ws):
            reasons.append("median_3x_best_window")
        return reasons

    pipes = {}
    try:
        for nw in worker_list:
            pipes[nw] = ServingPipeline(
                eng, prep_workers=nw, max_inflight=24, fetch_outputs=False
            )
        samples = one_round(77_000, pipes)
    finally:
        for p in pipes.values():
            p.close()
    for nw in worker_list:
        s = float(np.median(samples[nw]))
        reasons = drift_reasons(samples[nw])
        row = {
            "model": model.name,
            "batch": batch,
            "serve_workers": nw,
            "examples_per_s": round(batch / s, 1),
            "request_ms": round(s * 1e3, 3),
            "windows_ms": [round(x * 1e3, 3) for x in samples[nw]],
            "protocol": "thread_pipeline(interleaved windows)",
            "squall_retry": (
                {"reasons": reasons, "retried": False} if reasons else None
            ),
        }
        out_rows.append(row)
        print(json.dumps(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--models", nargs="+", default=["E@0.05"])
    ap.add_argument("--batches", nargs="+", type=int,
                    default=[32, 64, 128, 256, 512, 1024, 2048])
    ap.add_argument("--inputs", type=int, default=40,
                    help="distinct batches per cell at batch<=512 "
                         "(scaled down for bigger batches)")
    ap.add_argument("--workers-sweep", action="store_true",
                    help="serve_workers {2,4,8} throughput sweep instead "
                         "of the latency matrix")
    ap.add_argument("--workers", nargs="+", type=int, default=[2, 4, 8])
    ap.add_argument("--batch", type=int, default=512,
                    help="batch size for --workers-sweep")
    ap.add_argument("--naive-arm", action="store_true",
                    help="also measure the per-column unfused naive arm "
                         "on the same card at every cell (vs_naive_gpu, "
                         "tools/naive_gpu.py)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--out", default=None, help="write JSON artifact here")
    args = ap.parse_args(argv)

    cmd = ("python -m recom_tpu_torch.tools.ae_sweep "
           + " ".join(sys.argv[1:] if argv is None else argv))
    rows: list = []
    if args.workers_sweep:
        for name in args.models:
            workers_sweep(name, args.batch, args.inputs, args.workers, rows,
                          device=args.device)
        doc = {"cmd": cmd, "throughput_sweep": rows}
    else:
        tf_errors = []
        for name in args.models:
            err = sweep_model(name, args.batches, args.inputs, rows,
                              naive_arm=args.naive_arm, device=args.device)
            if err:
                tf_errors.append(err)
        doc = {"cmd": cmd, "sweep": rows}
        if tf_errors:
            doc["tf_baseline"] = tf_errors[0]
    from recom_tpu_torch.utils.device import card_line, resolve_device

    doc["card"] = card_line(resolve_device(args.device))
    out = json.dumps(doc, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out)
    return doc


if __name__ == "__main__":
    main()
