"""Serving benchmark CLI, the reference's benchmark_multi_thread /
benchmark_throughput equivalents (recom_examples.patch:100-440): the port
of recom_tpu/tools/benchmark.py on the port's Engine.

Mirrored flags:
  --batch-size / --num-iterations / --serve-workers   (threaded serving)
  --embedding-only    fetch the concat instead of the model output
                      (reference --embedding_only, ExtractGraphConcats):
                      ``Engine.dispatch(mode=("concat",))``
  --profile           a ``torch.profiler`` trace (CPU and CUDA activity)
                      around the timed run (reference --cuda_profile /
                      --timeline): a Chrome trace in ``profile_dir`` and the
                      ten device ops with the most total time
  --sla-ms            throughput under a latency limit
                      (``runtime.server.throughput_under_sla``)
Inputs are generated spec-driven, like the reference's graph-driven
ConstructGraphInputs (patch:3363-3450).  Reports per-thread latency
p50/p99 and aggregate examples/s.

Threads share one Engine: ``dispatch`` queues a forward and returns, so N
serving workers overlap host prep with the card's work, as the reference
does with N session threads over one TF session.  Each request waits on
the card (``InFlight.wait``), with no copy of the outputs to the host.

On the card by default; ``--device cpu`` runs every kernel's plain
version.  ``--mesh DxM`` serves on a ("data", "model") mesh of D x M
ranks (recom_tpu/tools/benchmark.py:175-205): every rank runs this tool
alike, under ``torchrun --nproc-per-node N`` (each rank on its card,
NCCL), or with ``--spawn N``, which starts the N ranks itself over gloo,
all on ``--device`` (ranks sharing one card, or the CPU).  Rank 0 prints
the result.  On a mesh one serving worker dispatches, so that every
rank's collectives pair in one order.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np


def percentile(xs: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs), p))


def model_from_name(name: str):
    """``micro<N>`` | ``E`` | ``F`` | ``E@<scale>`` | ``F@<scale>`` |
    ``criteo``."""
    from recom_tpu_torch.models import (
        make_criteo_dlrm,
        make_microbenchmark_model,
        make_model_e,
        make_model_f,
    )

    if name.startswith("micro"):
        return make_microbenchmark_model(int(name[5:] or 100))
    if name == "criteo":
        return make_criteo_dlrm()
    if name.startswith("E"):
        return make_model_e(scale=float(name[2:]) if "@" in name else 1.0)
    if name.startswith("F"):
        return make_model_f(scale=float(name[2:]) if "@" in name else 1.0)
    raise SystemExit(f"unknown model {name}")


def config_for_mesh(mesh):
    """The EngineConfig for ``--mesh``: none or 1x1 is one device, DxM a
    ("data", "model") mesh of that shape."""
    from recom_tpu_torch import EngineConfig

    if mesh:
        shape = tuple(int(x) for x in mesh.split("x"))
        if shape != (1, 1):
            return EngineConfig(mesh_shape=shape)
    return EngineConfig()


def profile_summary(prof, device, wall_s: float, trace_path: str) -> Dict:
    """What a ``torch.profiler`` run saw: on the card, the ten device ops
    (kernels, copies) with the most total time, by name, with their counts,
    and the window's device-busy share (the union of device op intervals
    over the timed wall clock); ``"no device time seen"`` where the
    profiler recorded none.  On the CPU, the ten ops with the most self CPU
    time."""
    from torch.autograd import DeviceType

    if device.type != "cuda":
        avgs = sorted(prof.key_averages(),
                      key=lambda a: a.self_cpu_time_total, reverse=True)
        return {"trace": trace_path, "device": "cpu", "top_ops": [
            {"name": a.key, "count": a.count,
             "self_cpu_ms": round(a.self_cpu_time_total / 1e3, 4)}
            for a in avgs[:10]]}
    spans = []
    by_name: Dict[str, List[float]] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        if end <= start:
            continue
        spans.append((start, end))
        tot = by_name.setdefault(ev.name, [0.0, 0])
        tot[0] += end - start
        tot[1] += 1
    if not spans:
        return "no device time seen"
    spans.sort()
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    return {
        "trace": trace_path,
        "device": "cuda",
        "top_device_ops": [
            {"name": k, "count": int(v[1]), "total_ms": round(v[0] / 1e3, 4)}
            for k, v in top[:10]],
        "device_ops": int(sum(v[1] for v in by_name.values())),
        "device_busy_ms": round(busy / 1e3, 4),
        "device_busy_share": round(busy / 1e6 / wall_s, 4),
    }


def run_benchmark(
    model,
    batch_size: int = 512,
    num_iterations: int = 100,
    serve_workers: int = 1,
    embedding_only: bool = False,
    profile: bool = False,
    profile_dir: str = None,
    config=None,
    warmup: int = 10,
    params=None,
    batch_factory=None,
    device=None,
    mesh=None,
) -> Dict:
    """``params``: numpy params (default ``init_model_params``);
    ``batch_factory(seed) -> batch``: the distinct batches of the pools
    (default ``make_random_batch(model, batch_size, seed)``); ``mesh``: a
    ``parallel.Mesh`` for ``config.mesh_shape`` (every rank calls alike;
    one serving worker)."""
    import torch

    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.models import make_random_batch
    from recom_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device) if mesh is None else mesh.device
    if mesh is not None and serve_workers != 1:
        raise ValueError("on a mesh one serving worker dispatches (every "
                         "rank's collectives must pair in one order)")
    if dev.type == "cuda":
        from recom_tpu_torch.ops import kernels

        kernels.build_all()
    profile_dir = profile_dir or os.path.join(tempfile.gettempdir(),
                                              "recom_tpu_torch_profile")
    make = batch_factory or (
        lambda seed: make_random_batch(model, batch_size, seed=seed))
    eng = Engine(model, config or EngineConfig(), params=params,
                 device=None if mesh is not None else dev, mesh=mesh)
    batches = [make(1000 + w) for w in range(serve_workers)]

    mode = ("concat",) if embedding_only else ()

    def serve_once(batch):
        eng.dispatch(eng.prepare(batch), mode, fetch=False).wait()

    # the warm-up fills the allocator's caches for every worker's signature
    t0 = time.perf_counter()
    for b in batches:
        serve_once(b)
    compile_s = time.perf_counter() - t0
    for _ in range(warmup):
        serve_once(batches[0])

    lat_per_thread: List[List[float]] = [[] for _ in range(serve_workers)]
    errors: List[BaseException] = []

    # each worker rotates over a pool of DISTINCT batches (repeated ids
    # would hit in the card's L2); the pool size is capped (batch synthesis
    # is host Python), and iterations past it repeat content, reported as
    # distinct_batches_per_worker
    pool_n = min(num_iterations, 32)
    pools = [
        [batches[idx]] + [make(5000 + idx * 1000 + j)
                          for j in range(pool_n - 1)]
        for idx in range(serve_workers)
    ]
    seen_sigs = set()
    for pool in pools:
        for b in pool:
            p = eng.prepare(b)
            if p.signature not in seen_sigs:
                seen_sigs.add(p.signature)
                eng.dispatch(p, mode, fetch=False).wait()

    def worker(idx: int):
        try:
            pool = pools[idx]
            for i in range(num_iterations):
                t = time.perf_counter()
                serve_once(pool[i % len(pool)])
                lat_per_thread[idx].append(time.perf_counter() - t)
        except BaseException as e:  # surfaced after join
            errors.append(e)

    prof = None
    if profile:
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t_start = time.perf_counter()
    threads = [
        threading.Thread(target=worker, args=(i,))
        for i in range(serve_workers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(profile_dir, exist_ok=True)
        trace_path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(trace_path)
        summary = profile_summary(prof, dev, wall, trace_path)
    if errors:
        raise errors[0]

    lats = [x for per in lat_per_thread for x in per]
    total_examples = serve_workers * num_iterations * batch_size
    out = {
        "model": model.name,
        "batch_size": batch_size,
        "serve_workers": serve_workers,
        "iterations": num_iterations,
        "distinct_batches_per_worker": pool_n,
        "embedding_only": embedding_only,
        "compile_s": round(compile_s, 2),
        "latency_ms": {
            "mean": round(float(np.mean(lats)) * 1e3, 3),
            "p50": round(percentile(lats, 50) * 1e3, 3),
            "p99": round(percentile(lats, 99) * 1e3, 3),
        },
        "examples_per_s": round(total_examples / wall, 1),
        "profile_dir": profile_dir if profile else None,
    }
    if profile:
        out["profile"] = summary
    return out


def main(argv=None):
    import sys

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="micro100",
                    help="micro<N> | E | F | E@<scale> | F@<scale> | criteo")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--num-iterations", type=int, default=100)
    ap.add_argument("--serve-workers", type=int, default=1)
    ap.add_argument("--embedding-only", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--mesh", default=None,
                    help="mesh shape, e.g. 2x2 (data x model)")
    ap.add_argument("--spawn", type=int, default=None,
                    help="start this many local ranks over gloo, all on "
                         "--device (default: the ranks of torchrun's "
                         "environment)")
    ap.add_argument("--backend", default=None,
                    help="the mesh's backend (default: NCCL for ranks on "
                         "cards, gloo on the CPU and under --spawn)")
    ap.add_argument("--sla-ms", type=float, default=None,
                    help="SLA-pressure throughput mode (reference "
                         "benchmark_throughput): raise concurrency until "
                         "p99 exceeds this latency")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)

    config = config_for_mesh(args.mesh)
    mesh = None
    if config.mesh_shape is not None:
        from recom_tpu_torch.parallel import make_mesh, multihost

        if args.spawn:
            print(multihost.spawn_self("recom_tpu_torch.tools.benchmark",
                                       argv, args.device), end="")
            return None
        multihost.init_from_env(args.backend)
        mesh = make_mesh(config.mesh_shape, backend=args.backend,
                         device=args.device)
    model = model_from_name(args.model)

    if args.sla_ms is not None:
        if mesh is not None:
            raise SystemExit("--sla-ms raises concurrency: on a mesh one "
                             "worker dispatches")
        from recom_tpu_torch import Engine
        from recom_tpu_torch.models import make_random_batch
        from recom_tpu_torch.runtime.server import throughput_under_sla

        eng = Engine(model, config, device=args.device)
        batches = [
            make_random_batch(model, args.batch_size, seed=1000 + i)
            for i in range(4)
        ]
        # distinct content for every timed request, made outside its span
        result = throughput_under_sla(
            eng, batches, args.sla_ms, num_iterations=args.num_iterations,
            batch_factory=lambda k: make_random_batch(
                model, args.batch_size, seed=10_000 + k
            ),
        )
    else:
        result = run_benchmark(
            model,
            batch_size=args.batch_size,
            num_iterations=args.num_iterations,
            serve_workers=args.serve_workers,
            embedding_only=args.embedding_only,
            profile=args.profile,
            profile_dir=args.profile_dir,
            config=config,
            device=args.device,
            mesh=mesh,
        )
    from recom_tpu_torch.utils.device import card_line, resolve_device

    result["card"] = card_line(mesh.device if mesh is not None
                               else resolve_device(args.device))
    if mesh is not None:
        result["mesh"] = list(mesh.shape.values())
        result["rank"] = mesh.rank
        result["collectives_p50_ms"] = {
            k: v["p50_ms"] for k, v in mesh.timers.summary().items()}
        if mesh.rank != 0:
            return result
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
