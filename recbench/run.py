"""Run one cell of the benchmark and print its result line.

    python3 -m recbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``recom_tpu_torch``)
and ``BENCHMARK.json``.  One run is one process: it loads the program's
kernels from its in-checkout build cache (building them on a fresh
checkout), makes the weights and the traffic from the seed, builds and
warms the program, measures for ``--seconds``, frees the program and holds
what the timed path returned to the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics and a breakdown of the device's time (``--trace 1``, the window
under ``torch.profiler``), ``device``, and last ``checks``, each number
compared beside its limit, which also end standard error.

It needs as many CUDA cards as the cell asks for, and prints no result
where there are fewer, where a module of JAX or of the JAX package is
loaded once the window has closed, or where the checkout holds no program.
"""

import os
import sys
import time

T_PROCESS = float(os.environ.get("RECBENCH_T_PROCESS", time.perf_counter()))

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import types  # noqa: E402
from typing import Dict, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "recom_tpu")


def log(msg: str) -> None:
    print(f"[recbench] {msg}", file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``recom_tpu_torch`` is not ``recom_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _cache_dirs() -> None:
    """Build caches at fixed paths inside the checkout."""
    from recbench import spec

    base = os.path.join(spec.ROOT, "recbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def run_cell(name: str, work: Dict, cfg: Dict, mix: Dict, bench: Dict,
             seed: int, seconds: float, trace: bool, device,
             t_process: Optional[float] = None) -> Dict:
    """One run of a cell; returns the result object.  ``work``, ``cfg``,
    ``mix`` and ``bench`` are the cell's, the configuration's, the mix's
    and the benchmark's data; ``device`` is where the program runs."""
    import torch

    from recbench import check, hardware, port, spec
    from recbench.counts import model as counts

    t_process = time.perf_counter() if t_process is None else t_process
    kind = importlib.import_module(f"recbench.traffic.{mix['kind']}")
    cell = kind.Cell(cfg, mix, seed, device, log)
    cuda = torch.device(device).type == "cuda"
    parts: Dict[str, float] = {}
    t = time.perf_counter()
    port.program()
    if cuda:
        port.load_kernels()
    parts["kernels_s"] = time.perf_counter() - t
    cell.setup()
    parts.update(cell.parts)
    spans = None
    if trace:
        spans = port.Spans()
        cell.traced(spans)
    # set-up's objects leave the collector's generations, so that a
    # collection in the window walks only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_process
    for k, v in parts.items():
        log(f"setup.{k} {v!r}")
    log(f"setup_s {setup_s!r}")
    summary = None
    if trace:
        from recbench.trace import Tracer

        with Tracer() as tracer:
            cell.window(seconds)
        summary = tracer.summary(spans.records)
    else:
        cell.window(seconds)
    gc.unfreeze()
    peak = cell.memory_peak()
    forwards, attempted, failed = cell.forwards, cell.attempted, cell.failed
    e2e = cell.end_to_end()
    log(f"window: {attempted} attempted, {failed} failed, {e2e!r}")
    cell.release()
    t = time.perf_counter()
    numbers = cell.numbers()
    log(f"reference_s {time.perf_counter() - t!r}; numbers {numbers!r}")
    run = types.SimpleNamespace(
        kind=cell.kind, setup_s=setup_s, e2e=e2e, trace=summary,
        spans=spans.records if spans else None, forwards=forwards,
        counts=None, peaks=None)
    if trace and cuda:
        card = hardware.smi()
        run.counts = counts.pool_counts(cfg, cell.pool)
        run.peaks = {"flops": hardware.F32_FLOPS,
                     "bytes_per_s": hardware.HBM_BYTES_PER_S,
                     "int32_ops_per_s": hardware.int32_ops_per_s(device,
                                                                 card)}
    metrics = {}
    for m in spec.cell_metrics(bench, name, trace):
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    verdict = check.judge(numbers, work["limits"])
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": verdict["correct"], "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = verdict["checks"]
    return result


def host_threads(work: str) -> int:
    """Native threads a host-prep call may start: the cell's mix's
    ``host_threads`` where it names them (the training mixes: 1, PERF.md
    §2); else the cores this process may use over the prep workers the mix
    runs at once (one where it names none), at most 4, the program's own
    cap, and at least 1, so the workers' threads never outnumber the
    cores."""
    from recbench import spec

    mix = spec.mix(spec.workload(work)["traffic"])
    if "host_threads" in mix:
        return int(mix["host_threads"])
    workers = mix.get("prep_workers", 1)
    return max(1, min(4, len(os.sched_getaffinity(0)) // workers))


def pinned_process(argv) -> None:
    """Run under ``PYTHONHASHSEED=0`` and with the host's threads capped
    (``host_threads``: the program's ``RECOM_TPU_NATIVE_THREADS``, and
    OpenMP's for torch's own CPU work): re-execute this process once with
    them set, keeping its start time.  String hashing, and with it the
    order of the program's sets and the layout of its dicts, is otherwise
    drawn anew in every process, and runs of one cell then differ by 10-20%
    in rate (PERF.md, run L); prep workers that each start up to 4 threads
    on a machine of 8 cores crowd each other out."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    known, _ = p.parse_known_args(argv)
    want = {"PYTHONHASHSEED": "0"}
    if known.workload:
        n = str(host_threads(known.workload))
        want.update(RECOM_TPU_NATIVE_THREADS=n, OMP_NUM_THREADS=n)
    if all(os.environ.get(k) == v for k, v in want.items()):
        return
    env = dict(os.environ, RECBENCH_T_PROCESS=repr(T_PROCESS), **want)
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(sys.executable, [sys.executable, "-m", "recbench.run"]
              + list(argv), env)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from recbench import spec

    _cache_dirs()
    bench = spec.benchmark()
    work = spec.workload(args.workload)
    cfg = spec.config(work["config"])
    mix = spec.mix(work["traffic"])

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < work["chips"]:
        log(f"needs {work['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    from recbench import hardware

    card = hardware.smi()
    log(f"card {torch.cuda.get_device_name(0)}, power.limit "
        f"{card.get('power.limit')} W, clocks.max.sm "
        f"{card.get('clocks.max.sm')} MHz; host cores "
        f"{hardware.host_cores()}, native threads "
        f"{os.environ.get('RECOM_TPU_NATIVE_THREADS')}; torch "
        f"{torch.__version__}")
    result = run_cell(args.workload, work, cfg, mix, bench, args.seed,
                      args.seconds, bool(args.trace), "cuda:0", T_PROCESS)
    bad = loaded_forbidden()
    if bad:
        log(f"modules loaded that the benchmark must not load: {bad}")
        return 3
    from recbench.check import print_checks

    print_checks(result["checks"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    pinned_process(sys.argv[1:])
    sys.exit(main())
