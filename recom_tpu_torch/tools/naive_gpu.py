"""Naive-GPU baseline arm: the same model, per column and unfused, in
plain PyTorch on the same card (the port of recom_tpu/tools/naive_tpu.py).

The reference's headline compares against TF-GPU: the same accelerator
running the model without the compiler (reference README.md:29-31,
AE/build_and_run.py:57-71), which isolates the compiler's contribution
from the hardware's.  This arm is that comparison on the H100, a
straightforward PyTorch port of the feature-column graph with none of the
framework's machinery:

  * no column grouping or table stacking: one table, one gather and one
    masked pool per column (1000 of each for model E, like TF-GPU's
    thousands of small kernels); library calls throughout, since this is a
    baseline and not a kernel port;
  * no single-blob wire: every column's array crosses to the card by its
    own copy;
  * no batched host prep: one native-hash call per column (the same C++
    FarmHash the framework binds, so the comparison isolates the
    framework, not Python against C++ string hashing);
  * no compiled concat layout: ``torch.cat`` of the columns in model
    order, then the same tower (``executor.mlp_apply``).

Two kindnesses to the naive arm, both in its favour: ragged columns pad to
a static cap, and bucketize runs on the card (``torch.searchsorted``, the
TF graph's op placement).

Two forms are measured, since the card sits on the host's own bus:
``measure_naive`` (end to end: per-column host prep, per-column H2D, the
forward) and ``measure_naive_device`` (the device step alone: inputs drawn
on the card from a seed, so host prep and H2D are given to it).

Usage (on the card by default; ``--device cpu`` for the CPU):
  python -m recom_tpu_torch.tools.naive_gpu --model E --batches 32 512 2048
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch

RAGGED_CAP = 16     # static pad for ragged columns (model E/F lists <= 10)


def naive_prepare(model, batch: Dict, batch_size: int) -> Dict:
    """Per-column host prep, the naive way: one call per column, one
    output array per column, no shared staging.  Hashing uses the same
    native FarmHash as the framework; delimited columns split and hash one
    column at a time."""
    from recom_tpu_torch.ir.spec import Bucketize, HashBucket
    from recom_tpu_torch.ir.spec import FeatureKind as FK
    from recom_tpu_torch.native import ops as native_ops

    arrays: Dict[str, np.ndarray] = {}
    for col in model.columns:
        f = col.source.field
        if col.lookup is None:
            arrays[col.name] = np.asarray(
                batch[f], np.float32
            )[:batch_size]
            continue
        t0 = col.transforms[0] if col.transforms else None
        if isinstance(t0, Bucketize):
            arrays[col.name] = np.asarray(
                batch[f], np.float32
            )[:batch_size]
        elif col.source.kind == FK.DENSE_INT and isinstance(t0, HashBucket):
            v = np.asarray(batch[f], np.int64)[:batch_size]
            ids = native_ops.hash_ints(v, t0.num_buckets)
            arrays[col.name] = np.where(v == -1, -1, ids).astype(
                np.int32
            )[:, None]
        elif col.source.kind == FK.STRING and isinstance(t0, HashBucket):
            ids = native_ops.hash_strings(
                np.asarray(batch[f], dtype="S")[:batch_size], t0.num_buckets
            )
            arrays[col.name] = ids.astype(np.int32)[:, None]
        elif col.source.kind == FK.STRING_LIST and isinstance(t0, HashBucket):
            ids, _ = native_ops.split_hash_padded(
                np.asarray(batch[f], dtype="S")[:batch_size],
                col.source.delimiter, t0.num_buckets, RAGGED_CAP,
            )
            arrays[col.name] = ids.astype(np.int32)
        else:
            raise NotImplementedError(
                f"naive arm: column {col.name} chain {col.transforms}"
            )
    return arrays


def naive_params(np_params: Dict, device) -> tuple:
    """(tables, tower) of the numpy params as tensors on ``device``, one
    per table: the naive arm's own copies, placed once before timing."""
    dev = torch.device(device)
    tables = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
              for k, v in np_params["tables"].items()}
    tower = {key: [{"w": torch.from_numpy(l["w"]).to(dev),
                    "b": torch.from_numpy(l["b"]).to(dev)} for l in layers]
             for key, layers in np_params["tower"].items()}
    return tables, tower


def _build_forward(model):
    """fn(tables, tower, arrays) -> sigmoid output [B, 1]: one gather + one
    masked pool per column, concatenated in model order.  Shared by the
    end-to-end arm (host-prepared arrays) and the device-step arm (arrays
    drawn on the card), so the check against the engine covers both."""
    from recom_tpu_torch.ir.spec import Bucketize, Combiner
    from recom_tpu_torch.runtime.executor import mlp_apply

    plans = []
    for col in model.columns:
        if col.lookup is None:
            plans.append(("dense", col.name, None, None))
            continue
        t0 = col.transforms[0] if col.transforms else None
        if isinstance(t0, Bucketize):
            plans.append((
                "bucketize", col.name, col.lookup.table,
                np.asarray(t0.boundaries, np.float32),
            ))
        else:
            plans.append((
                "ids_" + (
                    "mean" if col.lookup.combiner is Combiner.MEAN else "sum"
                ),
                col.name, col.lookup.table, None,
            ))
    bounds_on = {}          # device -> each bucketize column's boundaries

    def fn(tables, tower, arrays):
        dev = next(iter(arrays.values())).device
        if dev not in bounds_on:
            bounds_on[dev] = {name: torch.from_numpy(b).to(dev)
                              for kind, name, _, b in plans
                              if kind == "bucketize"}
        bounds = bounds_on[dev]
        outs = []
        dense_parts = []
        for kind, name, tbl, _ in plans:
            x = arrays[name]
            if kind == "dense":
                dense_parts.append(x[:, None] if x.ndim == 1 else x)
                continue
            table = tables[tbl]
            if kind == "bucketize":
                ids = torch.searchsorted(bounds[name], x, right=True)
                outs.append(table[ids])                     # [B, d]
                continue
            mask = x >= 0                                   # [B, L]
            rows = table[torch.clamp(x, min=0).long()]      # [B, L, d]
            pooled = torch.where(mask[..., None], rows,
                                 torch.zeros((), device=dev)).sum(dim=1)
            if kind == "ids_mean":
                cnt = torch.clamp(mask.sum(dim=1, keepdim=True),
                                  min=1).to(torch.float32)
                pooled = pooled / cnt
            outs.append(pooled)
        emb = torch.cat(outs, dim=1)
        dense = (
            torch.cat(dense_parts, dim=1) if dense_parts
            else torch.zeros((emb.shape[0], 0), device=dev)
        )
        front = dense
        if model.tower.bottom_mlp and dense.shape[1]:
            front = mlp_apply(tower["bottom"], dense, model.tower.activation,
                              model.tower.activation)
        return mlp_apply(tower["top"], torch.cat([front, emb], dim=1),
                         model.tower.activation,
                         model.tower.final_activation)

    return fn


def build_naive_fn(model):
    """The naive forward on host-prepared arrays (``naive_prepare``, as
    tensors on the tables' device); it runs under ``torch.inference_mode``."""
    forward = _build_forward(model)

    def fn(tables, tower, arrays):
        with torch.inference_mode():
            return forward(tables, tower, arrays)

    return fn


def build_naive_device_fn(model, batch_size: int):
    """fn(tables, tower, seed) -> [B, 1]: the same per-column naive forward,
    fed by arrays drawn on the tables' device from ``seed``: only the
    device step is on the clock, with fresh content per call."""
    from recom_tpu_torch.ir.spec import Bucketize, HashBucket
    from recom_tpu_torch.ir.spec import FeatureKind as FK

    forward = _build_forward(model)
    # per-column generation spec: (name, kind, vocab/range, rowlen)
    gens = []
    for col in model.columns:
        if col.lookup is None:
            gens.append((col.name, "dense", 1.0, 1))
            continue
        t0 = col.transforms[0] if col.transforms else None
        if isinstance(t0, Bucketize):
            # spread over the full boundary range (as make_random_batch)
            gens.append((col.name, "bz",
                         float(t0.boundaries[-1]) * 1.2, 1))
        elif isinstance(t0, HashBucket):
            ll = RAGGED_CAP if col.source.kind == FK.STRING_LIST else 1
            gens.append((col.name, "ids", int(t0.num_buckets), ll))
        else:
            raise NotImplementedError(col.name)
    nf = sum(1 for _, k, _, _ in gens if k in ("dense", "bz"))
    ni = sum(1 for _, k, _, _ in gens if k == "ids")
    b = batch_size

    def fn(tables, tower, seed):
        dev = next(iter(tables.values())).device
        with torch.inference_mode():
            g = torch.Generator(device=dev)
            g.manual_seed(int(seed))
            uf = torch.rand((max(nf, 1), b), generator=g, device=dev)
            ui = torch.rand((max(ni, 1), b, RAGGED_CAP), generator=g,
                            device=dev)
            # list lengths 0..10: the end-to-end arm also sees empty lists
            # (missing rows), so this arm draws them too
            lens = torch.randint(0, 11, (max(ni, 1), b), generator=g,
                                 device=dev)
            pos = torch.arange(RAGGED_CAP, device=dev)[None, :]
            arrays = {}
            fi = ii = 0
            for name, kind, rng, ll in gens:
                if kind in ("dense", "bz"):
                    arrays[name] = uf[fi] * rng
                    fi += 1
                else:
                    ids = (ui[ii] * rng).to(torch.int32)
                    if ll == 1:
                        arrays[name] = ids[:, :1]
                    else:
                        mask = pos < lens[ii][:, None]
                        arrays[name] = torch.where(
                            mask, ids, torch.full_like(ids, -1))
                    ii += 1
            return forward(tables, tower, arrays)

    return fn


def measure_naive_device(model, np_params, batch_size: int, n: int = 24,
                         device=None, on_device=None) -> Dict:
    """The device-step-only naive cell: fresh content drawn on the card per
    call (seed-keyed), ``n`` calls timed by CUDA events around them (the
    host paces the ~5 launches a column, as it would for a caller; on the
    CPU the host clock).  ``on_device``: ``naive_params``' (tables, tower),
    placed once by the caller."""
    from recom_tpu_torch.utils.device import resolve_device
    from recom_tpu_torch.utils.timing import calls_ms, sync

    dev = resolve_device(device)
    fn = build_naive_device_fn(model, batch_size)
    tables, tower = on_device or naive_params(np_params, dev)
    t0 = time.perf_counter()
    out = fn(tables, tower, 0)
    sync(dev)
    compile_s = time.perf_counter() - t0
    if out.shape != (batch_size, 1) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"naive device step: output {tuple(out.shape)}"
                             " not finite [batch, 1]")
    per = calls_ms(dev, [lambda i=i: fn(tables, tower, i)
                         for i in range(1, n + 1)], queued=False) / n / 1e3
    return {
        "arm": "naive_gpu_device_step",
        "model": model.name,
        "batch": batch_size,
        "device_step_ms": round(per * 1e3, 3),
        "examples_per_s_device_only": round(batch_size / per, 1),
        "warm_compile_s": round(compile_s, 1),
        "distinct_inputs": n,
        "n_unfused_columns": len(model.columns),
        "protocol": "device loop timed by CUDA events, host-paced, inputs "
                    "drawn on the card from a seed per call (host prep + "
                    "H2D given to the naive arm; params on the card before "
                    "timing; list lengths drawn 0..10 against the e2e "
                    "arm's 1..10, empty rows included)",
    }


def measure_naive(model, np_params, batches: List[Dict], batch_size: int,
                  sanity_engine=None, fn=None, device=None,
                  on_device=None) -> Dict:
    """The end-to-end naive cell: per request, ``naive_prepare`` on the
    host, one H2D copy per column and the forward; an async loop that
    waits on the card every 8 requests (the framework cells' protocol),
    host clock.  ``batches[0]`` warms up; the rest are timed."""
    from recom_tpu_torch.utils.device import resolve_device
    from recom_tpu_torch.utils.timing import sync

    dev = resolve_device(device)
    if fn is None:
        fn = build_naive_fn(model)
    tables, tower = on_device or naive_params(np_params, dev)

    def request(b):
        arrays = naive_prepare(model, b, batch_size)
        return fn(tables, tower, {k: torch.from_numpy(v).to(dev)
                                  for k, v in arrays.items()})

    t0 = time.perf_counter()
    out = request(batches[0])
    sync(dev)
    compile_s = time.perf_counter() - t0
    if sanity_engine is not None:
        ref = sanity_engine.predict(batches[0])["output"]
        got = out.cpu().numpy()[: len(ref)]
        if not np.allclose(got, ref, atol=1e-4):
            raise AssertionError(
                f"naive arm disagrees with engine: max diff "
                f"{np.abs(got - ref).max()}"
            )

    t0 = time.perf_counter()
    for i, b in enumerate(batches[1:], 1):
        request(b)
        if i % 8 == 0:
            sync(dev)
    sync(dev)
    n = len(batches) - 1
    per = (time.perf_counter() - t0) / max(n, 1)

    # the host-prep share, measured apart on up to three batches
    t0 = time.perf_counter()
    for b in batches[1:4]:
        naive_prepare(model, b, batch_size)
    prep_ms = (time.perf_counter() - t0) / max(1, len(batches[1:4])) * 1e3

    return {
        "arm": "naive_gpu",
        "model": model.name,
        "batch": batch_size,
        "request_ms_async": round(per * 1e3, 3),
        "examples_per_s": round(batch_size / per, 1),
        "host_prep_ms": round(prep_ms, 3),
        "warm_compile_s": round(compile_s, 1),
        "distinct_inputs": n,
        "n_device_arrays_per_step": len(model.columns),
        "ragged_pad": RAGGED_CAP,
        "protocol": "async_serving_loop(confirm_every=8), per-column host "
                    "prep and H2D",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="E")
    ap.add_argument("--batches", nargs="+", type=int,
                    default=[32, 64, 128, 256, 512, 1024, 2048])
    ap.add_argument("--inputs", type=int, default=24)
    ap.add_argument("--sanity", action="store_true",
                    help="check the naive forward against the framework "
                         "engine on one batch per size (builds an engine)")
    ap.add_argument("--device-arm", action="store_true",
                    help="also record the device-step-only arm (host prep"
                         " + H2D given to it) at every batch size")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from recom_tpu_torch.models import (
        make_model_e, make_model_f, make_random_batch,
    )
    from recom_tpu_torch.utils.device import card_line, resolve_device
    from recom_tpu_torch.utils.params import init_model_params

    dev = resolve_device(args.device)
    kind, _, scale = args.model.partition("@")
    scale = float(scale) if scale else 1.0
    model = (make_model_e if kind == "E" else make_model_f)(scale=scale)
    np_params = init_model_params(model)
    on_device = naive_params(np_params, dev)
    fn = build_naive_fn(model)
    rows = []
    for bs in args.batches:
        n = max(9, min(args.inputs, (args.inputs * 512) // bs))
        bats = [make_random_batch(model, bs, seed=31_000 + bs + i)
                for i in range(n + 1)]
        row = measure_naive(model, np_params, bats, bs, fn=fn, device=dev,
                            on_device=on_device)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.device_arm:
            drow = measure_naive_device(model, np_params, bs, n=16,
                                        device=dev, on_device=on_device)
            rows.append(drow)
            print(json.dumps(drow), flush=True)
    if args.sanity:
        from recom_tpu_torch import Engine, EngineConfig

        eng = Engine(model, EngineConfig(), params=np_params, device=dev)
        worst = 0.0
        for bs in args.batches:
            b = make_random_batch(model, bs, seed=77 + bs)
            arrays = {k: torch.from_numpy(v).to(dev) for k, v in
                      naive_prepare(model, b, bs).items()}
            got = fn(*on_device, arrays).cpu().numpy()
            ref = eng.predict(b)["output"]
            worst = max(worst, float(np.abs(got[: len(ref)] - ref).max()))
        srow = {"sanity_max_abs_diff_vs_engine": worst,
                "sanity_tol": 1e-4, "sanity_ok": bool(worst < 1e-4)}
        if not srow["sanity_ok"]:
            raise AssertionError(f"naive arm disagrees with engine: {srow}")
        rows.append(srow)
        print(json.dumps(srow), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            cmd = (
                f"python -m recom_tpu_torch.tools.naive_gpu --model "
                f"{args.model} --batches {' '.join(map(str, args.batches))}"
            )
            json.dump({"cmd": cmd, "card": card_line(dev), "rows": rows}, f,
                      indent=1)
            f.write("\n")
    return rows


if __name__ == "__main__":
    main()
