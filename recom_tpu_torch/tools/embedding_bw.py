"""Embedding-only lookup-bandwidth benchmark: the port of
recom_tpu/tools/embedding_bw.py on the port's Engine and kernel X1.

Reference analogue: ``benchmark_multi_thread --embedding_only`` fetches the
big concat instead of the model output so only the lookup machinery is
timed (recom_examples.patch:100-290).  The question here is narrower:
what fraction of the card's memory rate does the row gather reach on the
largest gather group (the memory-bound lookup)?

Method: random ids on the card, then rounds of lookups queued back to
back, the ids perturbed on the card before each round (so no round
repeats another's rows), timed by CUDA events behind a sleep kernel.
Three variants:

* ``gather``  - a plain ``index_select`` of the stacked table: the
  speed-of-light yardstick, not a kernel port.
* ``pooled``  - the production X1 launch (``ops/lookup_gather.
  groups_pooled``): gather + masked in-order combiner, what serving runs.
* ``perturb`` - the id arithmetic alone, which both rounds include.

Bytes counted = rows gathered x row bytes per round (ids and outputs
excluded: the metric is table-read bandwidth, as the reference counts
fetch bytes).  The share is of the card's data-sheet memory rate
(``peak_gbps``), with the power limit beside it.

Usage (on the card by default):
  python -m recom_tpu_torch.tools.embedding_bw --model E --batch 2048
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np

# memory rate by torch.cuda.get_device_name() prefix (GB/s): NVIDIA's data
# sheet, H100 SXM (HBM3), at its 700 W limit
_PEAK_GBPS = {
    "NVIDIA H100": 3350.0,
}

# the odd Weyl constant of the reference's per-round id perturbation
WEYL = 1566083941


def peak_gbps(device) -> Optional[float]:
    """The card's data-sheet memory rate in GB/s, None for any other card
    and for the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(torch.device(device))
    for k, v in _PEAK_GBPS.items():
        if name.startswith(k):
            return v
    return None


def perturb(ids0, i: int, rows: int):
    """The round-``i`` ids of int64 ``ids0``: ``(ids0 + i * WEYL) % rows``
    in int64 (no int32 wrap; the floor ``%`` keeps them in [0, rows))."""
    return (ids0 + i * WEYL) % rows


def bench_group(eng, batch: Dict) -> Dict:
    """The largest-stacked-bytes group on the gather (non-one-hot) path of
    ``eng`` and the bench's inputs on its device: ``table`` (as stored),
    ``rows_t`` (its rows), ``rows``, ``d``, ``row_bytes``, ``n_gather`` a
    round, ``offsets`` (zeros: the ids span the whole stack), ``comb`` (the
    combiner codes) and ``ids0`` ([C, Bp, L] int64 from seed 11)."""
    import torch

    from recom_tpu_torch.ops.quant import QuantizedTable

    cand = [
        g for g in eng.compiled.groups if g.pallas_vocab is None
    ] or list(eng.compiled.groups)
    g = max(cand, key=lambda g: g.stacked_rows * g.dim)
    table = eng.device_params["stacked"][str(g.gid)]
    rows_t = table.q if isinstance(table, QuantizedTable) else table
    rows, d = int(rows_t.shape[0]), int(rows_t.shape[1])
    if isinstance(table, QuantizedTable):
        row_bytes = d + 4          # int8 row + the f32 per-row scale
    else:
        row_bytes = d * rows_t.element_size()
    prep = eng.prepare(batch)
    bp = prep.batch_padded
    rl = dict(zip([q.gid for q in eng.compiled.groups], prep.rowlens))[g.gid]
    c = g.num_columns
    rng = np.random.Generator(np.random.PCG64(11))
    return dict(
        gid=g.gid, table=table, rows_t=rows_t, rows=rows, d=d,
        row_bytes=row_bytes, n_gather=bp * c * rl,
        offsets=np.zeros(c, np.int64), comb=np.asarray(g.combiner_code),
        x1_consts=x1_consts(np.zeros(c, np.int64), g.combiner_code,
                            eng.device),
        ids0=torch.from_numpy(rng.integers(
            0, rows, size=(c, bp, rl), dtype=np.int64)).to(eng.device),
    )


def x1_consts(row_offsets, combiner_code, device) -> tuple:
    """X1's per-column arguments after the table and ids (row offsets,
    combiner codes, no weights, unweighted rounding, no clamp), as tensors
    on ``device`` once: given as host arrays, each launch would first copy
    them to the card."""
    import torch

    c = len(combiner_code)
    return (torch.as_tensor(np.asarray(row_offsets), dtype=torch.int32,
                            device=device),
            torch.as_tensor(np.asarray(combiner_code), dtype=torch.int32,
                            device=device),
            None,
            torch.zeros(c, dtype=torch.uint8, device=device),
            torch.full((c,), np.iinfo(np.int32).max, dtype=torch.int32,
                       device=device))


def embedding_only_bench(
    eng, batch: Dict, rounds: int = 32, windows: int = 5,
) -> Dict:
    """One JSON-able dict: gather GB/s, pooled GB/s, fraction of the card's
    memory rate; one pooled round held against X1's plain version on the
    same ids (``==``, NaN where it has NaN), raising where they differ."""
    import torch

    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.ops.lookup_gather import (
        group_pooled_plain,
        groups_pooled,
    )
    from recom_tpu_torch.utils.device import card_line
    from recom_tpu_torch.utils.timing import calls_ms

    dev = eng.device
    gb = bench_group(eng, batch)
    table, rows_t, rows, d = gb["table"], gb["rows_t"], gb["rows"], gb["d"]
    row_bytes, n_gather = gb["row_bytes"], gb["n_gather"]
    offsets, comb, ids0 = gb["offsets"], gb["comb"], gb["ids0"]
    consts = gb["x1_consts"]
    flat_out = torch.empty((n_gather, d), dtype=rows_t.dtype, device=dev)

    def round_ids(i):           # X1 reads int32 ids
        return perturb(ids0, i, rows).to(torch.int32)

    variants = {
        "gather": lambda i: torch.index_select(
            rows_t, 0, perturb(ids0, i, rows).reshape(-1), out=flat_out),
        "pooled": lambda i: groups_pooled(
            [(table, round_ids(i)) + consts]),
        "perturb": round_ids,
    }
    results = {}
    salt = [0]
    launches = {}
    with torch.inference_mode():
        for name, fn in variants.items():
            fn(0)                                   # warm-up
            kernels.reset_launches()
            samples = []
            for _ in range(windows):
                salt[0] += rounds
                base = salt[0]
                ms = calls_ms(dev, [lambda i=i: fn(base + i)
                                    for i in range(rounds)])
                samples.append(ms / rounds)
            launches[name] = dict(kernels.launches)
            step_ms = float(np.median(samples))
            results[name] = {
                "gbps": round(n_gather * row_bytes / step_ms / 1e6, 2),
                "step_us": round(step_ms * 1e3, 2),
                "windows_us": [round(s * 1e3, 2) for s in samples],
            }
        results["perturb"].pop("gbps")
        ids = round_ids(salt[0] + 1)
        got = groups_pooled([(table, ids) + consts])[0]
        want = group_pooled_plain(table, ids, offsets, comb)
        same = (got == want) | (got.isnan() & want.isnan())
        if got.shape != want.shape or not bool(same.all()):
            raise AssertionError(
                "embedding_bw: X1's pooled round != its plain version")
    results["pooled"]["x1_launches"] = launches["pooled"].get("X1", 0)

    peak = peak_gbps(dev)
    return {
        "metric": "embedding_lookup_gbps",
        "value": results["gather"]["gbps"],
        "unit": "GB/s",
        "vs_baseline": (
            round(results["gather"]["gbps"] / peak, 3)
            if peak is not None else None
        ),
        "detail": {
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "card": card_line(dev),
            "hbm_peak_gbps": peak,
            "table_rows": rows,
            "table_dim": d,
            "table_bytes": rows * row_bytes,
            "rows_gathered_per_step": n_gather,
            "bytes_per_step": n_gather * row_bytes,
            "gather": results["gather"],
            "pooled": results["pooled"],
            "perturb": results["perturb"],
            "pooled_vs_peak": (
                round(results["pooled"]["gbps"] / peak, 3)
                if peak is not None else None
            ),
            "pooled_equals_plain": True,
            "group_gid": gb["gid"],
            "rounds_per_window": rounds,
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="E")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.models import make_random_batch
    from recom_tpu_torch.tools.ae_sweep import _make_model

    model = _make_model(args.model)
    eng = Engine(model, EngineConfig(), device=args.device)
    res = embedding_only_bench(eng, make_random_batch(model, args.batch,
                                                      seed=0),
                               rounds=args.rounds)
    s = json.dumps(res, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(s + "\n")
    print(s)
    return res


if __name__ == "__main__":
    main()
