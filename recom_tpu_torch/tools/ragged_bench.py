"""Ragged-pooling L-rung microbench: the port of
recom_tpu/tools/ragged_bench.py, driving kernel X1 directly.

Measures X1 (gather + in-order pooling, ``ops/lookup_gather.
groups_pooled``) at rowlen rungs L in {16, 32, 64, 128} on the card,
against its bound: X1 pools each bag's L slots left to right, and the
question is whether it stays memory-bound at the deep rungs or falls off
(its in-order chain of L dependent adds a bag).

Per rung: ``iters`` distinct id sets (about 30% of the slots missing, like
real list features), each launch queued behind a sleep kernel and timed by
CUDA events; X1 held against its plain version on the first set (``==``,
with equal NaN positions); the plain version's time and, as the library
yardstick, one ``F.embedding_bag`` call pooling the same bags (missing
slots at weight 0, the MEAN / SQRTN divisors folded into per-sample
weights beforehand).  Traffic: the gather reads B*C*L*d*4 B of table rows
(an upper bound: missing slots read nothing) and writes B*C*d*4 B; the
bound reads each input once (ids, the distinct rows the set touches) and
writes the output once, over 3.35 TB/s.

  python -m recom_tpu_torch.tools.ragged_bench --out RAGGED.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# H100 SXM memory rate (NVIDIA data sheet, at its 700 W limit), bytes/s
HBM_BYTES_PER_S = 3.35e12


def rung_inputs(L: int, batch: int, n_cols: int, dim: int, rows: int,
                iters: int):
    """(table [rows, dim] f32, [iters + 1] id sets [C, B, L] int32, row
    offsets, combiner codes) of one rung, from ``np.random.default_rng(L)``:
    the table first, then each set drawn in the reference's [B, C, L]
    order (about 30% of slots -1) and laid out column-major for X1."""
    rng = np.random.default_rng(L)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    offs = np.zeros(n_cols, np.int64)
    code = np.asarray([i % 3 for i in range(n_cols)], np.int32)
    sets = []
    for _ in range(iters + 1):
        ids = rng.integers(0, rows, size=(batch, n_cols, L)).astype(np.int32)
        ids[rng.random(ids.shape) < 0.3] = -1
        sets.append(np.ascontiguousarray(ids.transpose(1, 0, 2)))
    return table, sets, offs, code


def _library_call(table, ids, code):
    """One ``F.embedding_bag`` computing the same pooled bags: weights 0 at
    missing slots, 1 / n (MEAN) or 1 / sqrt(n) (SQRTN) elsewhere, made
    beforehand."""
    import torch
    import torch.nn.functional as F

    c, b, ll = ids.shape
    valid = ids >= 0
    n = valid.sum(dim=2, keepdim=True).clamp(min=1).double()
    codes = torch.as_tensor(code, device=ids.device)[:, None, None]
    scale = torch.where(codes == 1, 1.0 / n,
                        torch.where(codes == 2, 1.0 / n.sqrt(),
                                    torch.ones_like(n)))
    w = (valid * scale).float().permute(1, 0, 2).reshape(b * c, ll)
    bags = torch.where(valid, ids, torch.zeros_like(ids)).long()
    bags = bags.permute(1, 0, 2).reshape(b * c, ll).contiguous()
    w = w.contiguous()
    return lambda: F.embedding_bag(bags, table, mode="sum",
                                   per_sample_weights=w)


def bench_rung(L: int, batch: int, n_cols: int, dim: int, rows: int,
               iters: int = 24, device=None) -> dict:
    import torch

    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.ops.lookup_gather import (
        group_pooled_plain,
        groups_pooled,
    )
    from recom_tpu_torch.tools.embedding_bw import x1_consts
    from recom_tpu_torch.utils.device import resolve_device
    from recom_tpu_torch.utils.timing import calls_ms

    dev = resolve_device(device)
    table_np, sets_np, offs, code = rung_inputs(L, batch, n_cols, dim, rows,
                                                iters)
    table = torch.from_numpy(table_np).to(dev)
    sets = [torch.from_numpy(s).to(dev) for s in sets_np]

    consts = x1_consts(offs, code, dev)

    def x1(ids):
        return groups_pooled([(table, ids) + consts])[0]

    with torch.inference_mode():
        t0 = time.perf_counter()
        got = x1(sets[0])
        want = group_pooled_plain(table, sets[0], offs, code)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        same = (got == want) | (got.isnan() & want.isnan())
        if got.shape != want.shape or not bool(same.all()):
            raise AssertionError(f"ragged rung L={L}: X1 != its plain version")
        err = float((got.double() - want.double()).abs().nan_to_num().max())
        lib = _library_call(table, sets[0], code)
        lib_err = float((lib().reshape(got.shape) - got).abs().max())
        if lib_err > 1e-4:
            raise AssertionError(f"ragged rung L={L}: embedding_bag computes "
                                 f"another function ({lib_err})")

        kernels.reset_launches()
        per_ms = calls_ms(dev, [lambda s=s: x1(s) for s in sets[1:]]) / iters
        launches = kernels.launches.get("X1", 0)
        plain_ms = calls_ms(dev, [lambda s=s: group_pooled_plain(
            table, s, offs, code) for s in sets[1:4]]) / 3
        lib_ms = calls_ms(dev, [lib] * 5) / 5
        uniq = np.mean([torch.unique(s[s >= 0]).numel() for s in sets[1:]])
    per = per_ms / 1e3
    gather_bytes = batch * n_cols * L * dim * 4
    out_bytes = batch * n_cols * dim * 4
    bound_bytes = batch * n_cols * L * 4 + uniq * dim * 4 + out_bytes
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    return {
        "L": L,
        "step_ms": round(per_ms, 4),
        "gather_gbs": round(gather_bytes / per / 1e9, 1),
        "total_gbs": round((gather_bytes + out_bytes) / per / 1e9, 1),
        "per_slot_us": round(per * 1e6 / L, 3),
        "warm_compile_s": round(compile_s, 1),
        "ms": per_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "share": bound_ms / per_ms,
        "plain_ms": plain_ms,
        "library_ms": lib_ms,
        "max_abs_err": err,
        "library_max_abs_err": lib_err,
        "x1_launches": launches,
    }


def run(rungs=(16, 32, 64, 128), batch: int = 512, cols: int = 16,
        dim: int = 32, rows: int = 1 << 20, iters: int = 24,
        device=None) -> dict:
    from recom_tpu_torch.utils.device import card_line, resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from recom_tpu_torch.ops import kernels

        kernels.build_all(["pooled_gather"])
    rows_out = []
    for L in rungs:
        r = bench_rung(L, batch, cols, dim, rows, iters, device=dev)
        rows_out.append(r)
        print(json.dumps(r), flush=True)
    # verdict: memory-bound if the deep rung's gather GB/s holds >= 60% of
    # the shallow rung's (the same gather stream, a longer in-order chain)
    if len(rows_out) >= 2:
        ratio = rows_out[-1]["gather_gbs"] / max(
            1e-9, rows_out[0]["gather_gbs"]
        )
        verdict = (
            "X1 stays memory-bound at deep rungs: its in-order pooling "
            "does not limit it"
            if ratio >= 0.6 else
            "X1 falls off at deep rungs: its in-order chain of adds a bag "
            "limits it, not the gather"
        )
    else:
        ratio, verdict = None, "need >= 2 rungs"
    return {
        "workload": {
            "batch": batch, "cols": cols, "dim": dim,
            "rows": rows, "fill": 0.7,
        },
        "backend": dev.type,
        "card": card_line(dev),
        "rungs": rows_out,
        "deep_vs_shallow_bw_ratio": (
            round(ratio, 3) if ratio is not None else None
        ),
        "verdict": verdict,
        "cmd": "python -m recom_tpu_torch.tools.ragged_bench --rungs "
               + " ".join(map(str, rungs)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rungs", nargs="+", type=int,
                    default=[16, 32, 64, 128])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--cols", type=int, default=16)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = run(args.rungs, args.batch, args.cols, args.dim, args.rows,
              args.iters, device=args.device)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(out, indent=1) + "\n")
    return out


if __name__ == "__main__":
    main()
