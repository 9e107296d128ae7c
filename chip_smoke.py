#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (recom_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from recom_tpu_torch/csrc/ and serves,
through ``Engine(..., device="cuda")``, random weights from a seed:

* full-size model E (1000 embedding columns, five 2^23 x 32 tables) with
  the default ``EngineConfig()`` (kernels K1, X1, X2) and with
  ``host_bucketize=False`` (its 880 bucketize columns bucketized on the
  card, then K1);
* the microbenchmark model at 1000 columns with random boundaries (two
  pure-bucketize one-hot groups, vocab padded to 128 and 256) with
  ``host_bucketize=False`` and with ``wire_pack=False``: raw floats reach
  the card, and K2 bucketizes and looks them up in one pass.

It checks:

1. each kernel (K1 one-id lookup, K2 fused bucketize + lookup, X1 gather +
   pooling, X2 string hashing) against its plain PyTorch version on the
   card, at the shapes its path gives it at batch 2048 (K2 also on planes
   holding NaN, +-inf, -0.0 and exact boundary values): exact equality
   (``==``, so +0 == -0); it times kernel, plain version and, where one
   exists, the one PyTorch call computing the same function
   (``library_ms``, a yardstick the port never calls), and computes the
   least time the card could take;
2. that each ``predict`` went through its path's kernels and no other:
   the launch counts are zeroed just before a predict and read just after;
3. pooled outputs of all 1000 columns against the port's NumPy oracle
   exactly, and the model output at rtol 1e-4 / atol 1e-5 (model E) or
   exactly (the microbenchmark's identity tower);
4. median ``predict`` latency of each path, and ``Engine.benchmark``'s
   step time on the microbenchmark.

The last lines of stdout are one JSON object for the kernels, the card's
name and power limit as nvidia-smi reports them, and ``{"ok": true,
"device": {...}}``.  Any failed check raises: the script then exits non-zero
and prints no result.  Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# about 0.1 s of an H100's ~2 GHz clock: long enough for the host to queue
# every timed call behind it
SLEEP_CYCLES = 200_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3,
            queued: bool = True) -> float:
    """Mean time of ``fn`` over back-to-back calls, from CUDA events.

    ``queued``: a sleep kernel first holds the card while the host enqueues
    every call, so the events see the device work alone; a wrapper's Python
    dispatch can outlast a 10 us kernel.  Unqueued, the host paces the
    calls, as it does for a real caller."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def require_launches(counts, kids, path: str, exactly=None) -> None:
    """The path launched each of its kernels ``kids`` (``exactly`` those
    counts where given) and no other kernel."""
    for kid, n in counts.items():
        if kid in kids:
            require(n > 0, f"{path}: predict did not launch kernel {kid}")
        else:
            require(n == 0, f"{path}: predict launched kernel {kid} {n} x, "
                    "which is not on its path")
    for kid, n in (exactly or {}).items():
        require(counts[kid] == n, f"{path}: kernel {kid} launched "
                f"{counts[kid]} x, expected {n}")


def check_micro(ref, out, bs: int) -> None:
    """The microbenchmark's 1000 pooled columns and its output (the
    identity tower: the concatenation) == the oracle."""
    import numpy as np

    require(len(ref["pooled"]) == 1000, "1000 pooled columns")
    bad = [c for c, r in ref["pooled"].items()
           if not np.array_equal(out["pooled"][c], r)]
    require(not bad, f"micro pooled outputs differ from the oracle: "
            f"{bad[:5]}")
    require(out["output"].shape == (bs, 8000)
            and np.array_equal(out["output"], ref["output"]),
            "micro output != oracle output")
    log(f"micro-1000 batch {bs}: pooled outputs of all 1000 columns and the "
        "output == oracle")


def latency(torch, eng, name: str, cases) -> None:
    """Median ``predict`` latency (host clock, 10 calls), its stages, and
    the device forward alone (CUDA events), for each (batch size, batch)."""
    from recom_tpu_torch.utils.logging import StageTimer

    for bs, batch in cases:
        for _ in range(2):
            eng.predict(batch)
        eng.timers = StageTimer()
        lat = []
        for _ in range(10):
            t = time.perf_counter()
            eng.predict(batch)
            lat.append((time.perf_counter() - t) * 1e3)
        log(f"{name}: predict latency batch {bs}: median "
            f"{statistics.median(lat):.3f} ms (min {min(lat):.3f}, max "
            f"{max(lat):.3f}, 10 calls; host prep + H2D + device + D2H)")
        stages = eng.timers.summary()
        log(f"  stage p50 ms (host clock): " + ", ".join(
            f"{k} {v['p50_ms']}" for k, v in sorted(stages.items())))
        prep = eng.prepare(batch)
        on_dev = eng.to_device(prep)
        fwd = lambda: eng._forward(on_dev, prep.signature)
        with torch.inference_mode():
            fwd_dev = time_ms(torch, fwd, iters=10)
            fwd_paced = time_ms(torch, fwd, iters=10, queued=False)
        log(f"  device forward (unpack + lookups + tower, CUDA events): "
            f"{fwd_dev:.4f} ms queued, {fwd_paced:.4f} ms host-paced")


def bound_ms(nbytes: float, flops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    import numpy as np
    import torch.nn.functional as F

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import make_model_e, make_random_batch
    from recom_tpu_torch.models.synthetic import make_microbenchmark_model
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.ops.hash_device import (
        hash_verbatim,
        hash_verbatim_plain,
    )
    from recom_tpu_torch.ops.lookup_gather import (
        group_pooled,
        group_pooled_plain,
    )
    from recom_tpu_torch.ops.lookup_onehot import (
        onehot_bucketize_lookup,
        onehot_bucketize_lookup_plain,
        onehot_lookup,
        onehot_lookup_plain,
    )
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.runtime.wire import _plan, wire_layout
    from recom_tpu_torch.utils.params import init_model_params

    card = card_line()
    dev = torch.device("cuda")
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # ---- phase 1: build every kernel from the checkout's sources ---------
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    t = time.perf_counter()
    paths = kernels.build_all()
    log(f"kernel build: {time.perf_counter() - t:.2f} s "
        f"({', '.join(sorted(paths))}; {nvcc})")

    # ---- full-size model E on the card ------------------------------------
    t = time.perf_counter()
    model = make_model_e(seed=0)
    np_params = init_model_params(model)
    log(f"model E params on host: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, EngineConfig(), params=np_params, device="cuda")
    torch.cuda.synchronize()
    log(f"Engine(model E, EngineConfig(), device='cuda'): "
        f"{time.perf_counter() - t:.1f} s, groups "
        + "; ".join(
            f"gid {g.gid}: {g.num_columns} cols d={g.dim} "
            f"ragged={g.ragged} onehot={g.pallas_vocab is not None} "
            f"rows={g.stacked_rows}"
            for g in eng.compiled.groups
        ))
    log(f"device memory after build: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # ---- phase 2: each kernel vs its plain version at main-path shapes ----
    batch_big = make_random_batch(model, 2048, seed=1)
    prepared = eng.prepare(batch_big)
    require(prepared.batch_padded == 2048, "batch 2048 bucket")
    bp, rowlens, wsig = (prepared.batch_padded, prepared.rowlens,
                         prepared.wsig)
    require(bool(wsig) and all(ws or wd for ws, wd in wsig[1:]),
            f"model E at 2048 should take device hashing, wsig={wsig}")
    blob = eng.to_device(prepared)["blob"]
    from recom_tpu_torch.runtime.wire import unpack_blob

    with torch.inference_mode():
        arrays = unpack_blob(eng.compiled, blob, bp, rowlens, wsig)
    layout = wire_layout(eng.compiled, bp, tuple(rowlens), True, tuple(wsig))
    by_key = {(v.gid, v.name): v for v in layout.views}
    plans = _plan(eng.compiled)

    def view(gid, name, dtype):
        v = by_key[(gid, name)]
        return blob[v.offset: v.offset + v.nbytes].view(dtype).reshape(v.shape)

    calls = {"K1": [], "K2": [], "X1": [], "X2": []}   # per-call records
    for g, packed in zip(eng.compiled.groups, arrays["groups"]):
        c = eng._consts[g.gid]
        table = eng.device_params["stacked"][str(g.gid)]
        ids, weights = eng.group_ids(g, packed)
        if g.pallas_vocab is not None:
            ids2 = ids[:, :, 0].contiguous()
            caps = c["caps"]
            kern = lambda a=(table, ids2, caps): onehot_lookup(*a)
            plain = lambda a=(table, ids2, caps): onehot_lookup_plain(*a)
            # yardstick: F.embedding over the flattened table3, missing ids
            # pointed at a zero padding plane
            cc, v, d = g.num_columns, table.shape[1], table.shape[2]
            zero_row = (table.shape[0] - 1) * v
            require(table.shape[0] > cc and
                    bool((table[-1] == 0).all()), "zero padding plane")
            clamped = torch.minimum(ids2, caps[:, None]).long()
            flat = torch.where(
                clamped >= 0,
                clamped + torch.arange(cc, device=dev)[:, None] * v,
                torch.full_like(clamped, zero_row),
            ).T.contiguous()
            t2 = table.reshape(-1, d)
            lib = lambda a=(flat, t2): F.embedding(*a)
            valid = clamped >= 0
            uniq = torch.unique(flat[valid.T]).numel()
            nbytes = ids2.numel() * 4 + cc * 4 + uniq * d * 4 + bp * cc * d * 4
            calls["K1"].append(dict(
                group=g.gid, kern=kern, plain=plain, lib=lib,
                bound=bound_ms(nbytes), shape=f"ids [{cc}, {bp}] -> "
                f"[{bp}, {cc}, {d}]",
            ))
        else:
            offs_np, codes_np = g.row_offsets, g.combiner_code
            wc_np, caps_np = g.weighted_cols, g.vocab_caps
            args = (table, ids, c["row_offsets"], c["codes"], weights,
                    c["weighted"], c["caps"])
            kern = lambda args=args: group_pooled(*args)
            plain = lambda table=table, ids=ids, weights=weights, g=g: (
                group_pooled_plain(table, ids, g.row_offsets,
                                   g.combiner_code, weights,
                                   g.weighted_cols, g.vocab_caps))
            cc, _, ll = ids.shape
            d = table.shape[1]
            clamped = torch.minimum(ids, c["caps"][:, None, None]).long()
            valid = clamped >= 0
            rows = clamped + c["row_offsets"].long()[:, None, None]
            safe = torch.where(valid, rows, torch.zeros_like(rows))
            w = valid.float() if weights is None else weights * valid
            bag_in = safe.permute(1, 0, 2).reshape(bp * cc, ll).contiguous()
            bag_w = w.permute(1, 0, 2).reshape(bp * cc, ll).contiguous()
            lib = lambda table=table, bag_in=bag_in, bag_w=bag_w: (
                F.embedding_bag(bag_in, table, mode="sum",
                                per_sample_weights=bag_w))
            nvalid = int(valid.sum())
            uniq = torch.unique(rows[valid]).numel()
            nbytes = (ids.numel() * 4 + uniq * d * 4 + bp * cc * d * 4
                      + (0 if weights is None else weights.numel() * 4))
            calls["X1"].append(dict(
                group=g.gid, kern=kern, plain=plain, lib=lib,
                bound=bound_ms(nbytes, 2.0 * nvalid * d),
                shape=f"ids [{cc}, {bp}, {ll}], table [{table.shape[0]}, "
                f"{d}] -> [{bp}, {cc}, {d}]",
            ))
        gi = g.gid
        ws, wd = wsig[gi]
        p = plans[gi]
        if ws or wd:
            name = "str" if ws else "split"
            raw = view(g.gid, f"{name}_raw", torch.uint8)
            widths = view(g.gid, f"{name}_w", torch.int32)
            if ws:
                bk = torch.as_tensor(p.str_buckets, device=dev)
                dl, wbk, rl = None, ws, 1
            else:
                bk = torch.as_tensor(p.fast_buckets, device=dev)
                dl = torch.as_tensor(p.fast_delims_np, device=dev)
                wbk, rl = wd, rowlens[gi]
            n = raw.shape[0]
            kern = lambda a=(raw, widths, bk, dl, bp, wbk, rl): (
                hash_verbatim(*a))
            plain = lambda a=(raw, widths, bk, dl, bp, wbk, rl): (
                hash_verbatim_plain(*a))
            wsum = int(widths.long().sum())
            nbytes = wsum * bp + n * 4 + n * 8 + n * bp * rl * 4
            calls["X2"].append(dict(
                group=g.gid, kern=kern, plain=plain, lib=None,
                bound=bound_ms(nbytes),
                shape=f"{n} cols x {bp} rows, width bucket {wbk}, L={rl}",
            ))

    # K2's path: the microbenchmark model at 1000 columns, raw floats on
    # the card (wire blob, host_bucketize=False)
    t = time.perf_counter()
    micro = make_microbenchmark_model(1000, random_boundary=True, seed=0)
    micro_params = init_model_params(micro)
    eng_mb = Engine(micro, EngineConfig(host_bucketize=False),
                    params=micro_params, device="cuda")
    torch.cuda.synchronize()
    log(f"Engine(micro-1000, host_bucketize=False): "
        f"{time.perf_counter() - t:.1f} s, groups " + "; ".join(
            f"gid {g.gid}: {g.num_columns} cols V_pad={g.pallas_vocab}"
            for g in eng_mb.compiled.groups))
    mb_big = make_random_batch(micro, 2048, seed=1)
    prep_mb = eng_mb.prepare(mb_big)
    require(prep_mb.batch_padded == 2048, "micro batch 2048 bucket")
    with torch.inference_mode():
        mb_arrays = unpack_blob(eng_mb.compiled,
                                eng_mb.to_device(prep_mb)["blob"], 2048,
                                prep_mb.rowlens, prep_mb.wsig)
    for g, packed in zip(eng_mb.compiled.groups, mb_arrays["groups"]):
        c = eng_mb._consts[g.gid]
        require("bz_hi" in c and "raw_bz" in packed,
                f"micro group {g.gid} should take K2")
        table = eng_mb.device_params["stacked"][str(g.gid)]
        raw = packed["raw_bz"].contiguous()
        a = (table, raw, c["bz_lo"], c["bz_hi"], c["bz_counts"])
        cc, bp_mb = raw.shape
        v, d = table.shape[1], table.shape[2]
        require(raw.dtype == torch.float32 and bp_mb == 2048
                and cc == g.num_columns, "raw_bz is f32 [n_bz, Bp]")
        # the specials, in a copy: NaN, +-inf, -0.0, +0.0, each column's
        # boundaries exactly, and the float just below each
        cnt = c["bz_counts"][:cc, 0].long()
        hi = c["bz_hi"][:cc]
        special = raw.clone()
        special[:, 0:5] = torch.tensor(
            [float("nan"), float("inf"), float("-inf"), -0.0, 0.0],
            device=dev)
        pick = (torch.arange(64, device=dev)[None, :] * 7) % cnt[:, None]
        hits = hi.gather(1, pick)                        # [C, 64]
        special[:, 5:69] = hits
        special[:, 69:133] = torch.nextafter(
            hits, torch.full_like(hits, float("-inf")))
        sa = (table, special) + a[2:]
        got, want = onehot_bucketize_lookup(*sa), \
            onehot_bucketize_lookup_plain(*sa)
        torch.cuda.synchronize()
        require(bool((got.view(torch.int32) == want.view(torch.int32)).all()),
                f"K2 group {g.gid}: kernel != plain on the special values")
        log(f"K2 group {g.gid}: kernel == plain bit for bit on NaN, +-inf, "
            "-0.0, +0.0, 64 boundary values per column and the floats "
            "below them")
        # bytes this run's data needs: raw, counts and boundaries read, the
        # distinct rows selected, the output written
        ids = torch.searchsorted(hi, raw, right=True)
        ids = torch.where(raw < float("inf"), torch.minimum(ids, cnt[:, None]),
                          cnt[:, None])
        uniq = torch.unique(
            ids + torch.arange(cc, device=dev)[:, None] * v).numel()
        nbytes = (raw.numel() * 4 + cc * 4 + int(cnt.sum()) * 4
                  + uniq * d * 4 + bp_mb * cc * d * 4)
        calls["K2"].append(dict(
            group=g.gid, kern=lambda a=a: onehot_bucketize_lookup(*a),
            plain=lambda a=a: onehot_bucketize_lookup_plain(*a), lib=None,
            bound=bound_ms(nbytes),
            shape=f"raw [{cc}, {bp_mb}], V_pad {v} -> [{bp_mb}, {cc}, {d}]",
        ))

    kernel_meta = {
        "K1": ("recom_tpu_torch/csrc/onehot_lookup.cu",
               "recom_tpu/ops/lookup_pallas.py:36"),
        "K2": ("recom_tpu_torch/csrc/onehot_bucketize.cu",
               "recom_tpu/ops/lookup_pallas.py:92"),
        "X1": ("recom_tpu_torch/csrc/pooled_gather.cu",
               "recom_tpu/ops/lookup_xla.py:185"),
        "X2": ("recom_tpu_torch/csrc/hash_device.cu",
               "recom_tpu/ops/hash_device.py:234"),
    }
    results = {}
    with torch.inference_mode():
        for kid, recs in calls.items():
            require(bool(recs), f"no main-path call of {kid}")
            err = 0.0
            tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
            bound_by = set()
            for r in recs:
                a, b = r["kern"](), r["plain"]()
                torch.cuda.synchronize()
                require(a.shape == b.shape and a.dtype == b.dtype,
                        f"{kid} group {r['group']}: shape/dtype mismatch")
                e = float((a.double() - b.double()).abs().max()) \
                    if a.numel() else 0.0
                require(bool((a == b).all()),
                        f"{kid} group {r['group']}: kernel != plain "
                        f"(max abs err {e})")
                err = max(err, e)
                ms = time_ms(torch, r["kern"])
                paced = time_ms(torch, r["kern"], queued=False)
                pms = time_ms(torch, r["plain"], iters=5, warmup=1)
                lms = None
                if r["lib"] is not None:
                    ref = r["lib"]()
                    close = torch.allclose(
                        ref.reshape(a.shape), a, rtol=1e-5, atol=1e-6)
                    require(close, f"{kid} group {r['group']}: library "
                            "yardstick computes another function")
                    lms = time_ms(torch, r["lib"])
                    tot["library_ms"] += lms
                bms, by = r["bound"]
                bound_by.add(by)
                tot["ms"] += ms
                tot["plain_ms"] += pms
                tot["bound_ms"] += bms
                log(f"{kid} group {r['group']} ({r['shape']}): kernel "
                    f"{ms:.4f} ms (host-paced {paced:.4f} ms), plain "
                    f"{pms:.4f} ms, library "
                    f"{'-' if lms is None else f'{lms:.4f} ms'}, bound "
                    f"{bms:.4f} ms ({by}), exact")
            has_lib = any(r["lib"] is not None for r in recs)
            results[kid] = dict(
                err=err, bound_by="bytes" if "bytes" in bound_by
                else "operations",
                lib=tot["library_ms"] if has_lib else None, **tot,
            )

    # ---- phase 3: the main path, counted --------------------------------
    batch_small = make_random_batch(model, 512, seed=2)
    kernels.reset_launches()
    out = eng.predict(batch_small, return_pooled=True)
    torch.cuda.synchronize()
    counts_512 = dict(kernels.launches)
    log(f"launches in predict(batch 512): {counts_512}")
    require_launches(counts_512, ("K1", "X1", "X2"), "model E")
    require(out["output"].shape == (512, 1), "output shape")
    require(bool(np.isfinite(out["output"]).all()), "finite outputs")

    t = time.perf_counter()
    ref = OracleModel(model, np_params).forward(batch_small)
    log(f"oracle forward (batch 512): {time.perf_counter() - t:.1f} s")
    require(len(ref["pooled"]) == 1000, "1000 pooled columns")
    bad = [c for c, r in ref["pooled"].items()
           if not np.array_equal(out["pooled"][c], r)]
    require(not bad, f"pooled outputs differ from the oracle: {bad[:5]}")
    np.testing.assert_allclose(out["output"], ref["output"], rtol=1e-4,
                               atol=1e-5)
    log("pooled outputs of all 1000 columns == oracle; output within "
        "rtol 1e-4 / atol 1e-5 "
        f"(max abs diff {float(np.abs(out['output'] - ref['output']).max()):.3g})")

    kernels.reset_launches()
    out_big = eng.predict(batch_big)
    torch.cuda.synchronize()
    counts_2048 = dict(kernels.launches)
    log(f"launches in predict(batch 2048): {counts_2048}")
    require_launches(counts_2048, ("K1", "X1", "X2"), "model E")
    require(out_big["output"].shape == (2048, 1)
            and bool(np.isfinite(out_big["output"]).all()),
            "batch 2048 output")

    # ---- phase 4: predict latency and where it goes ----------------------
    latency(torch, eng, "model E", ((512, batch_small), (2048, batch_big)))

    # ---- phase 5: model E with device bucketize (then K1), counted --------
    t = time.perf_counter()
    eng_bz = Engine(model, EngineConfig(host_bucketize=False),
                    params=np_params, device="cuda")
    torch.cuda.synchronize()
    log(f"Engine(model E, host_bucketize=False): "
        f"{time.perf_counter() - t:.1f} s")
    kernels.reset_launches()
    out_bz = eng_bz.predict(batch_small, return_pooled=True)
    torch.cuda.synchronize()
    counts_bz = dict(kernels.launches)
    log(f"launches in predict(batch 512), host_bucketize=False: {counts_bz}")
    require_launches(counts_bz, ("K1", "X1", "X2"), "model E, device bz")
    bad = [c for c, r in ref["pooled"].items()
           if not np.array_equal(out_bz["pooled"][c], r)]
    require(not bad, f"device-bucketize pooled outputs differ from the "
            f"oracle: {bad[:5]}")
    np.testing.assert_allclose(out_bz["output"], ref["output"], rtol=1e-4,
                               atol=1e-5)
    log("host_bucketize=False: pooled outputs of all 1000 columns == oracle; "
        "output within rtol 1e-4 / atol 1e-5 (max abs diff "
        f"{float(np.abs(out_bz['output'] - ref['output']).max()):.3g})")
    latency(torch, eng_bz, "model E, host_bucketize=False",
            ((512, batch_small), (2048, batch_big)))
    log(f"peak device memory (two model E engines): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- phase 6: the microbenchmark path, K2 only, counted ---------------
    t = time.perf_counter()
    ref_mb = OracleModel(micro, micro_params).forward(mb_big)
    log(f"oracle forward (micro-1000, batch 2048): "
        f"{time.perf_counter() - t:.1f} s")
    kernels.reset_launches()
    out_mb = eng_mb.predict(mb_big, return_pooled=True)
    torch.cuda.synchronize()
    counts_mb = dict(kernels.launches)
    log(f"launches in predict(micro-1000, batch 2048): {counts_mb}")
    require_launches(counts_mb, ("K2",), "micro-1000", exactly={"K2": 2})
    check_micro(ref_mb, out_mb, 2048)
    latency(torch, eng_mb, "micro-1000, host_bucketize=False",
            ((2048, mb_big),))
    mb_batches = [mb_big] + [make_random_batch(micro, 2048, seed=10 + i)
                             for i in range(4)]
    bench = eng_mb.benchmark(mb_batches, iters=20, warmup=3)
    log(f"Engine.benchmark(micro-1000, batch 2048, 20 steps over 4 "
        f"batches): latency_ms {bench['latency_ms']:.4f}, examples_per_s "
        f"{bench['examples_per_s']:.0f} (H2D + device forward)")
    report = eng_mb.stats_report()
    log(f"stats_report: programs_compiled {report['programs_compiled']}, "
        f"backends {[g['backend'] for g in report['groups']]}")

    eng_st = Engine(micro, EngineConfig(wire_pack=False),
                    params=micro_params, device="cuda")
    mb_small = make_random_batch(micro, 512, seed=3)
    ref_st = OracleModel(micro, micro_params).forward(mb_small)
    kernels.reset_launches()
    out_st = eng_st.predict(mb_small, return_pooled=True)
    torch.cuda.synchronize()
    counts_st = dict(kernels.launches)
    log(f"launches in predict(micro-1000, batch 512), wire_pack=False: "
        f"{counts_st}")
    require_launches(counts_st, ("K2",), "micro-1000 structured",
                     exactly={"K2": 2})
    check_micro(ref_st, out_st, 512)
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")

    line = {"kernels": [
        {
            "name": kid, "route": "cuda",
            "source": kernel_meta[kid][0], "replaces": kernel_meta[kid][1],
            "launches": (counts_mb if kid == "K2" else counts_2048)[kid],
            "max_abs_err": results[kid]["err"],
            "ms": results[kid]["ms"], "plain_ms": results[kid]["plain_ms"],
            "bound_ms": results[kid]["bound_ms"],
            "bound_by": results[kid]["bound_by"],
            "library_ms": results[kid]["lib"],
        }
        for kid in ("K1", "K2", "X1", "X2")
    ]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
