"""Full-model device-step bandwidth attribution: the port of
recom_tpu/tools/bw_breakdown.py on the port's Engine.

Measures the queued device forward of
  (a) the FULL model,
  (b) the same columns with an IDENTITY tower (embedding only, the
      reference's --embedding_only protocol: the big concat is the output,
      recom_examples.patch:100-290), and
  (c) each lookup GROUP alone (a one-group model, identity tower, on the
      same lookup kernel the full model gives it: K1 for a one-hot group,
      X1 for the others),
each over distinct prepared batches whose inputs are already on the card,
every batch's forward enqueued once behind a sleep kernel and timed by
CUDA events, the outputs not fetched (PERF.md §2's "device forward,
queued").  Then:

  tower_ms                 = full - emb_only
  group share              = each group's step alone
  fusion/overhead residual = emb_only - sum(groups)

and each group's effective GB/s = gathered bytes / its step alone.

Usage (on the card by default; ``--device cpu`` times the plain versions
by the host clock):
  python -m recom_tpu_torch.tools.bw_breakdown --model E --batch 2048
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def _identity_tower(model):
    from recom_tpu_torch.ir.spec import TowerSpec

    return dataclasses.replace(
        model,
        tower=TowerSpec(
            arch="mlp", bottom_mlp=(), top_mlp=(),
            final_activation=None, init_seed=model.tower.init_seed,
        ),
    )


def _single_group_model(model, member_cols):
    keep = set(member_cols)
    cols = [c for c in model.columns if c.name in keep]
    tables = {
        t: s for t, s in model.tables.items()
        if any(c.lookup is not None and c.lookup.table == t for c in cols)
    }
    return dataclasses.replace(
        _identity_tower(model),
        name=f"{model.name}:g",
        tables=tables,
        columns=cols,
    )


def _params_for(model, np_params):
    """``init_model_params(model)`` with the tables taken from
    ``np_params`` (the same values: a table's init depends only on its
    spec), so no multi-GB table is drawn twice."""
    from recom_tpu_torch.utils.params import init_mlp, tower_input_dim

    t = model.tower
    tower = {}
    if t.bottom_mlp:
        tower["bottom"] = init_mlp(t.init_seed, f"{model.name}/bottom",
                                   model.dense_width, tuple(t.bottom_mlp))
    tower["top"] = init_mlp(t.init_seed, f"{model.name}/top",
                            tower_input_dim(model), tuple(t.top_mlp))
    return {"tables": {n: np_params["tables"][n] for n in model.tables},
            "tower": tower}


def _device_step(eng, batches, windows=4, pipeline=12):
    """(median per-forward ms, window ms list): each prepared batch of the
    first batch's signature staged on the device, one forward warms up,
    then windows of ``pipeline`` forwards, each batch's forward enqueued
    once, timed by CUDA events behind a sleep kernel (host clock on the
    CPU)."""
    import torch

    from recom_tpu_torch.utils.timing import calls_ms, sync

    staged, sig = [], None
    for b in batches:
        p = eng.prepare(b)
        if sig is None:
            sig = p.signature
        if p.signature == sig:
            staged.append(eng.to_device(p))
    sync(eng.device)
    with torch.inference_mode():
        eng._forward(staged[0], sig)
        timed = staged[1:]
        per = max(1, min(pipeline, len(timed) // windows))
        samples = []
        i = 0
        while i + per <= len(timed) and len(samples) < windows:
            ms = calls_ms(eng.device, [
                lambda a=a: eng._forward(a, sig) for a in timed[i: i + per]])
            samples.append(ms / per)
            i += per
    return float(np.median(samples)), [round(s, 4) for s in samples]


def _backend(g) -> str:
    return "onehot (K1)" if g.pallas_vocab is not None else "gather (X1)"


def run(model_name, batch: int, n_inputs: int = 40, params=None,
        factory=None, device=None) -> dict:
    """``model_name``: ``E[@s]``/``F[@s]`` or a ModelSpec; ``params``: its
    numpy params (default ``init_model_params``); ``factory(model, bs, n,
    seed0)``: n distinct batches (default ``make_random_batch``)."""
    import torch

    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.tools.ae_sweep import _distinct_batches, _make_model
    from recom_tpu_torch.tools.embedding_bw import peak_gbps
    from recom_tpu_torch.utils.device import card_line, resolve_device
    from recom_tpu_torch.utils.params import init_model_params

    dev = resolve_device(device)
    if dev.type == "cuda":
        from recom_tpu_torch.ops import kernels

        kernels.build_all()
    model = (_make_model(model_name) if isinstance(model_name, str)
             else model_name)
    np_params = params if params is not None else init_model_params(model)
    make = factory or _distinct_batches
    itemsize = 4

    def fresh(n, seed0):
        return make(model, batch, n, seed0)

    def release():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    out = {
        "model": model.name, "batch": batch,
        "cmd": f"python -m recom_tpu_torch.tools.bw_breakdown "
               f"--model {model.name} --batch {batch}",
        "protocol": "device-resident inputs, distinct content per forward, "
                    "windows of 12 forwards queued behind a sleep kernel, "
                    "CUDA events, outputs not fetched; identity-tower "
                    "variants isolate the embedding stage (reference "
                    "--embedding_only, recom_examples.patch:100-290)",
        "card": card_line(dev),
    }

    # (a) the full model
    eng = Engine(model, EngineConfig(), params=np_params, device=dev)
    full_ms, full_w = _device_step(eng, fresh(n_inputs, 40_000))
    groups_meta = [
        (g.gid, [m.column.name for m in g.members], g.num_columns, g.dim,
         _backend(g), g.pallas_vocab)
        for g in eng.compiled.groups
    ]
    prep = eng.prepare(fresh(1, 77_777)[0])
    rl_by_gid = dict(
        zip([g.gid for g in eng.compiled.groups], prep.rowlens)
    )
    bp = prep.batch_padded
    gathered = {
        gid: bp * ncol * rl_by_gid[gid] * dim * itemsize
        for gid, _, ncol, dim, _, _ in groups_meta
    }
    out["full_step_ms"] = round(full_ms, 4)
    out["full_windows_ms"] = full_w
    del eng
    release()

    # (b) the identity tower (embedding only)
    emb_model = _identity_tower(model)
    emb_eng = Engine(emb_model, EngineConfig(),
                     params=_params_for(emb_model, np_params), device=dev)
    emb_ms, emb_w = _device_step(emb_eng, fresh(n_inputs, 50_000))
    out["emb_only_step_ms"] = round(emb_ms, 4)
    out["emb_only_windows_ms"] = emb_w
    out["tower_ms"] = round(full_ms - emb_ms, 4)
    del emb_eng
    release()

    # (c) each group alone, on the backend the full model gives it
    rows = []
    for gid, names, ncol, dim, backend, vocab in groups_meta:
        gm = _single_group_model(model, names)
        geng = Engine(gm, EngineConfig(), params=_params_for(gm, np_params),
                      device=dev)
        gg = geng.compiled.groups
        if len(gg) != 1 or _backend(gg[0]) != backend \
                or gg[0].pallas_vocab != vocab or gg[0].num_columns != ncol:
            raise AssertionError(
                f"group {gid} alone lowers to {len(gg)} group(s) "
                f"{[(_backend(g), g.pallas_vocab, g.num_columns) for g in gg]}"
                f", not one {backend} group of {ncol} columns")
        gs, gw = _device_step(
            geng, fresh(max(14, n_inputs // 2), 60_000 + gid * 997)
        )
        del geng, gg
        release()
        rows.append({
            "gid": gid, "columns": ncol, "dim": dim,
            "kernel": backend,
            "step_ms": round(gs, 4),
            "windows_ms": gw,
            "gather_bytes": gathered[gid],
            "gbps": round(gathered[gid] / gs / 1e6, 2),
        })
    out["groups"] = rows
    sum_groups = sum(r["step_ms"] for r in rows)
    out["sum_groups_ms"] = round(sum_groups, 4)
    out["fusion_residual_ms"] = round(emb_ms - sum_groups, 4)
    total_bytes = sum(gathered.values())
    out["lookup_gbps_full"] = round(total_bytes / full_ms / 1e6, 2)
    out["lookup_gbps_emb_only"] = round(total_bytes / emb_ms / 1e6, 2)
    peak = peak_gbps(dev)
    out["hbm_peak_gbps"] = peak
    if peak is not None:
        out["emb_only_frac_of_peak"] = round(
            out["lookup_gbps_emb_only"] / peak, 3
        )
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="E")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--inputs", type=int, default=40)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args.model, args.batch, args.inputs, device=args.device)
    s = json.dumps(res, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(s + "\n")
    print(s)
    return res


if __name__ == "__main__":
    main()
