"""Sharded-lookup scaling sweep: the port of recom_tpu/tools/scaling.py.

Sweeps model-axis sizes m in {1, 2, 4, ...} over the ranks of a
torch.distributed world, holding the table rows each rank holds constant
(weak scaling: a 2x bigger mesh serves a 2x bigger table at the same
batch), and reports examples/s and efficiency = throughput(m) /
throughput(1), and against the first mesh that pays for collectives
(m = 2).  ``wire_model`` (copied verbatim) counts the bytes each rank
moves across the model axis a step; ``link_roofline`` projects the
efficiency those bytes allow over a link of a given rate, the JAX
package's ``ici_roofline`` with the rate a parameter (default: an H100
SXM's NVLink, 900 GB/s in both directions together, 450 each way, from
NVIDIA's data sheet).

Every rank runs it alike (``sweep``): under ``torchrun --nproc-per-node
N``, or with ``--spawn N``, which starts the N ranks itself over gloo,
all on ``--device`` (ranks sharing one card, or the CPU: a measurement
of the code paths and of gloo's host round trips, not of NCCL over
NVLink).  The mesh of size m is the world's first m ranks; the others
wait.

  python -m recom_tpu_torch.tools.scaling --spawn 2 --device cpu \\
      --rows-per-shard 65536 --dim 64

Not ported: ``allgather_elision_probe``, which counts all-gathers in the
HLO XLA compiles for two consumers of the exchange's output; the port
compiles no program, and its Engine gathers the exchange's rows over the
model axis in every case.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# per-direction NVLink rate of an H100 SXM, GB/s (900 GB/s both ways)
H100_NVLINK_GBPS = 450.0


def _submesh(m: int, backend, device):
    """The (1, m) mesh of the world's first m ranks, or None on a rank
    outside it (every rank makes the subgroups alike)."""
    from recom_tpu_torch.parallel import make_mesh

    try:
        return make_mesh((1, m), backend=backend, device=device)
    except ValueError as e:
        if "outside" not in str(e):
            raise
        return None


def sweep(
    rows_per_shard: int = 1 << 16,
    dim: int = 64,
    batch: int = 1024,
    n_columns: int = 16,
    rowlen: int = 1,
    iters: int = 20,
    comm: str = "all_to_all",
    mesh_sizes=None,
    chunks: int = 1,
    device=None,
    backend=None,
):
    """recom_tpu/tools/scaling.py:27-166 on the ranks of an initialised
    world: one row a model-axis size on rank 0, None elsewhere.  The table
    is made from seed m on every rank, each rank keeps its stripe; the ids
    are made anew for every timed call (``iters`` of them, one more to
    warm), uniform over each column's rows."""
    import torch
    import torch.distributed as dist

    from recom_tpu_torch.ops.lookup_gather import group_pooled
    from recom_tpu_torch.parallel import (
        all_to_all_group_pooled,
        sharded_group_pooled,
    )
    from recom_tpu_torch.parallel.multihost import from_global

    world = dist.get_world_size()
    if mesh_sizes is None:
        mesh_sizes = [m for m in (1, 2, 4, 8, 16, 32) if m <= world]
    rank = dist.get_rank()
    results = []
    base_rate = None
    for m in mesh_sizes:
        rng = np.random.default_rng(m)
        rows = rows_per_shard * m
        table = rng.standard_normal((rows, dim)).astype(np.float32)
        per_col = rows // n_columns
        offs = (np.arange(n_columns) * per_col).astype(np.int32)
        code = np.zeros((n_columns,), np.int32)
        ids_all = [rng.integers(0, per_col, size=(n_columns, batch, rowlen))
                   .astype(np.int32) for _ in range(iters + 1)]
        mesh = _submesh(m, backend, device) if m > 1 else None
        active = mesh is not None or (m == 1 and rank == 0)
        if active:
            dev = mesh.device if mesh is not None else torch.device(
                device or "cuda")
            sync = (lambda: torch.cuda.synchronize(dev)) \
                if dev.type == "cuda" else (lambda: None)
            if mesh is None:
                td = torch.from_numpy(table).to(dev)
                fn = lambda i: group_pooled(td, i, offs, code)
            else:
                td = from_global(mesh, "striped", table)
                if comm == "all_to_all":
                    def fn(i, _mesh=mesh):
                        out, ovf = all_to_all_group_pooled(
                            _mesh, td, i, offs, code, chunks=chunks)
                        return out, ovf
                else:
                    fn = lambda i, _mesh=mesh: sharded_group_pooled(
                        _mesh, td, i, offs, code)
            idds = [torch.from_numpy(a).to(dev) for a in ids_all]
            sync()
            with torch.inference_mode():
                out = fn(idds[0])
                if mesh is not None and comm == "all_to_all":
                    # an efficiency is meaningless if ids were dropped
                    ovf = int(out[1])
                    if ovf:
                        raise RuntimeError(f"all-to-all overflow {ovf} at "
                                           f"m={m}; raise capacity_factor")
                sync()
                t0 = time.perf_counter()
                for a in idds[1:]:       # each dispatched exactly once
                    out = fn(a)
                sync()
            dt = (time.perf_counter() - t0) / iters
            rate = batch / dt
            if base_rate is None:
                base_rate = rate
            results.append({
                "model_axis": m,
                "rows_total": rows,
                "latency_ms": round(dt * 1e3, 3),
                "examples_per_s": round(rate, 1),
                "efficiency": round(rate / base_rate, 3),
            })
        dist.barrier()
    if rank != 0:
        return None
    # against the first mesh that pays for collectives (m = 1 runs none)
    base2 = next((r["examples_per_s"] for r in results
                  if r["model_axis"] >= 2), None)
    if base2:
        for r in results:
            if r["model_axis"] >= 2:
                r["efficiency_vs_m2"] = round(r["examples_per_s"] / base2, 3)
    return results


# Copied from recom_tpu/tools/scaling.py:169-214, with the port's
# a2a_capacity.
def wire_model(
    m: int, batch: int, n_columns: int, rowlen: int, dim: int,
    comm: str, capacity_factor: float = 2.0, dtype_bytes: int = 4,
) -> dict:
    """Per-DEVICE bytes moved across the model axis per step — the
    denominator that turns measured efficiency into an interpretable
    number (how much of the loss is communication vs imbalance).

    all_to_all (see all_to_all_lookup.py):
      ids out:   [m, cap] int32, (m-1)/m crosses the wire
      rows back: [m, cap, d] f32, (m-1)/m crosses
      + final all-gather of pooled [b_my, C, d] over model: each device
        receives (m-1) shards of b_my rows.
    psum (sharded_lookup.py): ring all-reduce of pooled [b_loc, C, d]:
      2 x (m-1)/m of the buffer per device.
    """
    from recom_tpu_torch.parallel.all_to_all_lookup import a2a_capacity

    if m <= 1:
        return {"bytes_per_device": 0}
    b_loc = batch            # data axis = 1 in this sweep
    b_my = b_loc // m
    pooled_bytes = b_loc * n_columns * dim * dtype_bytes
    if comm == "all_to_all":
        n = b_my * n_columns * rowlen
        cap = a2a_capacity(n, m, capacity_factor)
        frac = (m - 1) / m
        ids_b = m * cap * 4 * frac
        rows_b = m * cap * dim * dtype_bytes * frac
        gather_b = (m - 1) * b_my * n_columns * dim * dtype_bytes
        return {
            "bytes_per_device": int(ids_b + rows_b + gather_b),
            "ids_bytes": int(ids_b),
            "rows_bytes": int(rows_b),
            "pooled_allgather_bytes": int(gather_b),
            "capacity_per_dest": cap,
        }
    return {
        "bytes_per_device": int(2 * pooled_bytes * (m - 1) / m),
        "allreduce_buffer_bytes": pooled_bytes,
    }


def link_roofline(wire: dict, m: int, device_step_s: float,
                  link_gbps: float = H100_NVLINK_GBPS) -> dict:
    """The efficiency the per-rank bytes ``wire`` allow over a link of
    ``link_gbps`` GB/s, given the single-card step ``device_step_s`` that
    weak scaling holds constant (recom_tpu/tools/scaling.py:217-250 with
    the link rate a parameter):

      serial bound:  eff = t_compute / (t_compute + t_comm)
      overlap bound: eff = t_compute / max(t_compute, t_comm)"""
    bytes_dev = wire.get("bytes_per_device", 0)
    if not bytes_dev or m <= 1 or device_step_s <= 0:
        return {}
    t_comm = bytes_dev / (link_gbps * 1e9)
    return {
        "bytes_per_device": bytes_dev,
        "t_comm_ms": round(t_comm * 1e3, 4),
        "t_compute_ms": round(device_step_s * 1e3, 4),
        "link_gbps_assumed": link_gbps,
        "projected_efficiency_serial": round(
            device_step_s / (device_step_s + t_comm), 3
        ),
        "projected_efficiency_overlap": round(
            min(1.0, device_step_s / max(device_step_s, t_comm)), 3
        ),
    }


def run_artifact(args, device=None, backend=None) -> dict:
    """Both comms with their wire models and rooflines, one document on
    rank 0 (recom_tpu/tools/scaling.py:336-407, without the HLO probe),
    and the chunked return against one exchange at m = 8 over m = 2 where
    the world has 8 ranks."""
    import torch.distributed as dist

    out = {
        "protocol": "weak scaling: rows_per_shard const, table grows with "
                    "model axis; efficiency = rate(m)/rate(1)",
        "ranks": dist.get_world_size(),
        "config": {
            "rows_per_shard": args.rows_per_shard, "dim": args.dim,
            "batch": args.batch, "columns": args.columns,
            "rowlen": args.rowlen, "iters": args.iters,
            "chunks": args.chunks,
        },
        "sweeps": {},
    }
    for comm in ("all_to_all", "psum"):
        rows = sweep(
            rows_per_shard=args.rows_per_shard, dim=args.dim,
            batch=args.batch, n_columns=args.columns, rowlen=args.rowlen,
            iters=args.iters, comm=comm, chunks=args.chunks, device=device,
            backend=backend,
        )
        if rows is None:
            continue
        t1 = next((r["latency_ms"] / 1e3 for r in rows
                   if r["model_axis"] == 1), 0.0)
        device_step_s = args.device_step_ms / 1e3 or t1
        for r in rows:
            r["wire"] = wire_model(r["model_axis"], args.batch, args.columns,
                                   args.rowlen, args.dim, comm)
            rl = link_roofline(r["wire"], r["model_axis"], device_step_s,
                               args.link_gbps)
            if rl:
                r["link_roofline"] = rl
        out["sweeps"][comm] = rows
    if dist.get_world_size() >= 8:
        ab = {}
        for ck in (1, args.chunks):
            effs = []
            for _ in range(3):
                rs = sweep(
                    rows_per_shard=args.rows_per_shard, dim=args.dim,
                    batch=args.batch, n_columns=args.columns,
                    rowlen=args.rowlen, iters=max(8, args.iters // 2),
                    comm="all_to_all", mesh_sizes=[2, 8], chunks=ck,
                    device=device, backend=backend,
                )
                if rs is not None:
                    by = {r["model_axis"]: r["examples_per_s"] for r in rs}
                    effs.append(by[8] / by[2])
            if effs:
                ab[f"chunks_{ck}"] = {
                    "m8_vs_m2_reps": [round(e, 3) for e in effs],
                    "m8_vs_m2_median": round(float(np.median(effs)), 3),
                }
        if ab:
            out["chunks_ab"] = ab
    return out if dist.get_rank() == 0 else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rows-per-shard", type=int, default=1 << 16)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--columns", type=int, default=16)
    ap.add_argument("--rowlen", type=int, default=1)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--chunks", type=int, default=2,
                    help="the exchange's row-return chunks "
                         "(EngineConfig.a2a_chunks)")
    ap.add_argument("--comm", default="all_to_all",
                    choices=["all_to_all", "psum", "both"])
    ap.add_argument("--link-gbps", type=float, default=H100_NVLINK_GBPS,
                    help="per-rank link rate, GB/s, for the roofline")
    ap.add_argument("--device-step-ms", type=float, default=0.0,
                    help="measured single-card step (ms) anchoring the "
                         "roofline; 0 = the m=1 sweep latency of this run")
    ap.add_argument("--artifact", default=None,
                    help="write the both-comms JSON to this path")
    ap.add_argument("--spawn", type=int, default=None,
                    help="start this many local ranks over gloo, all on "
                         "--device")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    from recom_tpu_torch.parallel import multihost

    if args.spawn:
        print(multihost.spawn_self("recom_tpu_torch.tools.scaling", argv,
                                   args.device), end="")
        return None
    multihost.init_from_env(args.backend)
    if args.artifact or args.comm == "both":
        out = run_artifact(args, args.device, args.backend)
        if out is None:
            return None
        s = json.dumps(out, indent=1)
        if args.artifact:
            with open(args.artifact, "w") as f:
                f.write(s + "\n")
        print(s)
        return out
    results = sweep(
        rows_per_shard=args.rows_per_shard, dim=args.dim, batch=args.batch,
        n_columns=args.columns, rowlen=args.rowlen, iters=args.iters,
        comm=args.comm, chunks=args.chunks, device=args.device,
        backend=args.backend,
    )
    if results is None:
        return None
    doc = {"comm": args.comm, "sweep": results}
    print(json.dumps(doc, indent=1))
    return doc


if __name__ == "__main__":
    main()
