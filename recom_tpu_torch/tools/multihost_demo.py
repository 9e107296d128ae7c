"""Multi-process sharded-lookup demo and check: the port of
recom_tpu/tools/multihost_demo.py.

The striped lookup with the model axis spanning every rank (one process
each: the stand-in for hosts), through both ways of looking up a striped
group, checked against the single-device lookup: the all-to-all exchange
bit for bit, the psum path within 1e-6; then rows written into the striped
layout on their owners (``Engine.update_table_rows``'s mechanism, every
rank in lockstep) and read back by the exchange bit for bit.

Spawn mode (one command, starts the ranks):
  python -m recom_tpu_torch.tools.multihost_demo --spawn 2 --device cpu

SPMD mode (one invocation per host, as on a cluster):
  python -m recom_tpu_torch.tools.multihost_demo \\
      --coordinator host0:12355 --num-processes 2 --process-id <i>

On the card by default: each rank on ``cuda:<LOCAL_RANK>`` over NCCL;
``--spawn`` runs its ranks over gloo on ``--device`` (default
``cuda:0``: ranks that share one card).
"""

from __future__ import annotations

import argparse
import sys


def worker(coordinator: str, num_processes: int, process_id: int,
           device=None, backend=None) -> str:
    """One rank's part; returns the OK line (printed by rank 0)."""
    import numpy as np
    import torch

    from recom_tpu_torch.ops.lookup_gather import group_pooled
    from recom_tpu_torch.parallel import (
        all_to_all_group_pooled,
        multihost,
        sharded_group_pooled,
    )

    multihost.init(coordinator, num_processes, process_id, backend)
    mesh = multihost.global_mesh(backend=backend, device=device)
    m = mesh.shape["model"]
    k = mesh.axis_index("model")
    rng = np.random.default_rng(0)
    C, V, d, B, L = 4, 256, 8, 32, 3
    table = rng.standard_normal((C * V, d)).astype(np.float32)
    ids = rng.integers(0, V, size=(C, B, L)).astype(np.int32)
    ids[rng.random((C, B, L)) < 0.25] = -1
    offs = (np.arange(C) * V).astype(np.int32)
    code = np.array([0, 1, 2, 1], np.int32)
    dev = mesh.device

    tdev = multihost.from_global(mesh, "striped", table)
    idev = torch.from_numpy(ids).to(dev)
    with torch.inference_mode():
        ref = group_pooled(torch.from_numpy(table), torch.from_numpy(ids),
                           offs, code).numpy()
        out, overflow = all_to_all_group_pooled(mesh, tdev, idev, offs, code)
        got = out.cpu().numpy()
        if int(overflow):
            raise AssertionError(f"a2a overflow {int(overflow)}")
        np.testing.assert_array_equal(got, ref)
        got2 = sharded_group_pooled(mesh, tdev, idev, offs, code).cpu()
        np.testing.assert_allclose(got2.numpy(), ref, atol=1e-6, rtol=1e-6)

        # rows written on their owners in the striped layout, every rank in
        # lockstep; the next lookup serves the new values bit for bit
        upd_rows = rng.choice(C * V, size=16, replace=False).astype(np.int64)
        upd_vals = rng.standard_normal((16, d)).astype(np.float32)
        mine = upd_rows % m == k
        tdev[torch.from_numpy(upd_rows[mine] // m).to(dev)] = \
            torch.from_numpy(upd_vals[mine]).to(dev)
        table2 = table.copy()
        table2[upd_rows] = upd_vals
        ref2 = group_pooled(torch.from_numpy(table2), torch.from_numpy(ids),
                            offs, code).numpy()
        out3, _ = all_to_all_group_pooled(mesh, tdev, idev, offs, code)
        np.testing.assert_array_equal(out3.cpu().numpy(), ref2)
    line = (f"MULTIHOST OK: {num_processes} processes, model axis {m}, "
            f"{mesh.backend} on {dev.type}, all_to_all bit-exact, psum "
            "within 1e-6, striped row update bit-exact")
    if process_id == 0:
        print(line, flush=True)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--spawn", type=int, default=None,
                    help="start N local ranks (demo and test mode)")
    ap.add_argument("--coordinator", default="localhost:12355")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)

    if args.spawn:
        from recom_tpu_torch.parallel import multihost

        res = multihost.spawn(
            ["-m", "recom_tpu_torch.tools.multihost_demo",
             "--num-processes", str(args.spawn),
             "--backend", args.backend or "gloo", "--device",
             args.device or "cuda:0", "--process-id", "-1"], args.spawn)
        ok = True
        for i, (rc, text) in enumerate(res):
            if rc != 0:
                ok = False
                print(f"--- worker {i} FAILED ---\n{text[-2000:]}")
            elif "MULTIHOST OK" in text:
                print(text.strip().splitlines()[-1])
        sys.exit(0 if ok else 1)

    if args.process_id is None:
        raise SystemExit("--process-id required (or --spawn)")
    pid, coordinator = args.process_id, args.coordinator
    if pid < 0:                      # a spawned rank: its RANK and store
        import os

        from recom_tpu_torch.parallel.multihost import SPAWN_INIT

        pid, coordinator = int(os.environ["RANK"]), os.environ[SPAWN_INIT]
    worker(coordinator, args.num_processes, pid, args.device, args.backend)


if __name__ == "__main__":
    main()
