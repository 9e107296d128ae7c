"""Multi-rank training equivalence: the port of
recom_tpu/tools/train_multi.py.

Trains the same planted-signal model from the same f32 init on the same
batch stream twice:

  * on one device (rank 0; the other ranks wait), and
  * on a ("data", "model") mesh of every rank, the big table striped over
    the model axis and the batch split over the data axis,

and records what the dryrun's one-step check cannot: both loss
trajectories (their largest per-step gap), the exported params' end-state
difference after N steps (striped tables gathered by ``export_params``),
and the held-out AUC of both arms.

Every rank of a torch.distributed world runs it alike (``run``): under
``torchrun --nproc-per-node N``, or with ``--spawn N``, which starts the
N ranks itself over gloo, all on ``--device`` (ranks sharing one card, or
the CPU).  The mesh arm's all-to-all exchange pools bit for bit, but its
loss and gradient sums run in another order than the single device's, so
the losses track to about 1e-5 and the params drift at rounding level.

  python -m recom_tpu_torch.tools.train_multi --spawn 4 --device cpu \\
      --steps 120 --out TRAIN_MULTI.json
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np

VOCAB_BIG, VOCAB_SMALL, DIM = 4096, 48, 8
EVAL_N = 4096


def make_model():
    """recom_tpu/tools/train_multi.py:46-79 in the port's spec classes."""
    from recom_tpu_torch.ir.spec import (
        Combiner,
        FeatureColumn,
        FeatureKind,
        FeatureSource,
        LookupSpec,
        ModelSpec,
        NumToId,
        TableSpec,
        TowerSpec,
    )

    tables = {
        "big": TableSpec("big", VOCAB_BIG, DIM),     # striped on the mesh
        "small": TableSpec("small", VOCAB_SMALL, DIM),  # replicated
    }
    cols = [
        FeatureColumn(
            "bids", FeatureSource("bids", FeatureKind.INT_LIST),
            (NumToId(VOCAB_BIG),), LookupSpec("big", Combiner.MEAN),
        ),
        FeatureColumn(
            "sids", FeatureSource("sids", FeatureKind.INT_LIST),
            (NumToId(VOCAB_SMALL),), LookupSpec("small", Combiner.SUM),
        ),
        FeatureColumn("d0", FeatureSource("d0", FeatureKind.DENSE_FLOAT)),
    ]
    tower = TowerSpec(arch="mlp", bottom_mlp=(), top_mlp=(16, 1),
                      final_activation="sigmoid")
    return ModelSpec("trainmulti", tables, cols, tower)


# Copied from recom_tpu/tools/train_multi.py:82-97.
def make_data(rng, n):
    lens_b = rng.integers(1, 6, n)
    lens_s = rng.integers(1, 4, n)
    bids = [rng.integers(0, VOCAB_BIG, int(k)).tolist() for k in lens_b]
    sids = [rng.integers(0, VOCAB_SMALL, int(k)).tolist() for k in lens_s]
    d0 = rng.standard_normal(n).astype(np.float32)
    signal = (
        np.array([np.mean(r) / (VOCAB_BIG - 1) for r in bids])
        + 0.2 * np.array([np.mean(r) / (VOCAB_SMALL - 1) for r in sids])
        + 0.3 * d0
    )
    labels = (
        signal + 0.1 * rng.standard_normal(n) > 0.65
    ).astype(np.float32)
    return {"bids": bids, "sids": sids, "d0": d0}, labels


def train_arm(model, np_params, stream, eval_batch, eval_labels, lr,
              mesh=None, device=None):
    """One arm: (losses, held-out AUC, exported params, striped gids).
    ``mesh``: the mesh arm's ``parallel.Mesh`` (every rank calls alike),
    else one device."""
    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.runtime.checkpoint import export_params
    from recom_tpu_torch.tools.auc_parity import auc
    from recom_tpu_torch.train import Trainer, adam

    bs = len(stream[0][1])
    shape = None if mesh is None else tuple(mesh.shape.values())
    cfg = EngineConfig(
        use_pallas=False,
        batch_buckets=(bs, len(eval_labels)),
        mesh_shape=shape,
        # force the 4096-row table onto the striped path on the mesh arm
        shard_rows_above=2048 if mesh is not None else (1 << 62),
    )
    tr = Trainer(model, cfg, optimizer=adam(lr),
                 params=copy.deepcopy(np_params),
                 device=None if mesh is not None else device, mesh=mesh)
    losses = [tr.step(b, lab) for b, lab in stream]
    scores = np.asarray(tr.engine.predict(eval_batch)["output"])[:, 0]
    a = auc(eval_labels, scores)
    final = export_params(tr.engine)
    return losses, a, final, sorted(tr.engine._sharded_gids)


# Copied from recom_tpu/tools/train_multi.py:126-141.
def _tree_max_delta(a, b):
    out = {}
    for k in a["tables"]:
        out[f"tables/{k}"] = float(
            np.max(np.abs(np.asarray(a["tables"][k], np.float64)
                          - np.asarray(b["tables"][k], np.float64)))
        )
    for key, layers in a["tower"].items():
        for i, (la, lb) in enumerate(zip(layers, b["tower"][key])):
            out[f"tower/{key}/{i}"] = float(max(
                np.max(np.abs(np.asarray(la["w"], np.float64)
                              - np.asarray(lb["w"], np.float64))),
                np.max(np.abs(np.asarray(la["b"], np.float64)
                              - np.asarray(lb["b"], np.float64))),
            ))
    return out


def run(steps: int = 120, batch: int = 256, lr: float = 1e-3,
        mesh=(2, 2), eval_n: int = EVAL_N, device=None, backend=None):
    """Both arms on an initialised world of at least ``mesh[0] * mesh[1]``
    ranks, every rank calling alike: the single-device arm on rank 0 (on
    ``device``), the mesh arm on the mesh's ranks.  Returns the document
    on rank 0, None elsewhere."""
    import torch.distributed as dist

    from recom_tpu_torch.parallel import make_mesh
    from recom_tpu_torch.utils.params import init_model_params

    mesh = make_mesh(tuple(mesh), backend=backend, device=device)
    model = make_model()
    np_params = init_model_params(model)
    rng = np.random.default_rng(7)
    stream = [make_data(rng, batch) for _ in range(steps)]
    eval_batch, eval_labels = make_data(np.random.default_rng(998), eval_n)

    single = None
    if mesh.rank == 0:
        t0 = time.perf_counter()
        single = train_arm(model, np_params, stream, eval_batch, eval_labels,
                           lr, device=mesh.device)
        single_s = time.perf_counter() - t0
    dist.barrier(group=mesh.groups[None])
    t0 = time.perf_counter()
    losses_m, auc_m, final_m, sharded = train_arm(
        model, np_params, stream, eval_batch, eval_labels, lr, mesh=mesh)
    mesh_s = time.perf_counter() - t0
    if mesh.rank != 0:
        return None
    losses_1, auc_1, final_1, _ = single
    dl = np.abs(np.asarray(losses_1) - np.asarray(losses_m))
    deltas = _tree_max_delta(final_1, final_m)
    from recom_tpu_torch.utils.device import card_line

    return {
        "protocol": (
            f"identical init + batch stream, Adam lr={lr}, {steps} steps x "
            f"batch {batch}; one device vs a {tuple(mesh.shape.values())} "
            f"mesh of ranks over {mesh.backend} (striped big table, "
            f"data-parallel batch), AUC on held-out {eval_n}"
        ),
        "sharded_groups": sharded,
        "loss_first": [round(losses_1[0], 6), round(losses_m[0], 6)],
        "loss_last": [round(losses_1[-1], 6), round(losses_m[-1], 6)],
        "loss_max_abs_delta": round(float(dl.max()), 8),
        "loss_decreased": bool(
            losses_1[-1] < losses_1[0] and losses_m[-1] < losses_m[0]
        ),
        "auc_single": round(auc_1, 4),
        "auc_mesh": round(auc_m, 4),
        "auc_gap": round(abs(auc_1 - auc_m), 4),
        "param_end_state_max_abs_delta": {
            k: round(v, 8) for k, v in deltas.items()
        },
        "train_s": [round(single_s, 1), round(mesh_s, 1)],
        "ranks": mesh.size,
        "device": str(mesh.device),
        "card": card_line(mesh.device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", type=int, nargs=2, default=[2, 2],
                    help="(data, model) mesh of the sharded arm")
    ap.add_argument("--out", default=None)
    ap.add_argument("--spawn", type=int, default=None,
                    help="start this many local ranks over gloo, all on "
                         "--device")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    from recom_tpu_torch.parallel import multihost

    if args.spawn:
        print(multihost.spawn_self("recom_tpu_torch.tools.train_multi", argv,
                                   args.device), end="")
        return None
    multihost.init_from_env(args.backend)
    doc = run(args.steps, args.batch, args.lr, tuple(args.mesh),
              device=args.device, backend=args.backend)
    if doc is None:
        return None
    out = json.dumps(doc, indent=1)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    ok = (
        doc["loss_decreased"]
        and doc["auc_gap"] <= 0.01
        and doc["loss_max_abs_delta"] < 1e-3
    )
    if not ok:
        raise SystemExit(1)
    return doc


if __name__ == "__main__":
    main()
