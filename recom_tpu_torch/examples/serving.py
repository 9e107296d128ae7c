#!/usr/bin/env python
"""Production-style serving: warmup, pipelined requests, online refresh,
SLA report.

The port of examples/serving.py.  The full serving lifecycle on one card:
  1. build the engine
  2. Engine.warmup(): one forward per batch bucket before traffic (each
     kernel built, the allocator's cache filled; on the card each
     bucket's CUDA graph captured, which later requests replay)
  3. ServingPipeline: host prep of request k+1 overlaps the card's step k;
     the first request's pooled outputs held bit for bit to the oracle
  4. online refresh mid-traffic: Engine.update_table_rows (stream fresh
     embedding rows) and Engine.reload_params (a whole retrained
     checkpoint), in place: no rebuild, no new program
  5. throughput_under_sla: the max sustainable load at a p99 target
On the card unless ``--device cpu``.

  python -m recom_tpu_torch.examples.serving --columns 100 --batch 256 --sla-ms 20
"""

import argparse

BIT_EXACT = "request 0: pooled outputs bit-exact vs oracle"


def main(argv=None) -> dict:
    """Returns the served outputs, the compile counters before and after
    the refresh, and ``throughput_under_sla``'s report."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--columns", type=int, default=100)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--sla-ms", type=float, default=50.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.models import make_random_batch
    from recom_tpu_torch.models.synthetic import make_dlrm_model
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.runtime.checkpoint import export_params
    from recom_tpu_torch.runtime.server import (
        ServingPipeline,
        throughput_under_sla,
    )
    from recom_tpu_torch.utils.device import card_line, resolve_device
    from recom_tpu_torch.utils.params import init_model_params

    device = resolve_device(args.device)
    model = make_dlrm_model(
        args.columns, 10, 10, 4, 1, 16, [16], [128, 64, 1], name="serve",
        large_rows=100_000,
    )
    params = init_model_params(model)
    eng = Engine(model, EngineConfig(batch_buckets=(args.batch,)),
                 params=params, device=device)
    n = eng.warmup()
    print(f"warmed {n} programs on {card_line(device) or device}")

    requests = [
        make_random_batch(model, args.batch, seed=i)
        for i in range(args.requests)
    ]
    with ServingPipeline(eng, prep_workers=4, max_inflight=4) as pipe:
        outs = pipe.map_stream(requests)
    assert all(np.isfinite(o).all() for o in outs)
    print(f"served {len(outs)} requests; engine counters:",
          eng.stats_report()["counters"])
    first = eng.predict(requests[0], return_pooled=True)
    ref = OracleModel(model, params).forward(requests[0])
    for c, r in ref["pooled"].items():
        np.testing.assert_array_equal(first["pooled"][c], r, err_msg=c)
    np.testing.assert_array_equal(first["output"], outs[0])
    print(BIT_EXACT)

    # --- online refresh mid-traffic: no rebuild, no new program ---------
    compiles_before = eng.stats["compiles"]
    t0 = "emb_bucketize0"
    dim = model.tables[t0].dim
    rows = np.arange(model.tables[t0].vocab_size)
    eng.update_table_rows(
        t0, rows, np.random.default_rng(1).standard_normal(
            (rows.size, dim)
        ).astype(np.float32),
    )
    eng.reload_params(export_params(eng))   # e.g. a retrained checkpoint
    out2 = eng.predict(requests[0])
    assert np.isfinite(np.asarray(out2["output"])).all()
    assert eng.stats["compiles"] == compiles_before
    print("online refresh applied (row update + full reload), 0 new "
          "programs")

    # distinct content for every timed request
    rep = throughput_under_sla(
        eng, requests[:4], sla_ms=args.sla_ms, num_iterations=10,
        worker_ladder=(1, 2, 4),
        batch_factory=lambda k: make_random_batch(
            model, args.batch, seed=50_000 + k
        ),
    )
    best = rep["best_under_sla"]
    if best:
        print(
            f"max sustainable under {args.sla_ms}ms p99: "
            f"{best['examples_per_s']:.0f} examples/s at "
            f"{best['workers']} workers (p99 {best['p99_ms']}ms)"
        )
    else:
        print(f"SLA {args.sla_ms}ms not attainable; ladder: {rep['ladder']}")
    return {"outputs": outs, "compiles": (compiles_before,
                                          eng.stats["compiles"]),
            "sla": rep}


if __name__ == "__main__":
    main()
