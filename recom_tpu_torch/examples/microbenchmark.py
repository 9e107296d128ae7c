#!/usr/bin/env python
"""Microbenchmark: N bucketized embedding columns, average latency.

The port of examples/microbenchmark.py (the reference's
examples/python/microbenchmark.py:31-91): the same knobs (column count,
batch, table rows, dim, random boundaries), measured the same way
(``Engine.benchmark``: warm-up, then the mean of N timed steps, each ended
by a wait on the card).  On the card unless ``--device cpu``, where the
time is the plain versions' on the CPU.

  python -m recom_tpu_torch.examples.microbenchmark --columns 100 --batch 512
"""

import argparse

import numpy as np


def main(argv=None) -> dict:
    """Returns ``Engine.benchmark``'s stats and the device it ran on."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--columns", type=int, default=100)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--rows", type=int, default=100)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--random-boundary", action="store_true")
    ap.add_argument("--runs", type=int, default=100)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.models import make_random_batch
    from recom_tpu_torch.models.synthetic import make_microbenchmark_model
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.utils.device import card_line, resolve_device
    from recom_tpu_torch.utils.params import init_model_params

    device = resolve_device(args.device)
    model = make_microbenchmark_model(
        args.columns, table_rows=args.rows, dim=args.dim,
        random_boundary=args.random_boundary,
    )
    params = init_model_params(model)
    batch = make_random_batch(model, args.batch, seed=0)
    eng = Engine(model, EngineConfig(), params=params, device=device)

    out = eng.predict(batch, return_pooled=True)
    ref = OracleModel(model, params).forward(batch)
    for c, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][c], r, err_msg=c)
    print(f"bit-exact vs oracle: {args.columns} columns OK")

    # distinct content for every timed step
    stats = eng.benchmark(
        [batch] + [
            make_random_batch(model, args.batch, seed=1 + i)
            for i in range(args.runs)
        ],
        iters=args.runs,
    )
    where = card_line(device) or str(device)
    print(
        f"{args.columns} columns, batch {args.batch}: "
        f"{stats['latency_ms']:.3f} ms avg over {args.runs} runs "
        f"({stats['examples_per_s']:.0f} examples/s, device={where})"
    )
    return {"stats": stats, "device": where}


if __name__ == "__main__":
    main()
