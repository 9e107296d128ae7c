#!/usr/bin/env python
"""Models E and F end to end: build, predict, train a few steps.

The port of examples/dlrm.py (the reference's examples/python/dlrm.py
builds models E and F, dlrm.py:140-207, for its C++ benchmark; this runs
them): a single-batch predict held bit for bit to the port's oracle, then
(optionally) a few training steps.  On the card unless ``--device cpu``.

  python -m recom_tpu_torch.examples.dlrm --model E --scale 0.05 --batch 256 --train-steps 3
  python -m recom_tpu_torch.examples.dlrm --device cpu --scale 0.02
"""

import argparse
import time

import numpy as np

BIT_EXACT = "all pooled embedding outputs bit-exact vs oracle"


def main(argv=None) -> dict:
    """Returns the output, the losses and the number of columns held."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=["E", "F"], default="E")
    ap.add_argument("--scale", type=float, default=0.05,
                    help="column-count scale (1.0 = full 1000/1200 columns)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from recom_tpu_torch import Engine, EngineConfig, Trainer
    from recom_tpu_torch.models import make_model_e, make_model_f
    from recom_tpu_torch.models import make_random_batch
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.utils.device import card_line, resolve_device
    from recom_tpu_torch.utils.params import init_model_params

    device = resolve_device(args.device)
    make = make_model_e if args.model == "E" else make_model_f
    model = make(scale=args.scale)
    n_emb = len(model.embedding_columns)
    print(f"model {model.name}: {n_emb} embedding columns, "
          f"{len(model.dense_columns)} dense; device "
          f"{card_line(device) or device}")

    # one draw of the random params serves the engine, the oracle and the
    # trainer (each would otherwise draw the same values again)
    params = init_model_params(model)
    eng = Engine(model, EngineConfig(), params=params, device=device)
    batch = make_random_batch(model, args.batch, seed=0)
    times = []
    for _ in range(2):       # the first call also loads the kernels
        t = time.perf_counter()
        out = eng.predict(batch, return_pooled=True)
        times.append((time.perf_counter() - t) * 1e3)
    print("output:", out["output"].shape, out["output"][:3, 0])
    print(f"predict: {times[0]:.3f} ms first, {times[1]:.3f} ms again "
          "(host clock, host prep to outputs on the host)")

    ref = OracleModel(model, params).forward(batch)
    for c, r in ref["pooled"].items():
        np.testing.assert_array_equal(out["pooled"][c], r, err_msg=c)
    print(BIT_EXACT)
    del eng

    losses = []
    if args.train_steps:
        tr = Trainer(model, EngineConfig(), params=params, device=device)
        labels = np.random.default_rng(0).integers(0, 2, args.batch)
        for i in range(args.train_steps):
            t = time.perf_counter()
            losses.append(tr.step(batch, labels))
            print(f"step {i}: loss {losses[-1]:.5f} "
                  f"({(time.perf_counter() - t) * 1e3:.3f} ms)")
    return {"output": out["output"], "columns": len(ref["pooled"]),
            "losses": losses, "predict_ms": times}


if __name__ == "__main__":
    main()
