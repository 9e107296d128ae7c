# Port copy of recom_tpu/tools/tf_sweep.py: the package name in imports, main(argv)
# and the docstring's note on the host differ.
"""TF-CPU baseline matrix: measure real TensorFlow-CPU latency for every
(model, batch) cell and merge vs_tf_cpu into an AE sweep artifact.

Runs separately from the engine sweep so the TF session never contends
with the engine's host-prep timing.  It runs TF on the CPU only; nothing
here touches the card.

  python -m recom_tpu_torch.tools.tf_sweep --merge-into AE.json
"""

from __future__ import annotations

import argparse
import json
import time


def measure_tf(model_name: str, batches, iters: int):
    from recom_tpu_torch.models import make_random_batch
    from recom_tpu_torch.tools.ae_sweep import _make_model, _tf_cpu_cell
    from recom_tpu_torch.tools.tf_baseline import build_tf_baseline
    from recom_tpu_torch.utils.params import init_model_params

    model = _make_model(model_name)
    np_params = init_model_params(model)
    tfn, make_feed = build_tf_baseline(model, np_params)
    out = {}
    for bs in batches:
        bats = [
            make_random_batch(model, bs, seed=10_000 + bs + i)
            for i in range(max(2, iters))
        ]
        # ONE timing protocol shared with the AE sweep (_tf_cpu_cell):
        # two implementations of the same measurement drift apart — the
        # exact failure serve_loops.py was created to prevent
        out[bs] = _tf_cpu_cell(tfn, make_feed, bats, iters=iters)
        print(json.dumps({
            "model": model.name, "batch": bs,
            "tf_cpu_ms": round(out[bs] * 1e3, 2),
        }))
    return model.name, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--models", nargs="+", default=["E", "F"])
    ap.add_argument("--batches", nargs="+", type=int,
                    default=[32, 64, 128, 256, 512, 1024, 2048])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--merge-into", default=None,
                    help="AE sweep JSON to annotate with tf_cpu_ms / "
                         "vs_tf_cpu at every cell")
    args = ap.parse_args(argv)

    measured = {}
    for name in args.models:
        mname, cells = measure_tf(name, args.batches, args.iters)
        measured[mname] = cells

    if args.merge_into:
        with open(args.merge_into) as f:
            doc = json.load(f)
        for row in doc.get("sweep", []):
            cells = measured.get(row.get("model"))
            if cells and row.get("batch") in cells:
                tf_s = cells[row["batch"]]
                row["tf_cpu_ms"] = round(tf_s * 1e3, 2)
                row["vs_tf_cpu"] = round(
                    tf_s / (row["request_ms_async"] / 1e3), 2
                )
        doc["baseline"] = "tf_cpu (real TensorFlow, same host, measured "
        doc["baseline"] += "by tools/tf_sweep.py in a separate process)"
        with open(args.merge_into, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"merged into {args.merge_into}")


if __name__ == "__main__":
    main()
