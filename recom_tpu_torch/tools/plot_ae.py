# Port copy of recom_tpu/tools/plot_ae.py: only the package name in its usage line differs.
"""Plot the AE sweep artifacts — the analogue of the reference's
AE/plot_latency.py and AE/plot_throughput.py, reading this repo's JSON
artifacts (AE_SWEEP_r*.json / THROUGHPUT_r*.json) instead of parsing
benchmark stdout.

  python -m recom_tpu_torch.tools.plot_ae --sweep AE_SWEEP_r03.json \
      --throughput THROUGHPUT_r03.json --out-dir docs/assets

Produces:
  latency_<tag>.png     per-request latency vs batch (log-log), one panel
                        per model, recom_tpu async vs real TF-CPU
  speedup_<tag>.png     vs_tf_cpu speedup vs batch, one line per model
  throughput_<tag>.png  examples/s by serve_workers (if artifact given)

Chart conventions (fixed 2-slot categorical order, recessive grid, direct
end labels, no dual axes) follow the repo-external dataviz method; colors
are its validated defaults.
"""

from __future__ import annotations

import argparse
import json
import os

# categorical slots (validated default palette, light mode — fixed hue
# order, assigned by position, never cycled) + text tokens
SLOTS = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
         "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
S1 = SLOTS[0]    # slot 1 (blue): recom_tpu
S2 = SLOTS[1]    # slot 2 (orange): TF-CPU baseline
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT2 = "#52514e"
GRID = "#e4e3df"


def _style(ax):
    ax.set_facecolor(SURFACE)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(GRID)
    ax.tick_params(colors=TEXT2, labelsize=9)
    ax.grid(True, which="major", color=GRID, linewidth=0.6, alpha=0.8)
    ax.set_axisbelow(True)


def plot_latency(sweep, path):
    import matplotlib.pyplot as plt

    models = sorted({c["model"] for c in sweep})
    fig, axes = plt.subplots(
        1, len(models), figsize=(4.6 * len(models), 3.6), squeeze=False,
        facecolor=SURFACE,
    )
    for ax, model in zip(axes[0], models):
        cells = sorted(
            (c for c in sweep if c["model"] == model),
            key=lambda c: c["batch"],
        )
        b = [c["batch"] for c in cells]
        ours = [c["request_ms_async"] for c in cells]
        # plot every cell that HAS a baseline (a single missing cell must
        # not erase the whole TF line)
        tf_pts = [
            (c["batch"], c["tf_cpu_ms"]) for c in cells
            if c.get("tf_cpu_ms") is not None
        ]
        _style(ax)
        ax.plot(b, ours, color=S1, linewidth=2, marker="o", markersize=5,
                label="recom_tpu (async)")
        if tf_pts:
            ax.plot(*zip(*tf_pts), color=S2, linewidth=2, marker="o",
                    markersize=5, label="TF-CPU")
        ax.set_xscale("log", base=2)
        ax.set_yscale("log")
        ax.set_xticks(b, [str(x) for x in b])
        ax.set_xlabel("batch size", color=TEXT2, fontsize=9)
        ax.set_title(f"model {model}", color=TEXT, fontsize=11, loc="left")
        # direct end labels (selective: endpoint only)
        def fmt(v):
            return f"{v:,.0f} ms" if v >= 10 else f"{v:.2g} ms"

        ax.annotate(fmt(ours[-1]), (b[-1], ours[-1]),
                    textcoords="offset points", xytext=(4, -11),
                    color=TEXT2, fontsize=8)
        if tf_pts:
            ax.annotate(fmt(tf_pts[-1][1]), tf_pts[-1],
                        textcoords="offset points", xytext=(4, 5),
                        color=TEXT2, fontsize=8)
    axes[0][0].set_ylabel("per-request latency (ms)", color=TEXT2,
                          fontsize=9)
    axes[0][0].legend(frameon=False, fontsize=9, labelcolor=TEXT2)
    fig.suptitle("Serving latency vs batch — recom_tpu vs real TF-CPU",
                 color=TEXT, fontsize=12, x=0.01, ha="left")
    fig.tight_layout(rect=(0, 0, 1, 0.94))
    fig.savefig(path, dpi=150, facecolor=SURFACE)
    return path


def plot_speedup(sweep, path):
    import matplotlib.pyplot as plt

    models = sorted({c["model"] for c in sweep})
    fig, ax = plt.subplots(figsize=(5.4, 3.6), facecolor=SURFACE)
    _style(ax)
    if len(models) > len(SLOTS):  # no generated hues past the fixed order
        dropped = models[len(SLOTS):]
        print(f"plot_speedup: folding {dropped} beyond {len(SLOTS)} series")
        models = models[: len(SLOTS)]
    for model, color in zip(models, SLOTS):
        cells = sorted(
            (c for c in sweep if c["model"] == model and "vs_tf_cpu" in c),
            key=lambda c: c["batch"],
        )
        if not cells:
            continue
        b = [c["batch"] for c in cells]
        sp = [c["vs_tf_cpu"] for c in cells]
        ax.plot(b, sp, color=color, linewidth=2, marker="o", markersize=5,
                label=f"model {model}")
        ax.annotate(f"{sp[-1]:.0f}x", (b[-1], sp[-1]),
                    textcoords="offset points", xytext=(4, -3),
                    color=TEXT2, fontsize=8)
    ax.axhline(1.0, color=TEXT2, linewidth=1, linestyle=":")
    ax.set_xscale("log", base=2)
    bset = sorted({c["batch"] for c in sweep})
    ax.set_xticks(bset, [str(x) for x in bset])
    ax.set_xlabel("batch size", color=TEXT2, fontsize=9)
    ax.set_ylabel("speedup vs real TF-CPU (x)", color=TEXT2, fontsize=9)
    ax.legend(frameon=False, fontsize=9, labelcolor=TEXT2)
    fig.suptitle("End-to-end serving speedup vs batch", color=TEXT,
                 fontsize=12, x=0.01, ha="left")
    fig.tight_layout(rect=(0, 0, 1, 0.93))
    fig.savefig(path, dpi=150, facecolor=SURFACE)
    return path


def plot_throughput(cells, path):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4.6, 3.4), facecolor=SURFACE)
    _style(ax)
    cells = sorted(cells, key=lambda c: c["serve_workers"])
    xs = [str(c["serve_workers"]) for c in cells]
    ys = [c["examples_per_s"] for c in cells]
    ax.bar(xs, ys, width=0.55, color=S1)
    for x, y in zip(xs, ys):
        ax.annotate(f"{y:,.0f}", (x, y), textcoords="offset points",
                    xytext=(0, 3), ha="center", color=TEXT2, fontsize=8)
    ax.set_xlabel("serving workers", color=TEXT2, fontsize=9)
    ax.set_ylabel("examples / s", color=TEXT2, fontsize=9)
    fig.suptitle("Serving throughput by worker count", color=TEXT,
                 fontsize=12, x=0.01, ha="left")
    fig.tight_layout(rect=(0, 0, 1, 0.92))
    fig.savefig(path, dpi=150, facecolor=SURFACE)
    return path


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sweep", help="AE_SWEEP_r*.json")
    ap.add_argument("--throughput", help="THROUGHPUT_r*.json")
    ap.add_argument("--out-dir", default="docs/assets")
    ap.add_argument("--tag", default=None,
                    help="output suffix; default from the sweep filename")
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    made = []
    if args.sweep:
        tag = args.tag or os.path.splitext(
            os.path.basename(args.sweep)
        )[0].split("_")[-1]
        sweep = json.load(open(args.sweep))["sweep"]
        # drop per-model metadata cells (e.g. engine_build_s rows)
        sweep = [c for c in sweep if "batch" in c]
        made.append(plot_latency(
            sweep, os.path.join(args.out_dir, f"latency_{tag}.png")))
        made.append(plot_speedup(
            sweep, os.path.join(args.out_dir, f"speedup_{tag}.png")))
    if args.throughput:
        tag = args.tag or os.path.splitext(
            os.path.basename(args.throughput)
        )[0].split("_")[-1]
        cells = json.load(open(args.throughput))["throughput_sweep"]
        made.append(plot_throughput(
            cells, os.path.join(args.out_dir, f"throughput_{tag}.png")))
    for p in made:
        print(p)


if __name__ == "__main__":
    main()
