"""What the metric readers (``metrics/<name>.py``) share.  Each reader's
``read(run)`` returns its number, or None where the run gives nothing to
read: a serving metric in a training run, a per-layer metric without a
trace, a roofline whose kernels never ran."""

from __future__ import annotations

from typing import Iterable, Optional

from recbench.counts.model import bound_s


def span_mean_ms(run, kind: str, name: str) -> Optional[float]:
    if run.kind != kind or not run.spans or not run.spans.get(name):
        return None
    spans = run.spans[name]
    return sum(e - s for s, e in spans) / len(spans) * 1e3


def idle_pct(run, kind: str) -> Optional[float]:
    if run.kind != kind or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def mfu_pct(run, kind: str, count: str) -> Optional[float]:
    """The forwards or steps of the traced window times the least time one
    could take (``count``: "forward" or "step"), over the window."""
    if run.kind != kind or run.trace is None or run.counts is None:
        return None
    p = run.peaks
    least = bound_s(run.counts[count], p["flops"], p["bytes_per_s"])
    return 100.0 * run.forwards * least / run.trace["window_s"]


def roofline_pct(run, kind: str, work: Iterable[str],
                 timed: str) -> Optional[float]:
    """The least time of the ``work`` (counts/model.py: "lookup", "hash",
    "lookup_grad"; "hash" at the integer peak) over the traced window's
    forwards or steps, over the device time of the hand kernels whose
    files name ``timed`` as their work."""
    if run.kind != kind or run.trace is None or run.counts is None:
        return None
    spent = run.trace["work_s"].get(timed, 0.0)
    if spent <= 0:
        return None
    p = run.peaks
    least = sum(
        bound_s(run.counts[k], p["flops"], p["bytes_per_s"],
                p["int32_ops_per_s"] if k == "hash" else None)
        for k in work)
    return 100.0 * run.forwards * least / spent
