"""The numbers that decide ``correct``, each held against its limit from
the cell's file (``workloads/<cell>.json``, ``limits``); a cell compares
the numbers its limits name, and the run's log shows the others.

Served scores: the widest gap between a returned score and the reference's
for the same row, over every answer the run returned, and the answers that
never came.  Training: the checked steps' losses against the reference's
(relative; the largest, and the first step's), and the gap between the
program's and the reference's norm of each leaf's first gradient and of
its change over those steps, against the reference's norm of the leaf or
of the median leaf, whichever is larger (the worst leaf's).  Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change."""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

SMALL_GRAD = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """{leaf: |program - reference| / max(reference, median leaf)}."""
    med = float(np.median([ref[k] for k in leaves]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses", "grad_norms", "update_norms"}.
    ``loss_gap`` is the largest over the checked steps, ``first_loss_gap``
    the first step's; ``grad_norm_gap`` and ``update_norm_gap`` are the
    worst leaf's."""
    losses = [abs(p - r) / abs(r)
              for p, r in zip(prog["losses"], ref["losses"])]
    grads = ref["grad_norms"]
    med = float(np.median(list(grads.values())))
    moving = [k for k, v in grads.items() if v >= SMALL_GRAD * med]
    g = leaf_gaps(prog["grad_norms"], grads, sorted(grads))
    u = leaf_gaps(prog["update_norms"], ref["update_norms"], moving)
    for name, gaps in (("first gradient", g), ("change", u)):
        leaf = max(gaps, key=gaps.get)
        print(f"[recbench] worst leaf of the {name}: {leaf} {gaps[leaf]!r}",
              file=sys.stderr)
    return {
        "loss_gap": max(losses),
        "first_loss_gap": losses[0],
        "grad_norm_gap": max(g.values()),
        "update_norm_gap": max(u.values()),
    }


def score_gap(answers, ref_scores: Dict[int, np.ndarray]) -> float:
    """``answers``: (pool index, returned scores) pairs."""
    return max((float(np.max(np.abs(out - ref_scores[k])))
                for k, out in answers), default=float("inf"))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} in the limits' order, and whether every
    number is within its limit (a missing or non-finite one is not)."""
    out = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit}
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return {"checks": out, "correct": ok}


def print_checks(checks: Dict) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
