"""Single-threaded serving-loop measurement protocol: the port of
recom_tpu/tools/serve_loops.py on ``Engine.dispatch``.

One implementation of the confirm-every-N backlog loop, for every tool that
measures a serving loop.  Callers pass DISTINCT batches; each is served
exactly once.
"""

from __future__ import annotations

import time

import numpy as np


def loop_windows(eng, warm_batches, batches, confirm_every=8, windows=5,
                 factory=None, total=None):
    """Single-threaded serving loop: prep + dispatch inline
    (``eng.dispatch(eng.prepare(b), fetch=False)``), confirming the backlog
    every ``confirm_every`` requests (and at window end) with one wait, on
    the newest dispatch's record (the forwards run on one stream, so it
    covers the earlier ones).  ``confirm_every=1`` is the strict
    synchronous loop.  Each batch is served exactly once.  Returns (median
    per-request s, window ms list, per-request ms list).

    ``factory``/``total``: generate each window's batches JUST BEFORE the
    window (factory(k) -> k fresh batches; generation is outside the timed
    section) instead of passing one pre-built ``batches`` list, so a run
    never holds all its batches at once."""
    for sb in warm_batches:     # warm signatures + rowlen hints
        eng.dispatch(eng.prepare(sb), fetch=False).wait()
    # near-equal window boundaries covering EVERY batch (a floor-division
    # per-window count would drop the len % windows tail)
    n_total = total if factory is not None else len(batches)
    bounds = np.linspace(0, n_total, windows + 1).round().astype(int)
    samples = []
    req_ms = []                 # per-request wall times across ALL windows
    for w in range(windows):
        if factory is not None:
            use = factory(int(bounds[w + 1] - bounds[w]))
        else:
            use = batches[bounds[w]: bounds[w + 1]]
        if not use:
            continue
        backlog = []
        t0 = time.perf_counter()
        tprev = t0
        for b in use:
            backlog.append(eng.dispatch(eng.prepare(b), fetch=False))
            if len(backlog) >= confirm_every:
                backlog[-1].wait()
                backlog = []
            tnow = time.perf_counter()
            req_ms.append(round((tnow - tprev) * 1e3, 3))
            tprev = tnow
        if backlog:
            backlog[-1].wait()
        samples.append((time.perf_counter() - t0) / len(use))
    return (
        float(np.median(samples)),
        [round(s * 1e3, 3) for s in samples],
        req_ms,
    )
