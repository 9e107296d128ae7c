"""The port's span recorder: where a request's or a training step's time
goes, phase by phase, on whichever thread does the work.  One recorder a
process, off by default.

    from recom_tpu_torch.utils import spans
    spans.enable()                # records from here on (and forgets older ones)
    ... serve or train ...
    spans.disable()
    rows = spans.records()        # [{"name", "start_ns", "end_ns", ...}, ...]

While it is off, ``span(...)`` tests one flag and returns a shared no-op:
nothing is recorded or allocated and no clock is read.  While it is on,
the newest ``MAX_RECORDS`` spans are kept in memory, each handed out by
``records()`` as a plain dict:

    name             what ran: "prepare", "dispatch.replay", "device.backward", ...
    start_ns, end_ns stamps on the clock torch.profiler's trace reports (the
                     host's real-time clock, ``time.time_ns``), in ns
    thread           ``threading.get_ident()`` of the thread that ran it
    id               the request's or the training step's number (None
                     outside one); every span of one request has it,
                     whichever thread ran the span
    sid              the span's own number
    parent           the ``sid`` of the span it ran inside (None at the top)
    kind             "host": both ends stamped on the host; "device": a
                     duration the card timed with CUDA events, placed to end
                     where the host read it; "sum": a duration summed from
                     several stretches (``add``), placed to end where it was
                     added

While a ``torch.profiler`` session is active as well, each span entered
with ``with`` is also emitted as a ``record_function`` range of its name,
so an exported trace shows the program's phases above the card's kernels
on one timeline; its stamps and the range's agree to within tens of
microseconds.

``summary()`` gives each name's count, mean, p50 and p99 in ms, which
``Engine.stats_report()["stage_latency"]`` shows.  The names the port
records are listed in PERF.md.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

# the newest records kept: bounded memory for a long-running server
MAX_RECORDS = 1 << 18

_on = False
_records: deque = deque(maxlen=MAX_RECORDS)
_sids = itertools.count(1)
_ids = itertools.count(1)
# perf_counter_ns plus this is time.time_ns: a monotonic clock, read on the
# profiler's time line
_offset = 0
_local = threading.local()


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start recording, forgetting what was recorded before."""
    global _on, _offset
    _records.clear()
    _offset = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays readable."""
    global _on
    _on = False


def records() -> List[Dict]:
    """The recorded spans, oldest first, as plain dicts."""
    keys = ("name", "start_ns", "end_ns", "thread", "id", "sid", "parent",
            "kind")
    return [dict(zip(keys, r)) for r in list(_records)]


def now() -> int:
    """A stamp on the recorder's clock, in ns."""
    return time.perf_counter_ns() + _offset


def _state():
    st = _local.__dict__
    if "stack" not in st:
        st["stack"] = []
        st["rid"] = None
    return st


class _Null:
    """The span handed out while the recorder is off."""

    __slots__ = ()
    sid = None
    rid = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self) -> None:
        pass


NULL = _Null()


class Span:
    """One span.  ``with`` stamps its ends on this thread and makes it the
    parent of the spans started inside it; ``begin`` stamps its start here
    and ``end()`` its end on any thread."""

    __slots__ = ("name", "rid", "sid", "parent", "thread", "start", "_rf",
                 "_prev_rid")

    def __init__(self, name: str, rid: Optional[int]):
        st = _state()
        self.name = name
        self.rid = st["rid"] if rid is None else rid
        self.parent = st["stack"][-1] if st["stack"] else None
        self.sid = next(_sids)
        self.thread = threading.get_ident()
        self.start = None
        self._rf = None

    def __enter__(self):
        st = _state()
        st["stack"].append(self.sid)
        self._prev_rid, st["rid"] = st["rid"], self.rid
        if torch.autograd._profiler_enabled():
            self._rf = torch.ops.profiler._record_function_enter_new(
                self.name, None)
        self.start = now()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            # the range's end first, then the stamp: both then lie close
            # to the range's own
            torch.ops.profiler._record_function_exit._RecordFunction(self._rf)
            self._rf = None
        t = now()
        st = _state()
        st["stack"].pop()
        st["rid"] = self._prev_rid
        _records.append((self.name, self.start, t, self.thread, self.rid,
                         self.sid, self.parent, "host"))
        return False

    def end(self) -> None:
        """End a span from ``begin``, on whatever thread."""
        _records.append((self.name, self.start, now(), self.thread, self.rid,
                         self.sid, self.parent, "host"))


def span(name: str, fresh: bool = False):
    """``with span(name):`` records the block, with the enclosing span's
    request or step number, or with a number of its own where ``fresh``
    (a training step's)."""
    if not _on:
        return NULL
    return Span(name, next(_ids) if fresh else None)


def begin(name: str, fresh: bool = False):
    """A span started now, to be ended with ``.end()`` on any thread (a
    request's whole life, say; ``fresh`` as for ``span``); the no-op while
    the recorder is off."""
    if not _on:
        return NULL
    sp = Span(name, next(_ids) if fresh else None)
    sp.start = now()
    return sp


class under:
    """``with under(sp):`` makes the spans this thread starts children of
    ``sp`` (from ``begin``, often on another thread), with its number."""

    __slots__ = ("sp", "prev")

    def __init__(self, sp):
        self.sp = sp

    def __enter__(self):
        if self.sp.sid is None:
            return self
        st = _state()
        st["stack"].append(self.sp.sid)
        self.prev, st["rid"] = st["rid"], self.sp.rid
        return self

    def __exit__(self, *exc):
        if self.sp.sid is None:
            return False
        st = _state()
        st["stack"].remove(self.sp.sid)
        st["rid"] = self.prev
        return False


def record(name: str, start_ns: int, end_ns: int, parent=None,
           kind: str = "host") -> None:
    """Record a span whose ends were stamped already (``now()``), under
    ``parent`` (a span, with its number) or else the thread's current
    span."""
    if not _on:
        return
    if parent is not None and parent.sid is not None:
        pid, rid = parent.sid, parent.rid
    else:
        st = _state()
        pid = st["stack"][-1] if st["stack"] else None
        rid = st["rid"]
    _records.append((name, start_ns, end_ns, threading.get_ident(), rid,
                     next(_sids), pid, kind))


def device(names, ms, end_ns: int, parent=None) -> None:
    """Record back-to-back device phases ``names`` of ``ms`` milliseconds
    each (from CUDA events), the last ending at ``end_ns``."""
    t = end_ns
    stamps = []
    for m in reversed(ms):
        s = t - int(m * 1e6)
        stamps.append((s, t))
        t = s
    for name, (s, e) in zip(names, reversed(stamps)):
        record(name, s, e, parent, kind="device")


def add(name: str, seconds: float) -> None:
    """Record a duration summed by the caller under the thread's current
    span: the ``timers.add(stage, seconds)`` protocol through which the
    wire host prep reports its ``prep.*`` stages, so this module serves as
    its ``timers``."""
    t = now()
    record(name, t - int(seconds * 1e9), t, kind="sum")


def summary(rows: Optional[List[Dict]] = None) -> Dict[str, Dict]:
    """{name: count, mean_ms, p50_ms, p99_ms} over ``rows`` (default: the
    records while the recorder is on; {} while it is off)."""
    import numpy as np

    if rows is None:
        if not _on:
            return {}
        rows = records()
    by: Dict[str, List[float]] = {}
    for r in rows:
        by.setdefault(r["name"], []).append(
            (r["end_ns"] - r["start_ns"]) / 1e6)
    out = {}
    for name, xs in by.items():
        arr = np.asarray(xs)
        out[name] = {
            "count": len(xs),
            "mean_ms": round(float(arr.mean()), 3),
            "p50_ms": round(float(np.percentile(arr, 50)), 3),
            "p99_ms": round(float(np.percentile(arr, 99)), 3),
        }
    return out
