"""The traced window: ``torch.profiler`` over the measured window, reduced
in the process to what the per-layer metrics and the breakdown read.

``summary`` follows ``recom_tpu_torch/tools/benchmark.py::
profile_summary``: the device is busy where the union of its operations'
intervals (kernels, copies, sets) lies, over the window's length; the ops
with the most time come by name.  Each kernel is named by the kernel id
that ``counts/kernels.json`` gives it, for the roofline readers.  An idle
gap of the device is put down to the host span of the program's calls
(port.Spans, on any thread) that covered most of it, "other" where none
did; the spans' host clock is put on the profiler's by the window's start,
which both record.  The trace is read from the profiler's raw events and
not written to disk.
"""

from __future__ import annotations

import bisect
import os
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

from recbench import spec

WINDOW = "recbench.window"


def kernel_files() -> List[Dict]:
    """Each hand kernel's file, ``counts/kernels/<id>.json``: the
    ``pattern`` its device function's demangled name matches (``unless``
    it matches that one too) and the ``work`` its time counts against."""
    base = os.path.join(spec.PKG, "counts", "kernels")
    out = []
    for f in sorted(os.listdir(base)):
        if f.endswith(".json"):
            entry = spec.load_json(os.path.join(base, f))
            out.append({"id": f[:-5], "work": entry["work"],
                        "pattern": re.compile(entry["pattern"]),
                        "unless": re.compile(entry["unless"])
                        if entry.get("unless") else None})
    return out


def kernel_work(name: str, kernels) -> Optional[str]:
    """The work a device op's time counts against, by the first kernel
    file that names it; None for an op that is no hand kernel."""
    for k in kernels:
        if k["pattern"].search(name) and not (
                k["unless"] and k["unless"].search(name)):
            return k["work"]
    return None


class Tracer:
    """``with Tracer() as tr: ...`` profiles the block; ``tr.summary()``
    reads the result."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW)
        self.t0 = time.perf_counter()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self._range.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        return False

    def summary(self, spans: Dict[str, List[Tuple[float, float]]]) -> Dict:
        """busy_s, window_s, the hand kernels' seconds by their work, the
        ten device ops with the most time and the ten labels with the most
        idle time; ``spans``: {name: [(start, end), ...]} on the host's
        ``time.perf_counter``."""
        from torch.autograd import DeviceType

        kernels = kernel_files()
        dev, window = [], None
        for ev in self._prof.profiler.kineto_results.events():
            start, dur = ev.start_ns(), ev.duration_ns()
            name = ev.name()
            if ev.is_user_annotation() or name.startswith("recbench."):
                if name == WINDOW and ev.device_type() == DeviceType.CPU:
                    window = (start, start + dur)
            elif ev.device_type() == DeviceType.CUDA and dur > 0:
                dev.append((start, start + dur, name))
        if window is None:
            raise RuntimeError("the profiler recorded no window range")
        lo, hi = window
        offset = lo - self.t0 * 1e9
        host = [(s * 1e9 + offset, e * 1e9 + offset, name)
                for name, recs in spans.items() if name != "queue_wait"
                for s, e in recs]
        dev = [(max(s, lo), min(e, hi), n) for s, e, n in dev
               if e > lo and s < hi]
        by_name: Dict[str, float] = {}
        by_work: Dict[str, float] = {}
        for s, e, n in dev:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
            work = kernel_work(n, kernels)
            if work is not None:
                by_work[work] = by_work.get(work, 0.0) + (e - s) / 1e9
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for s, e, _ in sorted(dev):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                else:
                    gaps.append((lo, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is None:
            gaps.append((lo, hi))
        else:
            busy += cur_e - cur_s
            gaps.append((cur_e, hi))
        idle = self._label_gaps(gaps, host)
        top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
        return {
            "busy_s": busy / 1e9,
            "window_s": self.window_s,
            "work_s": by_work,
            "device_ops": [[n[:200], s] for n, s in top[:10]],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: kv[1], reverse=True)[:10]],
        }

    @staticmethod
    def _label_gaps(gaps, host) -> Dict[str, float]:
        """Idle seconds by what the host did: each stretch of a gap goes to
        the innermost (shortest) host span that covers it, "other" where
        none does."""
        host.sort()
        starts = [h[0] for h in host]
        out: Dict[str, float] = {}
        longest = max((e - s for s, e, _ in host), default=0)
        for gs, ge in gaps:
            if ge <= gs:
                continue
            over = []
            i = bisect.bisect_left(starts, gs - longest)
            while i < len(host) and host[i][0] < ge:
                s, e, n = host[i]
                if e > gs:
                    over.append((max(s, gs), min(e, ge), e - s, n))
                i += 1
            cuts = sorted({gs, ge} | {t for a, b, _, _ in over for t in (a, b)})
            for a, b in zip(cuts, cuts[1:]):
                inner = [(d, n) for s, e, d, n in over if s <= a and e >= b]
                label = min(inner)[1] if inner else "other"
                out[label] = out.get(label, 0.0) + (b - a) / 1e9
        return out
