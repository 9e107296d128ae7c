"""Device time of queued work, for the measurement tools.

On the card, CUDA events bracket the calls; with ``queued`` a sleep kernel
first holds the card while the host enqueues every call, so the events see
the device work alone (a wrapper's Python dispatch can outlast a 10 us
kernel).  On the CPU, the host clock around the calls."""

from __future__ import annotations

import time
from typing import Callable, Iterable

import torch

# about 0.1 s of an H100's ~2 GHz clock: long enough for the host to queue
# a window of calls behind it
SLEEP_CYCLES = 200_000_000


def calls_ms(device, calls: Iterable[Callable[[], object]],
             queued: bool = True) -> float:
    """Milliseconds from the first of ``calls`` starting to the last
    finishing, each called once in order."""
    calls = list(calls)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for f in calls:
            f()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for f in calls:
        f()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
