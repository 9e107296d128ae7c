"""The card: what nvidia-smi and torch say of it, and the table of peaks
the roofline and MFU shares are taken against.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): HBM3 at 3.35 TB/s, f32 outside the tensor cores at 67 TFLOP/s (the
configurations keep TF32 off, so no product of theirs may run faster).
The INT32 peak is 64 lanes an SM a cycle at the card's ``clocks.max.sm``.
A card set below 700 W runs slower under load: its power limit is printed
beside every run.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict

import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
INT32_LANES_PER_SM = 64


def smi() -> Dict[str, str]:
    """nvidia-smi's name, power limit and maximum SM clock of card 0."""
    keys = ("name", "power.limit", "clocks.max.sm")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return {}
    first = out.stdout.strip().splitlines()[0]
    return dict(zip(keys, (v.strip() for v in first.split(","))))


def host_cores() -> int:
    return len(os.sched_getaffinity(0))


def int32_ops_per_s(device, card: Dict[str, str]) -> float:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * INT32_LANES_PER_SM * float(card["clocks.max.sm"]) * 1e6
