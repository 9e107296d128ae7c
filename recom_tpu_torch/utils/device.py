"""Device resolution for the port's entry points: CUDA unless the caller
names another device, and never a quiet fallback to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Asking for CUDA where
    ``torch.cuda.is_available()`` is False raises; pass ``device="cpu"`` to
    run every kernel's plain PyTorch version on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "recom_tpu_torch runs on CUDA by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_line(device) -> "str | None":
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` reports them (a card set below its
    maximum runs slower under load, so every time is kept beside it); None
    on the CPU or where nvidia-smi cannot be run."""
    import subprocess

    if torch.device(device).type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None
