"""Adam (``optax.adam`` with ``eps_root`` 0): moments ``mu`` and ``nu`` an
element, bias-corrected by ``1 - b ** step`` rounded to f32; the update is
``-lr * mu_hat / (sqrt(nu_hat) + eps)``."""

from typing import Dict

import numpy as np
import torch

OPS = 14


def state_per_value(per_element: bool, width: int) -> float:
    return 2.0


def init(p: torch.Tensor, per_element) -> Dict[str, torch.Tensor]:
    return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}


def update(p, g, st, hp, step: int, per_element) -> None:
    b1, b2 = hp["b1"], hp["b2"]
    st["mu"].mul_(b1).add_((1 - b1) * g)
    st["nu"].mul_(b2).add_((1 - b2) * (g * g))
    mu_hat = st["mu"] / np.float32(1 - b1 ** step)
    nu_hat = st["nu"] / np.float32(1 - b2 ** step)
    p.add_(-hp["lr"] * (mu_hat / (torch.sqrt(nu_hat) + hp["eps"])))


def first_grad_sq(state: Dict[str, torch.Tensor], hp, shape) -> torch.Tensor:
    """After one step ``mu`` is ``(1 - b1) g``."""
    return (state["mu"].double() / (1 - hp["b1"])).pow(2).sum()
