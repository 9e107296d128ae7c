"""Row-wise AdaGrad (optax's formulas, as ``recom_tpu``'s
``rowwise_adagrad``): one accumulator a row of a 2-D leaf, the mean of the
row's squared gradients, and one an element on every other leaf and on the
rows named ``per_element``; the update is ``-lr * g / sqrt(acc + eps)``."""

from typing import Dict

import torch

OPS = 5


def state_per_value(per_element: bool, width: int) -> float:
    return 1.0 if per_element else 1.0 / width


def init(p: torch.Tensor, per_element) -> Dict[str, torch.Tensor]:
    st = {"acc_el": torch.zeros_like(p)}
    if p.dim() == 2:
        st["acc_row"] = torch.zeros(p.shape[0], device=p.device)
    return st


def update(p, g, st, hp, step: int, per_element) -> None:
    st["acc_el"].add_(g * g)
    if p.dim() == 2:
        st["acc_row"].add_((g * g).mean(dim=1))
        s = torch.where(torch.as_tensor(per_element, device=p.device)
                        .reshape(-1, 1),
                        torch.rsqrt(st["acc_el"] + hp["eps"]),
                        torch.rsqrt(st["acc_row"] + hp["eps"])[:, None])
    else:
        s = torch.rsqrt(st["acc_el"] + hp["eps"])
    upd = -hp["lr"] * g
    upd.mul_(s)
    p.add_(upd)


def first_grad_sq(state: Dict[str, torch.Tensor], hp, shape) -> torch.Tensor:
    """After one step ``acc`` is g * g an element, or its mean a row."""
    acc = state["acc"]
    sq = acc.double().sum()
    return sq if tuple(acc.shape) == tuple(shape) else sq * shape[-1]
