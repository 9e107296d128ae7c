"""An MLP tower: the dense features through the bottom MLP (where there
are both), beside every column's pooled rows flattened, into the top MLP.
Each layer is ``x @ w + b`` (``w`` He-normal, ``b`` zero), ReLU or the
configuration's activation between layers and after the bottom MLP's
last."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from recbench import spec, towers

draw = towers.draw_dense


def layers(cfg: Dict) -> Dict[str, List[Dict]]:
    tower, n_dense = cfg["tower"], cfg["dense"]["count"]
    front = tower["bottom"][-1] if tower["bottom"] and n_dense else n_dense
    pooled = sum(c.dim * c.count for c in spec.classes(cfg))
    return {"bottom": towers.dense_layers(n_dense, tower["bottom"]),
            "top": towers.dense_layers(front + pooled, tower["top"])}


def forward(mm_in: Callable, cfg: Dict, tower: Dict, dense: torch.Tensor,
            emb: List[torch.Tensor], final) -> torch.Tensor:
    act = cfg["tower"]["activation"]
    front = (towers.dense_forward(mm_in, tower["bottom"], dense, act, act)
             if cfg["tower"]["bottom"] and dense.shape[1] else dense)
    x = torch.cat([front] + [e.flatten(1) for e in emb], dim=1)
    return towers.dense_forward(mm_in, tower["top"], x, act, final)[:, 0]


def ops(cfg: Dict) -> Dict[str, int]:
    """2 operations a multiply-add; a step three times the forward's (the
    forward, and the gradients of inputs and of weights)."""
    n = towers.layer_macs(layers(cfg))
    return {"forward": 2 * n, "step": 6 * n}
