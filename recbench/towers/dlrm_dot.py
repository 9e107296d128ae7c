"""DLRM's dot interaction (arXiv:1906.00091): the dense features through
the bottom MLP, whose output and every column's pooled row are the
vectors; the strict upper triangle of their Gram matrix beside the bottom
MLP's output goes into the top MLP.  Dense layers as ``towers/__init__.py``
gives them."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from recbench import spec, towers

draw = towers.draw_dense


def _vectors(cfg: Dict) -> int:
    return 1 + sum(c.count for c in spec.classes(cfg))


def layers(cfg: Dict) -> Dict[str, List[Dict]]:
    tower = cfg["tower"]
    n = _vectors(cfg)
    return {"bottom": towers.dense_layers(cfg["dense"]["count"],
                                          tower["bottom"]),
            "top": towers.dense_layers(tower["bottom"][-1] + n * (n - 1) // 2,
                                       tower["top"])}


def forward(mm_in: Callable, cfg: Dict, tower: Dict, dense: torch.Tensor,
            emb: List[torch.Tensor], final) -> torch.Tensor:
    act = cfg["tower"]["activation"]
    bottom = towers.dense_forward(mm_in, tower["bottom"], dense, act, act)
    vecs = torch.cat([bottom[:, None, :]] + emb, dim=1)
    m = mm_in(vecs)
    gram = torch.bmm(m, m.transpose(1, 2))
    iu = torch.triu_indices(vecs.shape[1], vecs.shape[1], 1,
                            device=vecs.device)
    x = torch.cat([bottom, gram[:, iu[0], iu[1]]], dim=1)
    return towers.dense_forward(mm_in, tower["top"], x, act, final)[:, 0]


def ops(cfg: Dict) -> Dict[str, int]:
    """The layers' multiply-adds and the interaction's (its strict upper
    triangle), 2 operations each; a step three times the forward's."""
    n = _vectors(cfg)
    n_macs = (towers.layer_macs(layers(cfg))
              + n * (n - 1) // 2 * cfg["tower"]["bottom"][-1])
    return {"forward": 2 * n_macs, "step": 6 * n_macs}
