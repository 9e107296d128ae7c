"""The tower architectures a configuration may state, one module an
architecture, found by the name in its ``tower.arch``:
``towers/<arch>.py``.  Each module gives:

* ``layers(cfg)``: {part: [{key: shape}, ...]}, each layer's leaves in the
  order they are drawn; a leaf is named ``tower/<part>/<i>/<key>``, and
  the program's tower tree holds the same parts, layers and keys;
* ``draw(layer, gen, device)``: the f32 leaves ({key: tensor}) of one
  layer of ``layers``, from the generator ``weights.tower`` seeds for it;
* ``forward(mm_in, cfg, tower, dense, emb, final)``: the plain f32
  forward, from the leaves ({part: [{key: tensor}]}), the dense features
  ``[B, n]`` and each column class's pooled rows (``[B, C, d]``) to
  ``[B]``, with ``final`` the last layer's activation (None: the logits);
  every product takes its inputs through ``mm_in``, which the reference
  gives and calls inside its TF32 switch, so that the TF32 control reaches
  it;
* ``ops(cfg)``: {"forward": n, "step": n}, the operations of a row of the
  forward and of a training step's forward and backward
  (counts/model.py; the update's are counted a leaf from ``layers``).

Shared here: dense layers (``x @ w + b``, He-normal ``w``, zero ``b``),
their leaves, draw, forward and multiply-adds.  A new architecture is a new
module here; one that is here is not edited.
"""

from __future__ import annotations

import importlib
import math
from typing import Callable, Dict, List, Optional


def load(arch: str):
    """The module of tower architecture ``arch``."""
    try:
        return importlib.import_module(f"{__name__}.{arch}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{arch}":
            raise
        raise ValueError(f"unknown tower arch {arch!r}: add "
                         f"recbench/towers/{arch}.py") from None


def flatten(tree: Dict[str, List[Dict]]) -> Dict:
    """{"tower/<part>/<i>/<key>": leaf} of a tower tree, in its order."""
    return {f"tower/{part}/{i}/{k}": t for part, layers in tree.items()
            for i, layer in enumerate(layers) for k, t in layer.items()}


def unflatten(leaves: Dict) -> Dict[str, List[Dict]]:
    """The tower tree of ``flatten``'s names and leaves."""
    tree: Dict[str, List[Dict]] = {}
    for name, t in leaves.items():
        _, part, i, k = name.split("/")
        layers = tree.setdefault(part, [])
        while len(layers) <= int(i):
            layers.append({})
        layers[int(i)][k] = t
    return tree


def dense_layers(n_in: int, widths: List[int]) -> List[Dict]:
    """[{"w": (in, out), "b": (out,)}, ...] of an MLP from ``n_in``."""
    out = []
    for h in widths:
        out.append({"w": (n_in, h), "b": (h,)})
        n_in = h
    return out


def draw_dense(layer: Dict, gen, device) -> Dict:
    """A dense layer's leaves: ``w`` He-normal, ``b`` zero, drawn from the
    ``torch.Generator`` ``gen``."""
    import torch  # here, so that ``spec`` and the run's re-exec stay light

    n_in, n_out = layer["w"]
    w = torch.randn((n_in, n_out), generator=gen, device=device)
    return {"w": w.mul_(math.sqrt(2.0 / n_in)),
            "b": torch.zeros(n_out, device=device)}


def dense_forward(mm_in: Callable, layers: List[Dict], x, act: str,
                  last_act: Optional[str]):
    """``x`` through dense layers, ``act`` between them and ``last_act``
    (None: none) after the last."""
    for i, layer in enumerate(layers):
        x = mm_in(x) @ mm_in(layer["w"]) + layer["b"]
        name = act if i < len(layers) - 1 else last_act
        if name == "relu":
            x = x.relu()
        elif name == "sigmoid":
            x = x.sigmoid()
        elif name is not None:
            raise ValueError(f"unknown activation {name!r}")
    return x


def layer_macs(parts: Dict[str, List[Dict]]) -> int:
    """The multiply-adds of a row through dense layers' leaves."""
    return sum(layer["w"][0] * layer["w"][1]
               for part in parts.values() for layer in part)
