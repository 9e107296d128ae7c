"""Checkpoints of the port's Engine, in the JAX package's npz layout.

Copied from recom_tpu/runtime/checkpoint.py (``export_params``,
``save_checkpoint``, ``load_checkpoint``) for the port's engine: tables
stored as f32, bf16 or int8 (exported as the f32 values the engine
serves), on one device or on a mesh (a striped or column-split group is
gathered over the model axis first: ``export_params`` is then a
collective every rank calls), and always the npz layout, never orbax.  A
checkpoint loads into any mesh: the Engine stores the params it is given
in its own layout.  A checkpoint directory holds ``model_spec.json``
(ir/serde.py, the format both packages write) and ``params.npz`` with keys
``tables/<name>`` and ``tower/<key>/<layer>/<w|b>``, so the JAX package's
``load_checkpoint`` reads what this module writes.  The JAX package saves
through orbax where it is installed (a ``params/`` directory):
``load_checkpoint`` reads that too, with ``tensorstore`` (orbax itself
imports jax).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from recom_tpu_torch.ir.serde import model_from_json, model_to_json
from recom_tpu_torch.ir.spec import ModelSpec
from recom_tpu_torch.ops.quant import QuantizedTable, dequantize_table
from recom_tpu_torch.parallel.sharded_lookup import member_stripe


def _host_f32(parts) -> np.ndarray:
    """Stored rows (a tensor, or an int8 table's rows and scales) as f32
    numpy: bf16 upcast, int8 dequantized."""
    if len(parts) == 2:
        return dequantize_table(parts[0].cpu().numpy(),
                                parts[1].cpu().numpy())
    return parts[0].detach().cpu().float().numpy()


def _member_gathered(engine, g, m) -> np.ndarray:
    """Member ``m``'s [vocab, d] f32 table of a striped or column-split
    group, gathered over the model axis (recom_tpu/runtime/checkpoint.py:
    25-60 unstripes the whole group): each rank's rows of the member's
    table, padded to one length, then interleaved; or each rank's columns,
    side by side."""
    mesh, model = engine.mesh, engine.config.mesh_axis_names[1]
    n = mesh.shape[model]
    leaf = engine.device_params["stacked"][str(g.gid)]
    parts = list(leaf) if isinstance(leaf, QuantizedTable) else [leaf]
    # gather f32 (bf16 upcast exactly; gloo has no bf16) or int8 + scales
    parts = [p.detach().float() if p.dtype == torch.bfloat16 else p.detach()
             for p in parts]
    if engine.layout(g) == "columns":
        rows = [p[m.row_offset:m.row_offset + m.vocab_size] for p in parts]
        q = mesh.all_gather(rows[0], model)             # [n, vocab, d / n]
        full = q.permute(1, 0, 2).flatten(1)
        return _host_f32([full] + rows[1:])
    per = -(-m.vocab_size // n)
    k = mesh.axis_index(model)
    first, count, start = member_stripe(m.vocab_size, m.row_offset, n, k)
    got = []
    for p in parts:
        mine = p.new_zeros((per,) + tuple(p.shape[1:]))
        mine[:count] = p[start:start + count]
        got.append(mesh.all_gather(mine, model).cpu())   # [n, per, ...]
    out = _host_f32([t.flatten(0, 1) for t in got]).reshape(n, per, g.dim)
    table = np.empty((m.vocab_size, g.dim), np.float32)
    for r in range(n):
        f, c, _ = member_stripe(m.vocab_size, m.row_offset, n, r)
        table[f::n] = out[r, :c]
    return table


def export_params(engine, tables=None) -> Dict:
    """Engine device params -> the portable numpy pytree ``{"tables":
    {name: [vocab, d]}, "tower": {key: [{"w", "b"}, ...]}}``: stacked group
    tables sliced back into per-table arrays, and the first top matmul
    unfolded back into model order.  Tables are the f32 values the engine
    serves: a bf16 table upcast (numpy has no bf16), an int8 one
    dequantized (``dequantize_table``), as recom_tpu/runtime/checkpoint.py:
    30-59 exports them.  ``tables``: the names to export (default all).
    On a mesh every rank calls it alike and gets the whole pytree."""
    out: Dict = {"tables": {}, "tower": {}}
    for g in engine.compiled.groups:
        if tables is not None and not any(m.table in tables
                                          for m in g.members):
            continue
        val = engine.device_params["stacked"][str(g.gid)]
        if engine.layout(g) != "replicated":
            for m in g.members:
                if tables is None or m.table in tables:
                    out["tables"][m.table] = _member_gathered(engine, g, m)
            continue
        if isinstance(val, QuantizedTable):
            stacked = dequantize_table(val.q.cpu().numpy(),
                                       val.scale.cpu().numpy())
        else:
            stacked = val.detach().cpu().float().numpy()
        if stacked.ndim == 3:  # one-hot layout [C_pad, V_pad, d]
            for i, m in enumerate(g.members):
                out["tables"][m.table] = stacked[i, : m.vocab_size].astype(
                    np.float32
                )
            continue
        for m in g.members:
            out["tables"][m.table] = stacked[
                m.row_offset : m.row_offset + m.vocab_size
            ].astype(np.float32)
    for key, layers in engine.device_params["tower"].items():
        out["tower"][key] = [
            {"w": l["w"].detach().cpu().numpy(),
             "b": l["b"].detach().cpu().numpy()}
            for l in layers
        ]
    if getattr(engine, "_fold_emb_perm", False):
        # the device keeps the first top matmul with emb-perm-folded rows;
        # export it in model order.  With dedup aliases a grouped row holds
        # the SUM of its model rows: the whole sum goes to the FIRST model
        # slot of each grouped row and 0 to the other aliases, so refolding
        # (a scatter-add) rebuilds the device rows exactly (bit-exact
        # resume) and the model-order function is unchanged (aliased slots
        # carry identical activations).
        perm_full = engine._fold_perm_full()
        w_g = out["tower"]["top"][0]["w"]
        uniq, first_idx = np.unique(perm_full, return_index=True)
        w_m = np.zeros((len(perm_full),) + w_g.shape[1:], w_g.dtype)
        w_m[first_idx] = w_g[uniq]
        out["tower"]["top"][0]["w"] = w_m
    return out


def save_checkpoint(path: str, engine) -> None:
    """Save spec + params under ``path`` (``model_spec.json`` and
    ``params.npz``).  On a mesh every rank calls it (the export gathers
    over the model axis) and the mesh's rank 0 writes."""
    params = export_params(engine)
    mesh = getattr(engine, "mesh", None)
    if mesh is not None and mesh.rank != 0:
        return
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model_spec.json"), "w") as f:
        f.write(model_to_json(engine.model))
    flat = {}
    for t, arr in params["tables"].items():
        flat[f"tables/{t}"] = arr
    for key, layers in params["tower"].items():
        for i, l in enumerate(layers):
            flat[f"tower/{key}/{i}/w"] = l["w"]
            flat[f"tower/{key}/{i}/b"] = l["b"]
    np.savez(os.path.join(path, "params.npz"), **flat)


def load_checkpoint(path: str) -> Tuple[ModelSpec, Dict]:
    """Restore (model spec, numpy params pytree) from ``path``.  Every tower
    key the spec implies ("top", and "bottom" where the tower has a bottom
    MLP, as ``init_model_params`` makes them) is in the result, an empty
    layer list where the checkpoint stored no layer of it (a ``top_mlp=()``
    model's npz has no key for its empty "top")."""
    with open(os.path.join(path, "model_spec.json")) as f:
        model = model_from_json(f.read())
    params_dir = os.path.join(os.path.abspath(path), "params")
    if os.path.exists(params_dir):
        params = load_orbax_params(params_dir)
    else:
        params = _load_npz_params(os.path.join(path, "params.npz"))
    for key in (("bottom",) if model.tower.bottom_mlp else ()) + ("top",):
        params["tower"].setdefault(key, [])
    return model, params


def _load_npz_params(npz_path: str) -> Dict:
    """The params pytree of ``save_checkpoint``'s ``params.npz``: the tower
    keys that have a stored layer."""
    npz = np.load(npz_path)
    params: Dict = {"tables": {}, "tower": {}}
    for key in npz.files:
        kind, rest = key.split("/", 1)
        if kind == "tables":
            # imported TF table names may hold '/' (variable scopes): the
            # whole remainder is the name
            params["tables"][rest] = npz[key]
        else:
            # "tower/<key>/<layer idx>/<w|b>", parsed from the right
            tk, idx, wb = rest.rsplit("/", 2)
            layers = params["tower"].setdefault(tk, [])
            while len(layers) <= int(idx):
                layers.append({})
            layers[int(idx)][wb] = npz[key]
    return params


def load_orbax_params(params_dir: str) -> Dict:
    """The params pytree of the JAX package's orbax checkpoint directory
    (``<ckpt>/params``, recom_tpu/runtime/checkpoint.py:84-97), read with
    ``tensorstore``: the leaf keys come from ``_METADATA``'s
    ``tree_metadata``, and each leaf is a zarr array in the directory's
    OCDBT key-value store at its keys joined by ".", so "tables.<name>/"
    for a table (a name may hold "/" or ".") and
    "tower.<key>.<layer>.<w|b>/" for a tower leaf.  An empty layer list
    (a ``top_mlp=()`` model's "top") is a leaf of its own that orbax stores
    no array for (value type "List", ``skip_deserialize``): it reads as
    ``[]``, with no array opened."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"{params_dir} is an orbax checkpoint, which recom_tpu_torch "
            "reads with the tensorstore package, and it is not installed; "
            "save the checkpoint in the npz "
            "layout (params.npz, recom_tpu_torch.runtime.checkpoint."
            "save_checkpoint), which needs nothing else"
        ) from e
    meta_path = os.path.join(params_dir, "_METADATA")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"{params_dir} has no _METADATA: not an orbax checkpoint, or "
            "one whose save did not finish")
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(
            f"{params_dir}: only orbax's OCDBT store of zarr arrays is read "
            f"(use_ocdbt true, use_zarr3 false), got {meta_path} with "
            f"use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
            f"{meta.get('use_zarr3')}")
    base = "file://" + os.path.abspath(params_dir)
    params: Dict = {"tables": {}, "tower": {}}
    for leaf in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in leaf["key_metadata"]]
        value = leaf.get("value_metadata", {})
        if value.get("skip_deserialize"):
            if value.get("value_type") != "List" or len(keys) != 2 or \
                    keys[0] != "tower":
                raise ValueError(f"unexpected empty leaf {keys} "
                                 f"({value}) in {params_dir}")
            params["tower"][keys[1]] = []
            continue
        store = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": base, "path": ".".join(keys) + "/"}},
            open=True).result()
        arr = np.asarray(store.read().result())
        if keys[0] == "tables":
            params["tables"][keys[1]] = arr
        elif keys[0] == "tower":
            # ("tower", key, layer index, "w" | "b")
            layers = params["tower"].setdefault(keys[1], [])
            while len(layers) <= int(keys[2]):
                layers.append({})
            layers[int(keys[2])][keys[3]] = arr
        else:
            raise ValueError(f"unexpected leaf {keys} in {params_dir}")
    return params
