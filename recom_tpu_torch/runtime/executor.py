"""The Engine, in PyTorch: compile once, serve many batches on the card.

The port of recom_tpu/runtime/executor.py::Engine for the single-device
serving path: host prep (the copied wire/host_prep modules) -> one H2D copy
-> the grouped lookups through the hand-written kernels (K1 for one-hot
groups, K2 for pure-bucketize one-hot groups fed raw floats, X1 for gather
groups, X2 for device string hashing) -> each group's concat, with its
members' post-lookup ops (PostPool) -> the tower (an MLP, or DLRM's
``dlrm_dot`` interaction) -> outputs.  It runs eagerly: a "program" is a
shape signature, and ``stats["compiles"]`` counts the distinct ones served
(CUDA graphs per signature are ROADMAP Queue 1 item 6).

Entry points run on CUDA unless the caller names another device; asking for
CUDA where there is none raises.  Features of the JAX Engine outside this
slice raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from recom_tpu_torch.compiler.lowering import CompiledModel, lower_model
from recom_tpu_torch.compiler.pipeline import run_passes
from recom_tpu_torch.config import EngineConfig
from recom_tpu_torch.ir.spec import ModelSpec
from recom_tpu_torch.ops.lookup_gather import device_bucketize, groups_pooled
from recom_tpu_torch.ops.lookup_onehot import (
    bucket_bounds,
    onehot_bucketize_lookup,
    onehot_lookup,
)
from recom_tpu_torch.ops.quant import QuantizedTable, quantize_rows_chunked
from recom_tpu_torch.runtime.host_prep import PreparedBatch, prepare_batch
from recom_tpu_torch.utils.device import resolve_device
from recom_tpu_torch.utils.params import init_model_params


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to recom_tpu_torch yet (ROADMAP.md Queue 1 "
        f"{item})"
    )


def _act(name: Optional[str], x: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name is None or name == "none":
        return x
    raise ValueError(f"unknown activation {name}")


def _stored(table: np.ndarray, table_dtype: str) -> torch.Tensor:
    """An f32 host table as a host tensor of the stored dtype: as is for
    float32, rounded to nearest even for bfloat16 (as ``jnp.asarray(...,
    dtype=bfloat16)`` rounds)."""
    t = torch.from_numpy(np.ascontiguousarray(table, np.float32))
    return t.to(torch.bfloat16) if table_dtype == "bfloat16" else t


def folds_emb_perm(tower, total_emb_dim: int) -> bool:
    """Whether the model-order embedding permutation folds into the first
    top matmul's rows: only for an MLP tower with top layers and some
    embedding width (recom_tpu/runtime/executor.py:163-167).  An identity
    tower (no top layers) and an order-sensitive tower such as
    ``dlrm_dot`` keep the explicit permutation."""
    return tower.arch == "mlp" and bool(tower.top_mlp) and total_emb_dim > 0


def group_concat(g, pooled: torch.Tensor, col_pooled=None,
                 post_consts=None) -> torch.Tensor:
    """Group output concat [Bp, out_width] from pooled [Bp, C, d], applying
    each member's post-lookup chain (the port of
    recom_tpu/runtime/executor.py::_group_concat).  The no-post case is one
    reshape.  ``col_pooled``: {column name: RAW pooled [Bp, d]} across all
    groups, read by mul_column; ``post_consts``: {(gid, member, op index):
    device tensors} of the frozen matmul weights and affine scales and
    biases.  Hidden members (``in_concat=False``) pool but take no slot."""
    if not g.any_post and all(m.column.in_concat for m in g.members):
        return pooled.reshape(pooled.shape[0], -1)
    parts = []
    for idx, m in enumerate(g.members):
        if not m.column.in_concat:
            continue
        x = pooled[:, idx, :]
        for i, p in enumerate(m.column.post):
            if p.op == "reduce_sum":
                x = x.sum(dim=1, keepdim=True)
            elif p.op == "reduce_mean":
                x = x.mean(dim=1, keepdim=True)
            elif p.op == "softmax":
                x = torch.softmax(x, dim=1)
            elif p.op == "mul_column":
                # operand = the other column's RAW pooled output
                x = x * col_pooled[p.other]
            else:
                # matmul (a frozen projection; f32, TF32 off) or affine
                c = post_consts.get((g.gid, idx, i), {})
                if p.op == "matmul":
                    x = torch.matmul(x, c["weight"])
                else:
                    if "scale" in c:
                        x = x * c["scale"]
                    if "bias" in c:
                        x = x + c["bias"]
        parts.append(x)
    if not parts:
        return pooled[:, :0, 0]        # all-hidden group: width-0 concat
    return torch.cat(parts, dim=1)


def mlp_apply(layers, x, activation: str, final_activation):
    """Dense layers in full f32 (the Engine turns TF32 off)."""
    for i, layer in enumerate(layers):
        x = torch.matmul(x, layer["w"]) + layer["b"]
        last = i == len(layers) - 1
        if not last:
            x = _act(activation, x)
        elif final_activation:
            x = _act(final_activation, x)
    return x


class Engine:
    """Compiled recommendation-model engine on one device.

    >>> eng = Engine(model)                  # compiler pipeline + params on cuda
    >>> out = eng.predict(raw_batch)         # host prep + eager forward

    ``params``: the portable numpy pytree ``{"tables", "tower"}`` (as
    ``init_model_params`` or the JAX package's ``export_params`` produce
    it); default: ``init_model_params(model)``.  ``device``: default
    ``"cuda"``; ``"cpu"`` runs every kernel's plain PyTorch version.

    ``device_params`` holds leaf tensors: the stacked group tables under
    ``"stacked"`` (one-hot groups as ``[C_pad, V_pad, d]``), in the stored
    dtype ``config.table_dtype`` names (f32, bf16, or an int8
    ``QuantizedTable`` of rows and per-row scales), and the tower's layers
    under ``"tower"``.  ``predict`` runs under
    ``torch.inference_mode``; ``train.Trainer`` makes the leaves require
    grad and updates them in place, and the same Engine goes on serving
    the updated values."""

    def __init__(
        self,
        model: ModelSpec,
        config: Optional[EngineConfig] = None,
        params: Optional[Dict] = None,
        device=None,
    ):
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        cfg = self.config
        if cfg.mesh_shape is not None:
            raise _unported("mesh_shape (multi-device serving)", "item 13")
        # TF32 would round the tower's f32 matmul inputs to 10 mantissa
        # bits, far outside the rtol 1e-4 the outputs are held to against
        # the f32 oracle; both switches off (cuDNN's is on by default)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model, self.pass_report = run_passes(model, cfg)
        self.compiled: CompiledModel = lower_model(self.model, cfg)
        self._fold_emb_perm = folds_emb_perm(self.model.tower,
                                             self.compiled.total_emb_dim)
        self._wire = bool(cfg.wire_pack)

        np_params = params if params is not None else init_model_params(model)
        self.device_params = self._build_device_params(np_params)
        self._consts = self._build_group_consts()
        self._post_consts = self._build_post_consts()
        self._has_mul_column = any(
            p.op == "mul_column" for g in self.compiled.groups
            for m in g.members for p in m.column.post)
        # the model-order permutation of the grouped embeddings, on the
        # device once (_model_order)
        self._emb_perm = torch.as_tensor(self.compiled.emb_perm,
                                         dtype=torch.int64,
                                         device=self.device)
        self._triu = self._build_triu()
        self._rowlen_hints: Dict[int, int] = {}
        self._programs = set()      # (signature, mode) keys served
        self._programs_lock = threading.Lock()
        self.stats = {"calls": 0, "compiles": 0}
        from recom_tpu_torch.utils.logging import Logger, StageTimer

        self.log = Logger("engine", cfg.log_verbosity or None)
        self.timers = StageTimer()
        for s in self.pass_report.stages:
            self.log.vlog(f"pass {s}")

    @staticmethod
    def _fused_bucketize(g) -> bool:
        """A one-hot group of bucketize columns only, with no id LUT: K2
        takes it whenever its raw floats reach the device."""
        return (
            g.pallas_vocab is not None
            and g.n_bucketize == g.num_columns
            and g.lut_matrix is None
        )

    # ------------------------------------------------------------------
    def _build_device_params(self, np_params: Dict) -> Dict:
        """The tables in their stored dtype (recom_tpu/runtime/executor.py:
        218-268): f32; bf16, rounded to nearest even from the f32 values
        (the kernels upcast each row after its load); or int8 with per-row
        scales (``ops/quant.QuantizedTable``; the lowering sends every
        group of an int8 engine down the gather path)."""
        dev = self.device
        tdtype = self.config.table_dtype
        dp: Dict = {"stacked": {}, "tower": {}}
        for g in self.compiled.groups:
            if g.pallas_vocab is not None:
                # one-hot group layout [C_pad, V_pad, d] (the reference's
                # Pallas layout; K1 reads planes c < C only)
                c_pad = ((g.num_columns + 7) // 8) * 8
                t3 = np.zeros((c_pad, g.pallas_vocab, g.dim), np.float32)
                for i, m in enumerate(g.members):
                    tbl = np.asarray(np_params["tables"][m.table], np.float32)
                    t3[i, : tbl.shape[0]] = tbl
                dp["stacked"][str(g.gid)] = _stored(t3, tdtype).to(dev)
                continue
            stacked = self.compiled.stacked_table(g, np_params["tables"])
            if tdtype == "int8":
                q, scale = quantize_rows_chunked(stacked)
                dp["stacked"][str(g.gid)] = QuantizedTable(
                    torch.from_numpy(q).to(dev),
                    torch.from_numpy(scale).to(dev))
            else:
                dp["stacked"][str(g.gid)] = _stored(stacked, tdtype).to(dev)
            del stacked
        for key, layers in np_params["tower"].items():
            dp["tower"][key] = [
                {
                    "w": torch.tensor(np.asarray(l["w"], np.float32),
                                      device=dev),
                    "b": torch.tensor(np.asarray(l["b"], np.float32),
                                      device=dev),
                }
                for l in layers
            ]
        if self._fold_emb_perm:
            # fold the model-order embedding permutation into the first top
            # matmul's rows; scatter-ADD, since with dedup_subcolumns
            # several model-order slots can alias one grouped slot
            # (recom_tpu/runtime/executor.py:304-323)
            w_m = np.asarray(np_params["tower"]["top"][0]["w"], np.float32)
            perm_full = self._fold_perm_full()
            rows_g = (
                len(perm_full) - self.compiled.total_emb_dim
                + self.compiled.grouped_emb_dim
            )
            w_g = np.zeros((rows_g,) + w_m.shape[1:], w_m.dtype)
            np.add.at(w_g, perm_full, w_m)
            dp["tower"]["top"][0]["w"] = torch.from_numpy(w_g).to(dev)
        return dp

    def _fold_perm_full(self) -> np.ndarray:
        """Row permutation of the first top-MLP matmul under emb-perm
        folding: identity on the dense/bottom front, emb_perm on the
        embedding block."""
        tower = self.model.tower
        n_dense = self.compiled.n_dense
        front_w = (
            tower.bottom_mlp[-1]
            if (tower.bottom_mlp and n_dense)
            else n_dense
        )
        return np.concatenate(
            [
                np.arange(front_w, dtype=np.int64),
                front_w + np.asarray(self.compiled.emb_perm, dtype=np.int64),
            ]
        )

    def _build_group_consts(self) -> List[Dict[str, torch.Tensor]]:
        """Per-group static metadata, on the device once."""
        dev = self.device
        out = []
        for g in self.compiled.groups:
            c = {
                "caps": torch.as_tensor(g.vocab_caps, dtype=torch.int32,
                                        device=dev),
                "row_offsets": torch.as_tensor(g.row_offsets,
                                               dtype=torch.int32, device=dev),
                "codes": torch.as_tensor(g.combiner_code, dtype=torch.int32,
                                         device=dev),
                "weighted": torch.as_tensor(g.weighted_cols,
                                            dtype=torch.uint8, device=dev),
            }
            if g.n_bucketize:
                c["boundaries"] = torch.as_tensor(g.boundary_matrix,
                                                  device=dev)
                c["counts"] = torch.as_tensor(g.boundary_counts,
                                              dtype=torch.int32, device=dev)
                if g.lut_matrix is not None:
                    c["lut"] = torch.as_tensor(g.lut_matrix,
                                               dtype=torch.int32, device=dev)
            if self._fused_bucketize(g):
                # K2's interval arrays, sized like the group's table3
                c_pad = int(self.device_params["stacked"][str(g.gid)].shape[0])
                lo, hi, cnts = bucket_bounds(g.boundary_matrix,
                                             g.boundary_counts,
                                             g.pallas_vocab, c_pad)
                c["bz_lo"] = torch.from_numpy(lo).to(dev)
                c["bz_hi"] = torch.from_numpy(hi).to(dev)
                c["bz_counts"] = torch.from_numpy(cnts).to(dev)
            out.append(c)
        return out

    def _build_post_consts(self) -> Dict[Tuple[int, int, int],
                                         Dict[str, torch.Tensor]]:
        """The frozen matmul weights and affine scales and biases of every
        member's post chain, on the device once (constants, never leaves:
        they live in the spec, not the params)."""
        out = {}
        for g in self.compiled.groups:
            for idx, m in enumerate(g.members):
                for i, p in enumerate(m.column.post):
                    fields = {"matmul": ("weight",),
                              "affine": ("scale", "bias")}.get(p.op, ())
                    c = {
                        f: torch.as_tensor(np.asarray(getattr(p, f),
                                                      np.float32),
                                           device=self.device)
                        for f in fields if getattr(p, f) is not None
                    }
                    if c:
                        out[(g.gid, idx, i)] = c
        return out

    def _build_triu(self) -> Optional[torch.Tensor]:
        """dlrm_dot: the strict upper triangle of the [n_vec, n_vec] Gram
        matrix as a flat index, on the device once
        (recom_tpu/runtime/executor.py:614)."""
        if self.model.tower.arch != "dlrm_dot":
            return None
        n_vec = 1 + len(self.model.embedding_columns)
        iu = np.triu_indices(n_vec, k=1)
        return torch.as_tensor(iu[0] * n_vec + iu[1], dtype=torch.int64,
                               device=self.device)

    # ------------------------------------------------------------------
    def group_ids(self, g, packed: Dict) -> Tuple[torch.Tensor,
                                                  Optional[torch.Tensor]]:
        """(ids [C, Bp, L] int32, weights [C, Bp, L] f32 or None) of one
        group, column-major as the host staged them."""
        parts = []
        if g.n_bucketize and "bz_ids" in packed:
            # ids computed on host (host_bucketize wire path; LUT fused)
            parts.append(packed["bz_ids"][:, :, None])
        elif g.n_bucketize:
            c = self._consts[g.gid]
            bz = device_bucketize(packed["raw_bz"], c["boundaries"],
                                  c["counts"])                  # [nbz, Bp]
            if "lut" in c:
                cols = torch.arange(g.n_bucketize, device=bz.device)[:, None]
                bz = c["lut"][cols, bz.long()]
            parts.append(bz[:, :, None])
        if "host_ids" in packed:
            parts.append(packed["host_ids"])
        ids = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        return ids.to(torch.int32).contiguous(), packed.get("weights")

    def _embedding_forward(self, arrays) -> Tuple[torch.Tensor, List]:
        """Grouped lookups -> (grouped-order emb concat [Bp, grouped_emb],
        per-group pooled [Bp, C, d] list)."""
        pooled_list = []
        gathers = []            # (slot in pooled_list, group_pooled args)
        for g, packed in zip(self.compiled.groups, arrays["groups"]):
            c = self._consts[g.gid]
            table = self.device_params["stacked"][str(g.gid)]
            if "bz_hi" in c and "raw_bz" in packed:
                # the raw [n_bz, Bp] plane as the host staged it: K2 never
                # materializes ids (recom_tpu/runtime/executor.py:452-476)
                pooled_list.append(onehot_bucketize_lookup(
                    table, packed["raw_bz"], c["bz_lo"],
                    c["bz_hi"], c["bz_counts"],
                ))
                continue
            ids, weights = self.group_ids(g, packed)
            if g.pallas_vocab is not None:
                # one id per entry: every combiner passes the row through
                # (divisor 1) or gives 0 for a missing id
                pooled_list.append(onehot_lookup(
                    table, ids[:, :, 0].contiguous(), c["caps"]))
            else:
                gathers.append((len(pooled_list), (
                    table, ids, c["row_offsets"], c["codes"],
                    None if weights is None else weights.contiguous(),
                    c["weighted"], c["caps"],
                )))
                pooled_list.append(None)
        # every gather group in one launch of X1
        for (slot, _), pooled in zip(
                gathers, groups_pooled([a for _, a in gathers])):
            pooled_list[slot] = pooled
        # the concats only once every group has pooled: a mul_column post
        # reads another column's raw pooled output, from any group
        col_pooled = None
        if self._has_mul_column:
            col_pooled = {
                col: pooled_list[gid][:, idx, :]
                for col, (gid, idx) in self.compiled.column_slot.items()
            }
        group_out = [
            group_concat(g, p, col_pooled, self._post_consts)
            for g, p in zip(self.compiled.groups, pooled_list)
        ]
        if group_out:
            grouped = torch.cat(group_out, dim=1)
        else:
            bp = arrays["dense"].shape[1]
            grouped = torch.zeros((bp, 0), dtype=torch.float32,
                                  device=self.device)
        return grouped, pooled_list

    def _model_order(self, grouped: torch.Tensor) -> torch.Tensor:
        if grouped.shape[1] == 0:
            return grouped
        return grouped.index_select(1, self._emb_perm)

    def _tower_forward(self, dense, emb, logits_only: bool = False):
        """emb: GROUPED order when _fold_emb_perm, else model order (always
        for ``dlrm_dot``).  ``logits_only`` strips the final activation
        (losses want logits).  Returns (out, front): ``front`` is the
        dense-side prefix of the concat (the raw dense inputs under
        ``dlrm_dot``, as in the reference)."""
        tower = self.model.tower
        params = self.device_params["tower"]
        front = dense
        if tower.arch == "dlrm_dot":
            # DLRM's dot interaction (recom_tpu/runtime/executor.py:597-617):
            # the Gram matrix of [bottom output, model-order embeddings] in
            # f32 (TF32 off), its strict upper triangle beside the bottom
            bottom = mlp_apply(params["bottom"], dense, tower.activation,
                               tower.activation)
            # every embedding column, hidden ones included, as the
            # reference counts them: a hidden column fails this reshape there
            n_emb = len(self.model.embedding_columns)
            d = bottom.shape[1]
            vecs = torch.cat([bottom[:, None, :],
                              emb.reshape(emb.shape[0], n_emb, d)], dim=1)
            gram = torch.bmm(vecs, vecs.transpose(1, 2))
            inter = gram.reshape(gram.shape[0], -1).index_select(
                1, self._triu)
            tower_in = torch.cat([bottom, inter], dim=1)
        elif tower.arch == "mlp":
            if tower.bottom_mlp and dense.shape[1]:
                front = mlp_apply(params["bottom"], dense, tower.activation,
                                  tower.activation)
            tower_in = torch.cat([front, emb], dim=1)
        else:
            raise ValueError(tower.arch)
        out = mlp_apply(params["top"], tower_in, tower.activation,
                        None if logits_only else tower.final_activation)
        return out, front

    def _forward(self, arrays, signature, mode=(), logits_only: bool = False):
        """The device forward of one prepared batch.  Differentiable in the
        device params where they require grad (train.Trainer sets that):
        every kernel wrapper on the path has its backward kernel."""
        if "blob" in arrays:
            from recom_tpu_torch.runtime.wire import unpack_blob

            bp, rowlens = signature[0], signature[1]
            wsig = signature[2] if len(signature) > 2 else ()
            arrays = unpack_blob(self.compiled, arrays["blob"], bp, rowlens,
                                 wsig)
        grouped, pooled_list = self._embedding_forward(arrays)
        emb_tower = (
            grouped if self._fold_emb_perm else self._model_order(grouped)
        )
        out, front = self._tower_forward(arrays["dense"].T, emb_tower,
                                         logits_only)
        result = {"output": out}
        if "concat" in mode:
            result["concat"] = torch.cat(
                [front, self._model_order(grouped)], dim=1
            )
        if "pooled" in mode:
            result["pooled_groups"] = pooled_list
        return result

    def to_device(self, prepared: PreparedBatch) -> Dict:
        """The prepared host arrays as device tensors: the wire blob crosses
        as ONE copy, structured arrays one copy each."""
        dev = self.device
        a = prepared.arrays
        if "blob" in a:
            return {"blob": torch.from_numpy(a["blob"]).to(dev)}
        return {
            "dense": torch.from_numpy(a["dense"]).to(dev),
            "groups": [
                {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
                for g in a["groups"]
            ],
        }

    # ------------------------------------------------------------------
    def prepare(self, batch: Dict, batch_size: Optional[int] = None):
        """prepare_batch with the engine's cached per-group rowlen hints."""
        if self._wire:
            from recom_tpu_torch.runtime.wire import prepare_batch_wire

            prepared = prepare_batch_wire(
                self.compiled, batch, batch_size,
                rowlen_hints=self._rowlen_hints,
                timers=self.timers,
            )
        else:
            prepared = prepare_batch(
                self.compiled, batch, batch_size,
                rowlen_hints=self._rowlen_hints,
            )
        for g, rl in zip(self.compiled.groups, prepared.rowlens):
            if g.ragged:
                self._rowlen_hints[g.gid] = rl
        return prepared

    def predict(
        self,
        batch: Dict,
        batch_size: Optional[int] = None,
        return_pooled: bool = False,
        return_concat: bool = False,
    ) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        prepared = self.prepare(batch, batch_size)
        self.timers.add("host_prep", time.perf_counter() - t0)
        return self.predict_prepared(
            prepared, return_pooled=return_pooled, return_concat=return_concat
        )

    def predict_prepared(
        self,
        prepared: PreparedBatch,
        return_pooled: bool = False,
        return_concat: bool = False,
    ) -> Dict[str, np.ndarray]:
        mode = ()
        if return_concat:
            mode += ("concat",)
        if return_pooled:
            mode += ("pooled",)
        self._note_program(prepared.signature, mode)
        t0 = time.perf_counter()
        with torch.inference_mode():
            dev_out = self._forward(
                self.to_device(prepared), prepared.signature, mode
            )
            b = prepared.batch_size
            result: Dict = {
                "output": dev_out["output"][:b].cpu().numpy(),
                "a2a_overflow": 0,
            }
            self.timers.add("device_step", time.perf_counter() - t0)
            self.stats["calls"] += 1
            if return_concat:
                result["concat"] = dev_out["concat"][:b].cpu().numpy()
            if return_pooled:
                groups = [p[:b].cpu().numpy()
                          for p in dev_out["pooled_groups"]]
                result["pooled"] = {
                    col: groups[gid][:, idx, :]
                    for col, (gid, idx) in self.compiled.column_slot.items()
                }
        return result

    # ------------------------------------------------------------------
    def _note_program(self, signature, mode=()) -> None:
        """Count a (shape signature, outputs) pair the first time it is
        served: the eager engine's counterpart of the reference's jit cache
        (recom_tpu/runtime/executor.py:661-680), whose size the batch and
        rowlen buckets bound."""
        key = (signature, tuple(sorted(mode)))
        with self._programs_lock:
            if key not in self._programs:
                self._programs.add(key)
                self.stats["compiles"] += 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stats_report(self) -> Dict:
        """Serving snapshot: call and program counters, per-stage latency
        percentiles (host clock), and each group's layout and kernel."""

        def backend(g) -> str:
            if g.pallas_vocab is None:
                return "pooled_gather (X1)"
            if self._fused_bucketize(g) and not (
                self._wire and self.config.host_bucketize
            ):
                return "onehot_bucketize (K2)"
            return "onehot_lookup (K1)"

        return {
            "counters": dict(self.stats),
            "stage_latency": self.timers.summary(),
            "programs_compiled": len(self._programs),
            "groups": [
                {
                    "gid": g.gid,
                    "dim": g.dim,
                    "columns": g.num_columns,
                    "ragged": g.ragged,
                    "rows": g.stacked_rows,
                    "backend": backend(g),
                }
                for g in self.compiled.groups
            ],
        }

    def warmup(self, batches=None, batch_sizes=None) -> int:
        """Serve one forward per shape signature ahead of traffic: the
        first launch of each kernel builds it (nvcc) and the first of each
        shape fills the allocator's cache.

        * ``batches``: representative raw batches; they also seed the
          rowlen hints, so the first live request skips the counting scan.
        * ``batch_sizes``: those batch buckets, with empty prepared arrays
          (ragged groups at their largest rowlen bucket; under device_hash
          only the host-hash signature, which empty arrays give).
        * neither: every batch bucket of the config.

        Returns the number of signatures new to the engine."""
        before = self.stats["compiles"]
        if batches is not None:
            prepared = [self.prepare(b) for b in batches]
        else:
            from recom_tpu_torch.compiler.buckets import pick_bucket
            from recom_tpu_torch.runtime.host_prep import make_empty_prepared
            from recom_tpu_torch.runtime.wire import make_empty_prepared_wire

            make = (make_empty_prepared_wire if self._wire
                    else make_empty_prepared)
            prepared = [
                make(self.compiled, pick_bucket(
                    self.config.batch_buckets, bs,
                    self.config.allow_truncate_overflow))
                for bs in (batch_sizes or self.config.batch_buckets)
            ]
        with torch.inference_mode():
            for p in prepared:
                self._note_program(p.signature)
                self._forward(self.to_device(p), p.signature)
        self._sync()
        return self.stats["compiles"] - before

    def benchmark(self, batch, iters: int = 100,
                  warmup: int = 10) -> Dict[str, float]:
        """Steady-state time of one step over pre-prepared inputs: H2D copy
        plus device forward, ended by a device synchronize (the reference
        protocol: warm up, then the mean of ``iters`` timed steps).

        ``batch`` may be a list of batches: the timed steps then rotate
        over those whose signature matches the first (warmed on the first,
        timed on the rest)."""
        batches = batch if isinstance(batch, (list, tuple)) else [batch]
        prepped = []
        for bt in batches:
            p = self.prepare(bt)
            if not prepped or p.signature == prepped[0].signature:
                prepped.append(p)
        sig, b0 = prepped[0].signature, prepped[0].batch_size
        self._note_program(sig)
        timed = prepped[1:] if len(prepped) > 1 else prepped
        with torch.inference_mode():
            for _ in range(warmup + 1):
                self._forward(self.to_device(prepped[0]), sig)
            self._sync()
            t0 = time.perf_counter()
            for i in range(iters):
                self._forward(self.to_device(timed[i % len(timed)]), sig)
            self._sync()
        dt = (time.perf_counter() - t0) / iters
        return {"latency_ms": dt * 1e3, "examples_per_s": b0 / dt}

    # ------------------------------------------------------------------
    def reload_params(self, np_params: Dict) -> None:
        raise _unported("Engine.reload_params", "item 10")

    def update_table_rows(self, table: str, row_ids, values) -> int:
        raise _unported("Engine.update_table_rows", "item 10")
