"""The Engine, in PyTorch: compile once, serve many batches on the card.

The port of recom_tpu/runtime/executor.py::Engine for the single-device
serving path: host prep (the copied wire/host_prep modules) -> one H2D copy
-> the grouped lookups through the hand-written kernels (K1 for one-hot
groups, K2 for pure-bucketize one-hot groups fed raw floats, X1 for gather
groups, X2 for device string hashing) -> each group's concat, with its
members' post-lookup ops (PostPool) -> the tower (an MLP, or DLRM's
``dlrm_dot`` interaction) -> outputs.  On one card the forward of each
(shape signature, outputs) is one captured CUDA graph (runtime/graphs.py),
the counterpart of the JAX Engine's jitted program per signature: its
first request runs the forward eagerly and captures it, every later one
copies its inputs into the program's static buffers and replays it, and
``stats["compiles"]`` counts the captured programs.  On the CPU and on a
mesh the forward runs eagerly, and ``stats["compiles"]`` counts the
signatures served.  ``dispatch`` queues a forward and returns before the
card finishes (the serving runtime's building block, runtime/server.py);
``update_table_rows`` and ``reload_params`` write the live tensors in
place, so every program reads the new values.

On a mesh (``EngineConfig(mesh_shape=...)``, recom_tpu/runtime/executor.py:
169-195) every rank of a torch.distributed world builds the same Engine
and makes the same calls in the same order; each returns the whole result.
A group over ``shard_rows_above`` rows is striped over the "model" axis
(its rank keeps ``R / m`` rows) and looked up by the all-to-all exchange
or the psum path (``parallel/``); a group wider than ``dim_shard_above``
is split by columns (X1 on the rank's ``d / m`` columns, then an
all_gather along d); every other group and the tower are replicated and
run on the rank's slice of the batch over the "data" axis; the outputs
are all-gathered over it.  The wire blob is off on a mesh, as in JAX.
Under autograd (``train.Trainer`` on a mesh) every collective of the
forward backs through its transpose (``parallel.mesh``), and the output
the loss takes is the rank's data slice (``_forward(gather=False)``).

Entry points run on CUDA unless the caller names another device; asking for
CUDA where there is none raises.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from recom_tpu_torch.compiler.lowering import CompiledModel, lower_model
from recom_tpu_torch.compiler.pipeline import run_passes
from recom_tpu_torch.config import EngineConfig
from recom_tpu_torch.ir.spec import ModelSpec
from recom_tpu_torch.ops.lookup_gather import device_bucketize, groups_pooled
from recom_tpu_torch.ops.item_lists import StepLists
from recom_tpu_torch.ops.lookup_onehot import (
    Searched,
    bucket_bounds,
    onehot_bucketize_lookup,
    onehot_lookups,
    searched_bounds,
)
from recom_tpu_torch.ops.quant import QuantizedTable, quantize_rows_chunked
from recom_tpu_torch.parallel.all_to_all_lookup import (
    a2a_exchange,
    a2a_route,
    pool_args,
    table_rows,
)
from recom_tpu_torch.parallel.mesh import all_gather, psum
from recom_tpu_torch.parallel.sharded_lookup import (
    member_stripe,
    psum_divisors,
    psum_partial_args,
    stripe_rows_of,
)
from recom_tpu_torch.runtime.graphs import CudaCapture, Program
from recom_tpu_torch.runtime.host_prep import PreparedBatch, prepare_batch
from recom_tpu_torch.utils.device import resolve_device
from recom_tpu_torch.utils.params import init_model_params
from recom_tpu_torch.utils.tree import tree_map


_MALLOC_TUNED = False


def _tune_malloc_for_serving() -> None:
    """Raise glibc's mmap threshold so per-request wire blobs (1-4 MB at
    production column counts) are served from the reused heap arena
    instead of a fresh mmap each request, which pays a page fault per page
    (recom_tpu/runtime/executor.py:34-53).  One-shot, best-effort
    (non-glibc hosts no-op), and disabled with RECOM_TPU_MALLOPT=0."""
    global _MALLOC_TUNED
    if _MALLOC_TUNED or os.environ.get("RECOM_TPU_MALLOPT", "1") == "0":
        _MALLOC_TUNED = True
        return
    _MALLOC_TUNED = True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 64 * 1024 * 1024)    # M_MMAP_THRESHOLD
        libc.mallopt(-1, 128 * 1024 * 1024)   # M_TRIM_THRESHOLD
    except Exception:
        pass


# Row-wise products (the tower's layers, a post chain's frozen matmul,
# dlrm_dot's Gram products) run on fixed chunks of ROW_CHUNK rows, each
# chunk one call of the same shape whatever the batch: cuBLAS and the CPU's
# BLAS pick a kernel, and so a summation order, by the call's shape, so a
# row's result must never come from a call whose shape depends on the batch.
# With fixed chunks a row takes the same path, and gives the same bits, in
# every padded batch it sits in, which MicroBatcher's promise needs
# (coalesced rows == the same request served alone; the XLA reference keeps
# it by itself).  Fixed tiles in one batched product are not enough: cuBLAS
# picks that product's kernel by the tile count too, and model F's tower
# gave most rows of a small batch other bits than at 2048.  The tower pads
# its inputs once to whole chunks (Engine._tower_forward), so the
# element-wise ops also see the same shapes in every small bucket.
ROW_CHUNK = 512


def tiled_rows(m: int) -> int:
    """The rows a row-wise product runs on for ``m`` rows: whole chunks of
    ROW_CHUNK, at least one."""
    return max(-(-m // ROW_CHUNK), 1) * ROW_CHUNK


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


class _ChunkedLinear(torch.autograd.Function):
    """``x @ w (+ b)`` for x [n * ROW_CHUNK, K]: one ``mm`` of ROW_CHUNK
    rows at a time into the output's rows, then the bias added.  Every
    chunk's call is the same: x is made contiguous first (a transposed view
    takes another kernel), and the bias is not fused into the product
    (``addmm``'s fused bias takes a route that varied with the batch on the
    card).  The backward is the plain product's (``g @ w.T``, ``x.T @ g``,
    ``g.sum(0)``)."""

    @staticmethod
    def forward(ctx, x, w, b):
        x = x.contiguous()
        out = x.new_empty((x.shape[0], w.shape[1]))
        for i in range(0, x.shape[0], ROW_CHUNK):
            rows = slice(i, i + ROW_CHUNK)
            torch.mm(x[rows], w, out=out[rows])
        if b is not None:
            out.add_(b)
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w.T if ctx.needs_input_grad[0] else None
        gw = x.T @ g if ctx.needs_input_grad[1] else None
        gb = g.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return gx, gw, gb


def row_linear(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w + b`` (f32, TF32 off) whose row results do not depend on the
    number of rows of ``x`` (see ROW_CHUNK)."""
    m = x.shape[0]
    return _ChunkedLinear.apply(pad_rows(x, tiled_rows(m)), w, b)[:m]


def row_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` over a batch of rows, ROW_CHUNK rows a call (the
    batch padded to whole chunks), so a row's product is the same bits in
    every batch (see ROW_CHUNK)."""
    m = a.shape[0]
    n = tiled_rows(m)
    a, b = pad_rows(a, n).contiguous(), pad_rows(b, n).contiguous()
    return torch.cat([torch.bmm(a[i:i + ROW_CHUNK], b[i:i + ROW_CHUNK])
                      for i in range(0, n, ROW_CHUNK)])[:m]


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
    dtype=bfloat16)`` rounds).  A read-only table (``np.load(...,
    mmap_mode="r")``) is wrapped as it is, without a host copy: the tensor
    is only read, copied to the device."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        t = torch.from_numpy(np.ascontiguousarray(table, np.float32))
    return t.to(torch.bfloat16) if table_dtype == "bfloat16" else t


def folds_emb_perm(tower, total_emb_dim: int) -> bool:
    """Whether the model-order embedding permutation folds into the first
    top matmul's rows: only for an MLP tower with top layers and some
    embedding width (recom_tpu/runtime/executor.py:163-167).  An identity
    tower (no top layers) and an order-sensitive tower such as
    ``dlrm_dot`` keep the explicit permutation."""
    return tower.arch == "mlp" and bool(tower.top_mlp) and total_emb_dim > 0


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over dim 1 of ``x`` [B, n] f32, as [B, 1], in numpy's
    pairwise order (``np.add.reduce`` along a contiguous f32 axis): fewer
    than 8 terms added left to right from +0.0; up to 128, eight stride-8
    accumulators started from the first eight terms, combined as ((r0 +
    r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the rest left to
    right; past 128, the two halves (the first a multiple of 8) apart.

    The oracle's reduce_sum and reduce_mean (oracle/reference.py
    ``apply_post``) sum so, and torch's own sum order depends on the
    device: at d = 64 after an affine bias, a card's sum left the
    oracle's by more than 1e-6."""
    n = x.shape[1]
    if n < 8:
        res = torch.zeros_like(x[:, :1])
        for i in range(n):
            res = res + x[:, i:i + 1]
        return res
    if n > 128:
        half = n // 2
        half -= half % 8
        return pairwise_sum(x[:, :half]) + pairwise_sum(x[:, half:])
    stop = n - n % 8
    r = x[:, :8]
    for i in range(8, stop, 8):
        r = r + x[:, i:i + 8]
    r = r[:, 0::2] + r[:, 1::2]          # r0 + r1, r2 + r3, ...
    r = r[:, 0::2] + r[:, 1::2]
    res = r[:, :1] + r[:, 1:]
    for i in range(stop, n):
        res = res + x[:, i:i + 1]
    return res


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
                x = pairwise_sum(x)
            elif p.op == "reduce_mean":
                x = pairwise_sum(x) / x.shape[1]
            elif p.op == "softmax":
                x = torch.softmax(x, dim=1)
            elif p.op == "mul_column":
                # operand = the other column's RAW pooled output
                x = x * col_pooled[p.other]
            else:
                # matmul (a frozen projection; f32, TF32 off) or affine
                c = post_consts.get((g.gid, idx, i), {})
                if p.op == "matmul":
                    x = row_linear(x, c["weight"])
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
    """Dense layers in full f32 (the Engine turns TF32 off), each row's
    result independent of the batch (``row_linear``)."""
    for i, layer in enumerate(layers):
        x = row_linear(x, layer["w"], layer["b"])
        last = i == len(layers) - 1
        if not last:
            x = _act(activation, x)
        elif final_activation:
            x = _act(final_activation, x)
    return x


def _pinned_copy(x):
    """A non-blocking copy of device tensor(s) ``x`` (a tensor or a list of
    them) into pinned host memory."""
    if isinstance(x, list):
        return [_pinned_copy(t) for t in x]
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return host.copy_(x, non_blocking=True)


class InFlight:
    """A forward queued by ``Engine.dispatch``.

    ``outputs``: the device outputs sliced to the batch's size (``"output"``
    and, where asked, ``"concat"`` and ``"pooled_groups"``): on the card,
    with ``fetch``, views of the program's own outputs, which the engine's
    next forward may overwrite; else tensors of their own; ``host``: the
    host tensors that receive them (None for ``fetch=False``); ``event``:
    recorded on the current stream after the forward and the copies (None
    on the CPU); ``seq``: the dispatch's place in the engine's order, which
    the events follow; ``a2a_overflow``: on a mesh, the ids the all-to-all
    exchange dropped (summed over every rank), and ``recomputed``: whether
    the forward was then run again losslessly.  The staged input tensors
    are held until ``result()`` returns."""

    def __init__(self, engine, outputs, host, event, staged, seq, t0,
                 a2a_overflow: int = 0, recomputed: bool = False):
        self.engine = engine
        self.outputs = outputs
        self.host = host
        self.event = event
        self.staged = staged
        self.seq = seq
        self._t0 = t0
        self.a2a_overflow = a2a_overflow
        self.recomputed = recomputed

    def check_overflow(self) -> int:
        """Apply ``a2a_overflow_policy`` to a dispatch that dropped ids
        (recom_tpu/runtime/executor.py:736-777): ``"raise"`` raises;
        ``"warn"`` keeps the degraded result; ``"recompute"`` already ran
        the forward again in ``dispatch``.  Returns the ``a2a_overflow`` the
        result carries: 0 after a recompute."""
        if self.recomputed or not self.a2a_overflow:
            return 0
        if self.engine.config.a2a_overflow_policy == "raise":
            raise RuntimeError(
                f"all-to-all capacity overflow: {self.a2a_overflow} ids "
                "dropped (raise EngineConfig.a2a_capacity_factor or set "
                "shard_comm='psum')")
        return self.a2a_overflow

    def wait(self) -> None:
        """Block until the forward and its copies are done."""
        if self.event is not None:
            self.event.synchronize()

    def result(self) -> Dict[str, np.ndarray]:
        """Wait, then the numpy outputs ``predict_prepared`` returns:
        ``output`` (and ``concat``, and ``pooled`` by column, where
        dispatched) of the batch's true rows, and ``a2a_overflow``
        (``check_overflow``, which raises under the "raise" policy)."""
        if self.host is None:
            raise RuntimeError("dispatched with fetch=False: the outputs stay "
                               "on the device (InFlight.outputs)")
        overflow = self.check_overflow()
        self.wait()
        eng = self.engine
        host = self.host
        result: Dict = {"output": host["output"].numpy(),
                        "a2a_overflow": overflow}
        if "concat" in host:
            result["concat"] = host["concat"].numpy()
        if "pooled_groups" in host:
            groups = [p.numpy() for p in host["pooled_groups"]]
            result["pooled"] = {
                col: groups[gid][:, idx, :]
                for col, (gid, idx) in eng.compiled.column_slot.items()
            }
        if self._t0 is not None:
            eng.timers.add("device_step", time.perf_counter() - self._t0)
            self._t0 = None
        self.staged = None
        return result


class Engine:
    """Compiled recommendation-model engine on one device or on a mesh.

    >>> eng = Engine(model)                  # compiler pipeline + params on cuda
    >>> out = eng.predict(raw_batch)         # host prep + the signature's graph

    ``params``: the portable numpy pytree ``{"tables", "tower"}`` (as
    ``init_model_params`` or the JAX package's ``export_params`` produce
    it); default: ``init_model_params(model)``.  ``device``: default
    ``"cuda"``; ``"cpu"`` runs every kernel's plain PyTorch version.

    On a mesh (``config.mesh_shape``; see the module docstring) ``mesh`` is
    a ``parallel.Mesh`` of that shape, made by the caller, for instance to
    ask for ``backend="gloo"`` where several ranks share a card; by default
    ``make_mesh(config.mesh_shape, config.mesh_axis_names, device=device)``
    (the rank's card, NCCL; gloo for ``device="cpu"``).

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
        mesh=None,
    ):
        self.config = config or EngineConfig()
        cfg = self.config
        self.mesh = self._make_mesh(mesh, device)
        self.device = (resolve_device(device) if self.mesh is None
                       else self.mesh.device)
        # TF32 would round the tower's f32 matmul inputs to 10 mantissa
        # bits, far outside the rtol 1e-4 the outputs are held to against
        # the f32 oracle; both switches off (cuDNN's is on by default)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model, self.pass_report = run_passes(model, cfg)
        self.compiled: CompiledModel = lower_model(self.model, cfg)
        self._fold_emb_perm = folds_emb_perm(self.model.tower,
                                             self.compiled.total_emb_dim)
        self._sharded_gids, self._dim_sharded_gids = self._shard_groups()
        # the single-blob wire is single-device only: the batch split over
        # "data" takes the structured per-array layout
        self._wire = bool(cfg.wire_pack) and self.mesh is None
        _tune_malloc_for_serving()
        # held around every enqueue of a forward (a program's capture and
        # each replay too) and every write of the params: on the CPU an
        # update and a forward exclude each other; on the card a forward is
        # enqueued wholly before or after a write, all on the one current
        # stream
        self._dispatch_lock = threading.Lock()

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
        # (signature, mode) -> its captured Program on one card; -> None
        # (a signature served eagerly) on the CPU and on a mesh
        self._programs: Dict = {}
        self._capture = (CudaCapture(self.device)
                         if self.device.type == "cuda" and self.mesh is None
                         else None)
        self.stats = {"calls": 0, "compiles": 0}
        from recom_tpu_torch.utils.logging import Logger, StageTimer

        self.log = Logger("engine", cfg.log_verbosity or None)
        self.timers = StageTimer()
        for s in self.pass_report.stages:
            self.log.vlog(f"pass {s}")

    def _make_mesh(self, mesh, device):
        """The Engine's mesh, or None on one device."""
        cfg = self.config
        if cfg.mesh_shape is None:
            if mesh is not None:
                raise ValueError("mesh= needs EngineConfig.mesh_shape")
            return None
        import torch.distributed as dist

        from recom_tpu_torch.parallel.mesh import make_mesh, mesh_shape

        names = tuple(cfg.mesh_axis_names)
        if mesh is None:
            return make_mesh(cfg.mesh_shape, names, device=device)
        want = mesh_shape(cfg.mesh_shape, dist.get_world_size())
        if mesh.axis_names != names or tuple(mesh.shape.values()) != want:
            raise ValueError(f"mesh {mesh.shape} differs from the config's "
                             f"{dict(zip(names, want))}")
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} differs from the mesh's "
                             f"{mesh.device}")
        return mesh

    def _shard_groups(self):
        """(row-striped gids, column-split gids), decided as the JAX Engine
        decides them (recom_tpu/runtime/executor.py:179-191): a group over
        ``shard_rows_above`` rows is striped; else one wider than
        ``dim_shard_above`` whose width divides by the model axis, and
        that is not one-hot, is split by columns."""
        striped, split = set(), set()
        if self.mesh is None:
            return striped, split
        m = self.mesh.shape[self.config.mesh_axis_names[1]]
        if m == 1:
            return striped, split
        above = self.config.dim_shard_above
        for g in self.compiled.groups:
            if g.stacked_rows > self.config.shard_rows_above:
                striped.add(g.gid)
            elif (above is not None and g.dim > above and g.dim % m == 0
                  and g.pallas_vocab is None):
                split.add(g.gid)
        return striped, split

    def _axes(self) -> Tuple[str, str]:
        """The mesh's ("data", "model") axis names."""
        return tuple(self.config.mesh_axis_names)

    def layout(self, g) -> str:
        """How this rank stores group ``g``: ``"striped"`` (rows over the
        model axis), ``"columns"`` (columns over it) or ``"replicated"``."""
        if g.gid in self._sharded_gids:
            return "striped"
        if g.gid in self._dim_sharded_gids:
            return "columns"
        return "replicated"

    def _onehot(self, g) -> bool:
        """A one-hot group in its ``[C_pad, V_pad, d]`` layout (K1, K2): a
        striped one-hot group takes the gather layout instead."""
        return g.pallas_vocab is not None and g.gid not in self._sharded_gids

    def _fused_bucketize(self, g) -> bool:
        """A one-hot group of bucketize columns only, with no id LUT: K2
        takes it whenever its raw floats reach the device."""
        return (
            self._onehot(g)
            and g.n_bucketize == g.num_columns
            and g.lut_matrix is None
        )

    def _model_split(self) -> Tuple[int, int]:
        """(model axis size, this rank's index along it); (1, 0) on one
        device."""
        if self.mesh is None:
            return 1, 0
        model = self._axes()[1]
        return self.mesh.shape[model], self.mesh.axis_index(model)

    # ------------------------------------------------------------------
    def _build_device_params(self, np_params: Dict) -> Dict:
        """The tables in their stored dtype (recom_tpu/runtime/executor.py:
        218-268): f32; bf16, rounded to nearest even from the f32 values
        (the kernels upcast each row after its load); or int8 with per-row
        scales (``ops/quant.QuantizedTable``; the lowering sends every
        group of an int8 engine down the gather path).  Each group's leaf
        is made as zeros on the device and each member table written into
        it (``_write_tables``), so no stacked copy is made on the host.  On
        a mesh a striped group's leaf holds the rank's ``ceil(R / m)`` rows
        (with int8, their scales too), a column-split group's its ``d / m``
        columns (int8 scales whole), and every other leaf is whole."""
        self._check_tables(np_params)
        dev = self.device
        tdtype = self.config.table_dtype
        dtype = torch.bfloat16 if tdtype == "bfloat16" else torch.float32
        m_ax, _ = self._model_split()
        dp: Dict = {"stacked": {}, "tower": {}}
        for g in self.compiled.groups:
            rows, d = g.stacked_rows, g.dim
            if self.layout(g) == "striped":
                rows = stripe_rows_of(rows, m_ax)
            elif self.layout(g) == "columns":
                d //= m_ax
            if self._onehot(g):
                # one-hot group layout [C_pad, V_pad, d] (the reference's
                # Pallas layout; K1 reads planes c < C only)
                c_pad = ((g.num_columns + 7) // 8) * 8
                leaf = torch.zeros((c_pad, g.pallas_vocab, g.dim),
                                   dtype=dtype, device=dev)
            elif tdtype == "int8":
                leaf = QuantizedTable(
                    torch.zeros((rows, d), dtype=torch.int8, device=dev),
                    torch.zeros((rows,), dtype=torch.float32, device=dev))
            else:
                leaf = torch.zeros((rows, d), dtype=dtype, device=dev)
            dp["stacked"][str(g.gid)] = leaf
        self._write_tables(dp["stacked"], np_params)
        dp["tower"] = {
            key: [{k: t.to(dev) for k, t in layer.items()}
                  for layer in layers]
            for key, layers in self._tower_host(np_params).items()
        }
        return dp

    def _check_tables(self, np_params: Dict) -> None:
        """Every member's table is in ``np_params`` as [vocab, dim]."""
        tables = np_params.get("tables", {})
        for g in self.compiled.groups:
            for m in g.members:
                if m.table not in tables:
                    raise ValueError(f"params hold no table {m.table!r}")
                shape = tuple(np.shape(tables[m.table]))
                if shape != (m.vocab_size, g.dim):
                    raise ValueError(
                        f"table {m.table!r} is {shape}, the model's is "
                        f"{(m.vocab_size, g.dim)}")

    def _stored_values(self, leaf, g,
                       values: np.ndarray) -> List[torch.Tensor]:
        """f32 host rows [n, d] of group ``g`` on the device as ``leaf``
        stores them: one tensor, f32 or bf16 (rounded to nearest even), or
        an int8 table's rows re-quantized with fresh per-row scales and
        those scales; of a column-split group, the rank's columns (an int8
        row quantized whole first, so its scale is the single device's)."""
        cols = slice(None)
        if self.layout(g) == "columns":
            m_ax, k = self._model_split()
            w = g.dim // m_ax
            cols = slice(k * w, (k + 1) * w)
        if isinstance(leaf, QuantizedTable):
            q, scale = quantize_rows_chunked(np.asarray(values, np.float32))
            return [torch.from_numpy(np.ascontiguousarray(q[:, cols]))
                    .to(self.device), torch.from_numpy(scale).to(self.device)]
        return [_stored(np.asarray(values)[:, cols],
                        self.config.table_dtype).to(self.device)]

    @staticmethod
    def _slot_targets(leaf, i: int, m) -> Tuple[List[torch.Tensor], int]:
        """The tensors member ``m`` (slot ``i`` of its group) is stored in,
        and the row its table starts at in them: the int8 rows and scales
        or the stacked ``[R, d]`` rows at the member's row offset, or plane
        ``i`` of a one-hot ``[C_pad, V_pad, d]`` table at row 0."""
        if isinstance(leaf, QuantizedTable):
            return [leaf.q, leaf.scale], m.row_offset
        if leaf.dim() == 3:
            return [leaf[i]], 0
        return [leaf], m.row_offset

    def _write_tables(self, stacked: Dict, np_params: Dict) -> None:
        """Copy every member table of ``np_params`` into the leaves of
        ``stacked`` in place, one member at a time: the device holds at most
        one member table's stored values besides the leaves (model E: one
        2^23 x 32 table, 1.07 GB in f32), and each copy holds the lock.  A
        striped group's member gives only the rows of the rank's stripe
        (``member_stripe``; of an ``np.load(mmap_mode="r")`` table only
        those are read)."""
        m_ax, k = self._model_split()
        for g in self.compiled.groups:
            leaf = stacked[str(g.gid)]
            for i, m in enumerate(g.members):
                table = np_params["tables"][m.table]
                targets, base = self._slot_targets(leaf, i, m)
                if self.layout(g) == "striped":
                    first, _, base = member_stripe(m.vocab_size, m.row_offset,
                                                   m_ax, k)
                    table = table[first::m_ax]
                vals = self._stored_values(leaf, g, table)
                with self._dispatch_lock, torch.no_grad():
                    for t, v in zip(targets, vals):
                        t[base: base + v.shape[0]].copy_(v)
                del vals

    def _tower_host(self, np_params: Dict) -> Dict:
        """The tower's layers as host f32 tensors, the first top matmul's
        rows in grouped order where the emb-perm folds into it."""
        tower = {
            key: [{"w": torch.tensor(np.asarray(l["w"], np.float32)),
                   "b": torch.tensor(np.asarray(l["b"], np.float32))}
                  for l in layers]
            for key, layers in np_params["tower"].items()
        }
        if self._fold_emb_perm:
            # fold the model-order embedding permutation into the first top
            # matmul's rows; scatter-ADD, since with dedup_subcolumns
            # several model-order slots can alias one grouped slot
            # (recom_tpu/runtime/executor.py:304-323)
            w_m = np.asarray(np_params["tower"]["top"][0]["w"], np.float32)
            perm_full = self._fold_perm_full()
            if w_m.shape[0] != len(perm_full):
                raise ValueError(
                    f"the first top layer has {w_m.shape[0]} rows, the "
                    f"model's tower input is {len(perm_full)} wide")
            rows_g = (
                len(perm_full) - self.compiled.total_emb_dim
                + self.compiled.grouped_emb_dim
            )
            w_g = np.zeros((rows_g,) + w_m.shape[1:], w_m.dtype)
            np.add.at(w_g, perm_full, w_m)
            tower["top"][0]["w"] = torch.from_numpy(w_g)
        return tower

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
            if self._onehot(g) and g.n_bucketize and \
                    not self._fused_bucketize(g):
                # the bucketize members K1 searches in its id read
                # (``Searched``): their bounds and the id LUT
                hi, cnts, lut = searched_bounds(g.boundary_matrix,
                                                g.boundary_counts,
                                                g.lut_matrix)
                c["k1_hi"] = torch.from_numpy(hi).to(dev)
                c["k1_counts"] = torch.from_numpy(cnts).to(dev)
                if lut is not None:
                    c["k1_lut"] = torch.from_numpy(lut).to(dev)
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

    def _embedding_forward(self, arrays, lossless: bool = False):
        """Grouped lookups -> (grouped-order emb concat [b, grouped_emb],
        per-group pooled [b, C, d] list, the all-to-all overflow: None where
        no group took the exchange, else a 0-d tensor summed over every
        rank), for the b rows of ``arrays`` (on a mesh, the rank's data
        slice).  ``lossless``: the exchange at capacity factor m, which
        cannot overflow (``predict``'s "recompute" policy)."""
        pooled_list = []
        gathers = []            # (slot in pooled_list, group_pooled args)
        psums = []              # (slot, group, valid, weights)
        splits = []             # slots of column-split groups
        routed = []             # (slot, group, route, weights)
        onehots = []            # (slot, onehot_lookup args)
        m_ax, k = self._model_split()
        # under autograd on the card: every backward kernel's entries,
        # listed by one launch of Part once the lookups are queued
        plan = (StepLists() if torch.is_grad_enabled()
                and self.device.type == "cuda" else None)
        listed = {} if plan is None else {"lists": plan}
        for g, packed in zip(self.compiled.groups, arrays["groups"]):
            c = self._consts[g.gid]
            table = self.device_params["stacked"][str(g.gid)]
            if "bz_hi" in c and "raw_bz" in packed:
                # the raw [n_bz, Bp] plane as the host staged it: K2 never
                # materializes ids (recom_tpu/runtime/executor.py:452-476)
                pooled_list.append(onehot_bucketize_lookup(
                    table, packed["raw_bz"], c["bz_lo"],
                    c["bz_hi"], c["bz_counts"], **listed,
                ))
                continue
            if "k1_hi" in c and "raw_bz" in packed:
                # the raw [n_bz, Bp] plane and the host ids as staged: K1
                # searches the bucketize members in its id read
                # (recom_tpu/runtime/executor.py:482-505)
                host = packed.get("host_ids")
                host = (torch.empty((0, packed["raw_bz"].shape[1]),
                                    dtype=torch.int32, device=table.device)
                        if host is None else
                        host[:, :, 0].to(torch.int32).contiguous())
                onehots.append((len(pooled_list), (
                    table, host, c["caps"], Searched(
                        packed["raw_bz"].contiguous(), c["k1_hi"],
                        c["k1_counts"], c.get("k1_lut")))))
                pooled_list.append(None)
                continue
            ids, weights = self.group_ids(g, packed)
            if weights is not None:
                weights = weights.contiguous()
            slot = len(pooled_list)
            pooled_list.append(None)
            if self._onehot(g):
                # one id per entry: every combiner passes the row through
                # (divisor 1) or gives 0 for a missing id
                onehots.append((slot, (table, ids[:, :, 0].contiguous(),
                                       c["caps"])))
            elif g.gid in self._sharded_gids and self._takes_a2a(ids):
                factor = (float(m_ax) if lossless
                          else self.config.a2a_capacity_factor)
                routed.append((slot, g, a2a_route(
                    ids, c["row_offsets"], table_rows(table), m_ax, k,
                    factor, True, c["caps"]), weights))
            elif g.gid in self._sharded_gids:
                # the psum path: the partial sums join X1's launch
                args, valid = psum_partial_args(
                    table, ids, c["row_offsets"], m_ax, k, weights, c["caps"])
                gathers.append((slot, args))
                psums.append((slot, g, valid, weights))
            else:
                if g.gid in self._dim_sharded_gids:
                    splits.append(slot)
                gathers.append((slot, (
                    table, ids, c["row_offsets"], c["codes"], weights,
                    c["weighted"], c["caps"],
                )))
        # every one-hot group in one launch of K1; under autograd one K3a
        # launch for them all
        for (slot, _), pooled in zip(
                onehots, onehot_lookups([a for _, a in onehots], **listed)):
            pooled_list[slot] = pooled
        # every gather group in one launch of X1
        for (slot, _), pooled in zip(
                gathers, groups_pooled([a for _, a in gathers], **listed)):
            pooled_list[slot] = pooled
        overflow = None
        if routed:
            model = self._axes()[1]
            chunks = self.config.a2a_chunks
            bufs = [a2a_exchange(self.mesh, self.device_params["stacked"][
                str(g.gid)], route, chunks, model, **listed)
                for _, g, route, _ in routed]
            # the returned rows of every exchanged group in one more launch
            consts = [self._consts[g.gid] for _, g, _, _ in routed]
            mine = groups_pooled([
                pool_args(buf, route, m_ax, chunks, c["codes"], w,
                          c["weighted"], k)
                for buf, c, (_, _, route, w) in zip(bufs, consts, routed)],
                **listed)
            for (slot, _, _, _), p in zip(routed, mine):
                pooled_list[slot] = all_gather(self.mesh, p, model).flatten(
                    0, 1)
            overflow = self.mesh.all_reduce(
                sum(r["overflow"] for _, _, r, _ in routed).reshape(1),
                None)[0]
        for slot, g, valid, weights in psums:
            total = psum(self.mesh, pooled_list[slot], self._axes()[1])
            pooled_list[slot] = psum_divisors(total, valid, weights,
                                              g.combiner_code, g.weighted_cols)
        for slot in splits:
            # [m, b, C, d/m] -> [b, C, m, d/m] -> [b, C, d]
            parts = all_gather(self.mesh, pooled_list[slot], self._axes()[1])
            pooled_list[slot] = parts.permute(1, 2, 0, 3).flatten(2)
        if plan is not None:
            plan.run()
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
        return grouped, pooled_list, overflow

    def _takes_a2a(self, ids: torch.Tensor) -> bool:
        """Whether a striped group's lookup takes the all-to-all exchange
        (recom_tpu/runtime/executor.py:368-403): under ``shard_comm=
        "all_to_all"``, or ``"auto"`` while L <= 2m (the exchange moves
        [b, C, L, d] rows split m ways, the psum [b, C, d] sums twice); only
        where the rank's data slice divides by the model axis, else the
        psum path, with a warning where the exchange was asked for."""
        m_ax, _ = self._model_split()
        mode = self.config.shard_comm
        divisible = ids.shape[1] % m_ax == 0
        want = mode == "all_to_all" or (
            mode == "auto" and divisible and ids.shape[2] <= 2 * m_ax)
        if want and not divisible:
            d_ax = self.mesh.shape[self._axes()[0]]
            self.log.warning(
                f"shard_comm=all_to_all needs batch divisible by "
                f"{d_ax * m_ax}, got {ids.shape[1] * d_ax}; falling back to "
                "psum")
        return want and divisible

    def _model_order(self, grouped: torch.Tensor) -> torch.Tensor:
        if grouped.shape[1] == 0:
            return grouped
        return grouped.index_select(1, self._emb_perm)

    def _tower_forward(self, dense, emb, logits_only: bool = False):
        """emb: GROUPED order when _fold_emb_perm, else model order (always
        for ``dlrm_dot``).  ``logits_only`` strips the final activation
        (losses want logits).  Returns (out, front): ``front`` is the
        dense-side prefix of the concat (the raw dense inputs under
        ``dlrm_dot``, as in the reference).

        The tower runs on its inputs padded to ``tiled_rows`` rows (zero
        rows at the end, sliced off its results): every product and
        element-wise op then sees the same shapes for a row whatever the
        batch bucket, and each row's result is the same bits (ROW_CHUNK)."""
        tower = self.model.tower
        params = self.device_params["tower"]
        bp = dense.shape[0]
        dense = pad_rows(dense, tiled_rows(bp))
        emb = pad_rows(emb, tiled_rows(bp))
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
            gram = row_bmm(vecs, vecs.transpose(1, 2))
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
        return out[:bp], front[:bp]

    def _forward(self, arrays, signature, mode=(), logits_only: bool = False,
                 lossless: bool = False, gather: bool = True):
        """The device forward of one prepared batch (on a mesh, of the
        rank's data slice: ``to_device``), with the whole batch's outputs
        (``gather=False``: the ``"output"`` of the rank's data slice only,
        as the mesh Trainer's loss takes it) and, where a group took the
        all-to-all exchange, ``"a2a_overflow"``.  Differentiable in the
        device params where they require grad (train.Trainer sets that):
        every kernel wrapper has its backward kernel, and on a mesh every
        collective its transpose (``parallel.mesh.psum``, ``all_gather``,
        ``all_to_all``)."""
        if "blob" in arrays:
            from recom_tpu_torch.runtime.wire import unpack_blob

            bp, rowlens = signature[0], signature[1]
            wsig = signature[2] if len(signature) > 2 else ()
            arrays = unpack_blob(self.compiled, arrays["blob"], bp, rowlens,
                                 wsig)
        grouped, pooled_list, overflow = self._embedding_forward(
            arrays, lossless)
        emb_tower = (
            grouped if self._fold_emb_perm else self._model_order(grouped)
        )
        out, front = self._tower_forward(arrays["dense"].T, emb_tower,
                                         logits_only)
        result = {"output": self._gather_batch(out) if gather else out}
        if "concat" in mode:
            result["concat"] = self._gather_batch(torch.cat(
                [front, self._model_order(grouped)], dim=1
            ))
        if "pooled" in mode:
            result["pooled_groups"] = [self._gather_batch(p)
                                       for p in pooled_list]
        if overflow is not None:
            result["a2a_overflow"] = overflow
        return result

    def _gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """On a mesh, the rows of every data slice in order (an all_gather
        over the "data" axis); ``x`` itself on one device."""
        if self.mesh is None:
            return x
        return all_gather(self.mesh, x, self._axes()[0]).flatten(0, 1)

    def to_device(self, prepared: PreparedBatch) -> Dict:
        """The prepared host arrays as device tensors (``_stage``, then
        ``_on_device``)."""
        return self._on_device(self._stage(prepared)[0])

    def _on_device(self, arrays: Dict) -> Dict:
        """``_stage``'s arrays on the engine's device: from pinned memory
        each crosses with ``non_blocking=True``, so the call returns once
        the copy is queued (the caching host allocator keeps a staged block
        until its copy is done); on the CPU, the arrays themselves."""
        return tree_map(lambda t: t.to(self.device, non_blocking=True),
                        arrays)

    def shard_batch_arrays(self, arrays: Dict) -> Dict:
        """On a mesh, the rank's slice of prepared host arrays over the
        "data" axis (recom_tpu/runtime/executor.py:343-355): prepared
        arrays are column-major, batch on axis 1 (host_prep's LAYOUT note),
        and the padded batch must divide by the data axis.  On one device,
        ``arrays`` as they are."""
        if self.mesh is None:
            return arrays
        data = self._axes()[0]
        n, r = self.mesh.shape[data], self.mesh.axis_index(data)
        bp = arrays["dense"].shape[1]
        if bp % n:
            raise ValueError(f"batch bucket {bp} does not divide over the "
                             f"{n} ranks of the data axis")
        per = bp // n

        def cut(x: np.ndarray) -> np.ndarray:
            return np.ascontiguousarray(x[:, r * per:(r + 1) * per])

        return {"dense": cut(arrays["dense"]),
                "groups": [{k: cut(v) for k, v in g.items()}
                           for g in arrays["groups"]]}

    def _stage(self, prepared: PreparedBatch) -> Tuple[Dict, List]:
        """(staged arrays, the staged host tensors) of a prepared batch: the
        wire blob as ONE array, structured arrays one each.  On the card
        each array is copied into pinned host memory, from which
        ``_on_device`` or ``Program.load`` copies it with
        ``non_blocking=True``.  On the CPU the arrays are used as they are.
        On a mesh only the rank's data slice is staged
        (``shard_batch_arrays``)."""
        staged: List[torch.Tensor] = []

        def put(x: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(x)
            if self.device.type != "cuda":
                return t.to(self.device)
            pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            pinned.copy_(t)
            staged.append(pinned)
            return pinned

        a = self.shard_batch_arrays(prepared.arrays)
        if "blob" in a:
            return {"blob": put(a["blob"])}, staged
        return {
            "dense": put(a["dense"]),
            "groups": [{k: put(v) for k, v in g.items()}
                       for g in a["groups"]],
        }, staged

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
        return self.dispatch(prepared, mode).result()

    def dispatch(self, prepared: PreparedBatch, mode=(),
                 fetch: bool = True) -> "InFlight":
        """Queue one prepared batch's forward and return before the device
        finishes: the port's counterpart of the reference pipeline's jitted
        call plus ``jax.block_until_ready`` (recom_tpu/runtime/server.py:
        248-261).  The inputs are staged in pinned memory (``_stage``);
        under the engine's lock they are copied into the static inputs of
        the (signature, mode)'s program and it is replayed (``_run``: the
        first request of a signature captures it, a host sync); with
        ``fetch`` each output (``mode``: ``"concat"``, ``"pooled"`` besides
        ``"output"``) is copied into pinned host memory by a non-blocking
        copy, and without it each is cloned, since the program's next
        replay overwrites its outputs; an event is recorded after them.  No
        host sync on the card once the program exists.  On the CPU the
        forward runs to its end in the call.  ``InFlight.result()`` waits
        and returns what ``predict_prepared`` returns.

        On a mesh the forward's collectives pair with the other ranks'
        dispatches in order, and where the all-to-all exchange dropped ids
        the count (summed over every rank, so every rank decides alike) is
        read here, a host sync: it lands in ``stats["a2a_overflow"]``, and
        under ``a2a_overflow_policy="recompute"`` the forward runs again at
        once at the lossless capacity (``stats["a2a_recomputes"]``);
        ``InFlight.check_overflow`` applies "warn" and "raise"."""
        mode = tuple(mode)
        t0 = time.perf_counter()
        graphed = self._capture is not None
        arrays, staged = self._stage(prepared)
        b = prepared.batch_size
        cuda = self.device.type == "cuda"
        host = event = None
        with self._dispatch_lock, torch.inference_mode():
            dev_out = self._run(arrays, prepared.signature, mode)
            overflow = int(dev_out.get("a2a_overflow", 0))
            recomputed = bool(overflow) and self._overflowed(overflow)
            if recomputed:
                dev_out = self._forward(self._on_device(arrays),
                                        prepared.signature, mode,
                                        lossless=True)
            outputs = {"output": dev_out["output"][:b]}
            if "concat" in mode:
                outputs["concat"] = dev_out["concat"][:b]
            if "pooled" in mode:
                outputs["pooled_groups"] = [p[:b]
                                            for p in dev_out["pooled_groups"]]
            if graphed and not (cuda and fetch):
                # a program's outputs are its own: its next replay
                # overwrites them
                outputs = tree_map(torch.clone, outputs)
            if cuda:
                # the copies and the event queue under the lock too, so the
                # events of successive dispatches follow their order
                if fetch:
                    host = {k: _pinned_copy(v) for k, v in outputs.items()}
                event = torch.cuda.Event()
                event.record()
            self.stats["calls"] += 1
            seq = self.stats["calls"]
        if not cuda and fetch:
            host = outputs
        return InFlight(self, outputs, host, event, staged, seq, t0,
                        overflow, recomputed)

    def _overflowed(self, overflow: int) -> bool:
        """Count a forward whose exchange dropped ``overflow`` ids; whether
        to run it again losslessly (the "recompute" policy: capacity factor
        m, bit for bit the exact result; recom_tpu/runtime/executor.py:
        736-777)."""
        self.stats["a2a_overflow"] = self.stats.get("a2a_overflow", 0) \
            + overflow
        if self.config.a2a_overflow_policy != "recompute":
            if self.config.a2a_overflow_policy == "warn":
                self.log.warning(
                    f"all-to-all capacity overflow: {overflow} ids dropped "
                    "this step (raise EngineConfig.a2a_capacity_factor or "
                    "set shard_comm='psum')")
            return False
        self.stats["a2a_recomputes"] = self.stats.get("a2a_recomputes", 0) + 1
        self.log.warning(f"all-to-all overflow ({overflow} ids): recomputing "
                         "via lossless full-capacity exchange")
        return True

    # ------------------------------------------------------------------
    def _run(self, arrays, signature, mode=()):
        """The forward of one staged batch, queued on the current stream;
        the caller holds ``_dispatch_lock``, under inference mode.  The
        port's counterpart of the reference's jit cache (recom_tpu/runtime/
        executor.py:661-680), whose size the batch and rowlen buckets
        bound: on one card the (signature, mode)'s ``Program``, captured
        at its first use (whose eager pass serves that use) and replayed
        after it on ``arrays`` (``_stage``'s pinned host arrays); on the
        CPU and on a mesh ``_forward`` on ``arrays`` put on the device, the
        signature noted.  Either way ``stats["compiles"]`` counts the keys
        new to the engine.  Returns the forward's outputs: a replay's are
        the program's own."""
        mode = tuple(sorted(mode))
        key = (signature, mode)
        if self._capture is None:
            if key not in self._programs:
                self._programs[key] = None
                self.stats["compiles"] += 1
            return self._forward(self._on_device(arrays), signature, mode)
        prog = self._programs.get(key)
        if prog is not None:
            prog.load(arrays)
            return prog.replay()
        prog, out = Program.capture(
            self._capture, self.device, arrays,
            lambda a: self._forward(a, signature, mode))
        self._programs[key] = prog
        self.stats["compiles"] += 1
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stats_report(self) -> Dict:
        """Serving snapshot: call and program counters, per-stage latency
        percentiles (host clock; on a mesh also each collective's, from
        ``Mesh.timers``), and each group's layout and kernel."""

        def backend(g) -> str:
            if g.gid in self._sharded_gids:
                return f"sharded_{self.config.shard_comm} (X1)"
            if g.pallas_vocab is None:
                return "pooled_gather (X1)"
            if self._fused_bucketize(g) and not (
                self._wire and self.config.host_bucketize
            ):
                return "onehot_bucketize (K2)"
            return "onehot_lookup (K1)"

        latency = self.timers.summary()
        if self.mesh is not None:
            latency.update(self.mesh.timers.summary())
        return {
            "counters": dict(self.stats),
            "stage_latency": latency,
            "programs_compiled": len(self._programs),
            "groups": [
                {
                    "gid": g.gid,
                    "dim": g.dim,
                    "columns": g.num_columns,
                    "ragged": g.ragged,
                    "rows": g.stacked_rows,
                    "backend": backend(g),
                    "layout": self.layout(g),
                }
                for g in self.compiled.groups
            ],
        }

    def warmup(self, batches=None, batch_sizes=None) -> int:
        """Serve one forward per shape signature ahead of traffic, so that
        live requests replay programs: on one card each new signature's
        forward runs eagerly (the first launch of each kernel builds it,
        with nvcc, and the first of each shape fills the allocator's cache)
        and is captured; a signature already captured is replayed.

        * ``batches``: representative raw batches; they also seed the
          rowlen hints, so the first live request skips the counting scan.
        * ``batch_sizes``: those batch buckets, with empty prepared arrays
          (ragged groups at their largest rowlen bucket; under device_hash
          only the host-hash signature, which empty arrays give).
        * neither: every batch bucket of the config.

        Returns the number of programs new to the engine."""
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
        with self._dispatch_lock, torch.inference_mode():
            for p in prepared:
                self._run(self._stage(p)[0], p.signature)
        self._sync()
        return self.stats["compiles"] - before

    def benchmark(self, batch, iters: int = 100,
                  warmup: int = 10) -> Dict[str, float]:
        """Steady-state time of one step over pre-prepared inputs: staging,
        H2D copy and device forward (on one card the replay of the
        signature's program, captured in the first warm-up step), ended by
        a device synchronize (the reference protocol: warm up, then the
        mean of ``iters`` timed steps).

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
        timed = prepped[1:] if len(prepped) > 1 else prepped
        with self._dispatch_lock, torch.inference_mode():
            for _ in range(warmup + 1):
                self._run(self._stage(prepped[0])[0], sig)
            self._sync()
            t0 = time.perf_counter()
            for i in range(iters):
                self._run(self._stage(timed[i % len(timed)])[0], sig)
            self._sync()
        dt = (time.perf_counter() - t0) / iters
        return {"latency_ms": dt * 1e3, "examples_per_s": b0 / dt}

    # ------------------------------------------------------------------
    def reload_params(self, np_params: Dict) -> None:
        """Full parameter hot-swap (recom_tpu/runtime/executor.py:821-831):
        write a portable pytree (the constructor's ``params``, or
        ``checkpoint.load_checkpoint``'s output) into the live tensors IN
        PLACE, so a ``Trainer`` whose optimizer holds them keeps stepping
        them, every ``data_ptr()`` stays (so the captured programs read the
        new values) and no program is new (``stats["compiles"]`` does not
        move).  The stored tensors are made
        as the constructor makes them (stored dtype, emb-perm fold), one
        member table at a time (``_write_tables``), each copy under the
        lock: a request served during the reload sees each table whole, old
        or new, but may see some tables old and others new.  A pytree whose
        shapes differ from the engine's raises ValueError before anything
        is written."""
        self._check_tables(np_params)
        live_tower = self.device_params["tower"]
        tower = self._tower_host(np_params)
        if set(tower) != set(live_tower) or any(
                len(tower[k]) != len(live_tower[k]) for k in tower):
            raise ValueError(
                f"tower layers {({k: len(v) for k, v in tower.items()})} "
                f"differ from the engine's "
                f"{({k: len(v) for k, v in live_tower.items()})}")
        for key, layers in tower.items():
            for i, layer in enumerate(layers):
                for wb, t in layer.items():
                    have = live_tower[key][i][wb].shape
                    if t.shape != have:
                        raise ValueError(
                            f"tower {key}[{i}].{wb} is {tuple(t.shape)}, "
                            f"the engine's is {tuple(have)}")
        self._write_tables(self.device_params["stacked"], np_params)
        with self._dispatch_lock, torch.no_grad():
            for key, layers in tower.items():
                for i, layer in enumerate(layers):
                    for wb, t in layer.items():
                        live_tower[key][i][wb].copy_(t)

    def update_table_rows(self, table: str, row_ids, values) -> int:
        """Online embedding refresh (recom_tpu/runtime/executor.py:833-942):
        overwrite rows of ``table`` in the live tensors, in place, without
        rebuilding or recompiling anything.

        ``row_ids``: [n] member-local rows, 0 <= id < vocab; repeated ids
        keep their LAST value.  ``values``: [n, dim] float32, stored as the
        engine stores the table (bf16 rounded to nearest even; int8
        re-quantized with fresh per-row scales).  A table stacked in several
        member slots (shared by columns or groups) is written in every one:
        its gather group's ``[R, d]`` rows at the member's row offset, or
        its plane of a one-hot ``[C_pad, V_pad, d]`` table.  On a mesh every
        rank makes the same call: a rank writes only the rows of a striped
        group its stripe holds, at ``(row_offset + id) // m``, and only its
        columns of a column-split group.  Returns the number of member
        slots written.

        Concurrency: every write of the call (an int8 table's rows and
        scales alike) is queued under one hold of the engine's lock, so a
        request served meanwhile sees, per table, the old rows or the new
        ones, never a mix.  Checkpoint export reads the same tensors."""
        row_ids = np.asarray(row_ids, dtype=np.int64).reshape(-1)
        values = np.asarray(values, dtype=np.float32)
        if values.ndim != 2 or values.shape[0] != row_ids.shape[0]:
            raise ValueError(
                f"values must be [n, dim] aligned with row_ids: "
                f"{values.shape} vs {row_ids.shape}"
            )
        # keep the LAST occurrence of a repeated id: index_copy_ leaves the
        # order of duplicates unspecified, and an int8 row would take its q
        # and its scale from different occurrences
        if row_ids.size and np.unique(row_ids).size != row_ids.size:
            rev_first = np.unique(row_ids[::-1], return_index=True)[1]
            keep = np.sort(row_ids.size - 1 - rev_first)
            row_ids, values = row_ids[keep], values[keep]
        slots = []
        for g in self.compiled.groups:
            for i, m in enumerate(g.members):
                if m.table != table:
                    continue
                if values.shape[1] != g.dim:
                    raise ValueError(
                        f"table {table!r} has dim {g.dim}, "
                        f"got values dim {values.shape[1]}"
                    )
                if row_ids.size and (
                    row_ids.min() < 0 or row_ids.max() >= m.vocab_size
                ):
                    raise ValueError(
                        f"row_ids out of [0, {m.vocab_size}) for "
                        f"table {table!r}"
                    )
                slots.append((g, i, m))
        if not slots:
            raise KeyError(f"unknown table {table!r}")
        m_ax, k = self._model_split()
        writes = []
        for g, i, m in slots:
            leaf = self.device_params["stacked"][str(g.gid)]
            targets, base = self._slot_targets(leaf, i, m)
            rows, vals = row_ids + base, values
            if self.layout(g) == "striped":
                # only the rows of this rank's stripe, at their local rows
                # (recom_tpu/runtime/executor.py:922-940)
                logical = m.row_offset + row_ids
                mine = logical % m_ax == k
                rows, vals = logical[mine] // m_ax, values[mine]
            writes.append((targets, torch.from_numpy(rows).to(self.device),
                           self._stored_values(leaf, g, vals)))
        with self._dispatch_lock, torch.no_grad():
            for targets, rows, vals in writes:
                for t, v in zip(targets, vals):
                    t.index_copy_(0, rows, v)
        return len(slots)
