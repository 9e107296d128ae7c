"""Training on the card: the port of recom_tpu/train.py.

The JAX package trains with ``jax.value_and_grad`` over
``Engine._forward(..., logits_only=True)`` plus an optax optimizer.  Here
the same forward runs under autograd: the Engine's device params are leaf
tensors, and every hand kernel on the path has a backward kernel (K1 ->
K3a, K2 -> K3b, X1 -> X1b; X2 yields integer ids and needs none).  The
tower is a plain ``torch.matmul`` product under autograd, in full f32 (the
Engine turns TF32 off).

The optimizers follow optax's formulas in optax's order, each step of each
formula a separate f32 operation: ``adam`` (eps outside the square root,
separate bias corrections, ``optax.scale_by_adam`` then the learning rate),
``rowwise_adagrad`` (recom_tpu/train.py: one accumulator per row for 2-D
tables, elementwise for any other rank, so for every one-hot ``[C_pad,
V_pad, d]`` table), and ``dlrm_optimizer`` (row-wise AdaGrad on the
tables, Adam on the tower).  Like optax's transformations they exist before
the params do: each returns a factory that the Trainer calls on its params,
giving a ``torch.optim.Optimizer``.  Its state is saved as optax's tree
leaves (``opt_state.npz``), so a training checkpoint resumes in either
package.

    >>> tr = Trainer(make_model_e(), EngineConfig(), optimizer=dlrm_optimizer())
    >>> loss = tr.step(raw_batch, labels)

On a mesh (``EngineConfig(mesh_shape=...)``, the mesh half of
recom_tpu/train.py:98-231) every rank of a torch.distributed world builds
the same Trainer and makes the same calls: each takes its data slice of
the batch, labels and mask, and the collectives of the forward back
through their transposes (``parallel.mesh``); see ``Trainer``.

On one card each shape signature's step is one captured CUDA graph (a
``runtime/graphs.Program`` keyed ``(signature, "train")``), the counterpart
of the JAX Trainer's jitted ``train_step`` per signature
(recom_tpu/train.py:123-140, cached at :117 and :213-216): forward, loss,
``torch.autograd.grad``, and the optimizer's update in place.  Its first
step is an eager pass plus the capture; every later step of the signature
loads the batch, labels, mask and Adam's step scalars into the program's
static inputs and replays it.  The CPU and a mesh step eagerly.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from recom_tpu_torch.config import EngineConfig
from recom_tpu_torch.ir.spec import ModelSpec
from recom_tpu_torch.runtime.executor import Engine
from recom_tpu_torch.parallel.mesh import psum
from recom_tpu_torch.runtime.graphs import CudaCapture, Program
from recom_tpu_torch.runtime.host_prep import PreparedBatch
from recom_tpu_torch.utils import spans
from recom_tpu_torch.utils.tree import tree_leaves, tree_map

OptimizerFactory = Callable[[Dict], torch.optim.Optimizer]

_INT32_MAX = np.iinfo(np.int32).max


def param_leaves(params: Dict) -> List[torch.Tensor]:
    """The params tree's tensors in the JAX package's order
    (``jax.tree_util.tree_leaves``): the stacked tables by group id as
    strings ("10" before "2"), then the tower's keys sorted, each layer's
    b before its w."""
    return tree_leaves(params)


class OptaxOptimizer(torch.optim.Optimizer):
    """optax's update rules as a ``torch.optim.Optimizer``.  Each param
    group names its ``rule``, ``"adam"`` (``lr``, ``b1``, ``b2``, ``eps``,
    ``eps_root``) or ``"rowwise_adagrad"`` (``lr``, ``eps``).  State is made
    at construction, as optax's ``init`` makes it: an Adam group keeps one
    step ``count`` (optax's ``ScaleByAdamState.count``) and each of its
    params ``mu`` and ``nu``; a row-wise AdaGrad param its ``acc``.  A param
    with no gradient steps with a zero one, as JAX's dense cotangent
    would.  Every state tensor is written in place, by ``step`` and by
    ``load_state_leaves``, so a captured step (``apply``) reads and writes
    the live state."""

    def __init__(self, param_groups: List[Dict]):
        super().__init__(param_groups, defaults={})
        # id(param) -> (mesh, model axis, whole row width) of a table split
        # by columns over a mesh's model axis (Trainer sets it)
        self.column_split: Dict[int, tuple] = {}
        with spans.span("trainer.optimizer_state"):
            for group in self.param_groups:
                if group["rule"] == "adam":
                    group["count"] = 0
                for p in group["params"]:
                    self.state[p] = self._init_state(group["rule"], p)

    @staticmethod
    def _init_state(rule: str, p: torch.Tensor) -> Dict:
        if rule == "adam":
            return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
        if rule == "rowwise_adagrad":
            shape = p.shape[:1] if p.dim() == 2 else p.shape
            return {"acc": torch.zeros(shape, dtype=torch.float32,
                                       device=p.device)}
        raise ValueError(f"unknown optimizer rule {rule!r}")

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.advance()
        self.apply([p.grad if p.grad is not None else torch.zeros_like(p)
                    for p in self.leaves()])
        return loss

    def leaves(self) -> List[torch.Tensor]:
        """Every param, group after group: the order ``apply`` takes the
        gradients in."""
        return [p for group in self.param_groups for p in group["params"]]

    def advance(self) -> None:
        """Count the step about to be applied: each Adam group's ``count``
        (optax's, saturating at int32's largest)."""
        for group in self.param_groups:
            if group["rule"] == "adam":
                group["count"] = min(group["count"] + 1, _INT32_MAX)

    def step_scalars(self, device) -> np.ndarray:
        """f32 ``[2 * Adam groups]``: each Adam group's two bias corrections
        at its ``count``, as the step on ``device`` applies them with host
        scalars (``apply`` without ``scalars``), for a step that reads them
        on the device.  optax computes ``1 - b ** count`` in f64 (the JAX
        Engine turns on x64), rounded to f32.  ATen divides by such a host
        scalar on CUDA as a product with its reciprocal, rounded to f32
        (``div_true_kernel_cuda``'s CPU-scalar branch), so on a CUDA device
        these are the reciprocals; elsewhere it divides, and these are the
        divisors."""
        cuda = torch.device(device).type == "cuda"
        out = []
        for group in self.param_groups:
            if group["rule"] == "adam":
                for b in (group["b1"], group["b2"]):
                    corr = np.float32(1 - b ** group["count"])
                    out.append(np.float32(1) / corr if cuda else corr)
        return np.asarray(out, np.float32)

    @torch.no_grad()
    def apply(self, grads: List[torch.Tensor], scalars=None) -> None:
        """One update of every param from ``grads`` (one a param, in
        ``leaves`` order), the step already counted (``advance``).
        ``scalars``: None, and each Adam group's bias corrections are host
        scalars from its ``count``; or ``step_scalars``' values in a tensor
        on the params' device, read there, as a captured step must (its
        host scalars would stay those of the step it was captured at)."""
        grads = iter(grads)
        k = 0
        for group in self.param_groups:
            corr = None
            if group["rule"] == "adam" and scalars is not None:
                corr, k = (scalars[k], scalars[k + 1]), k + 2
            for p in group["params"]:
                g = next(grads)
                if group["rule"] == "adam":
                    self._adam(group, p, g, self.state[p], corr)
                else:
                    self._rowwise_adagrad(group, p, g, self.state[p],
                                          self.column_split.get(id(p)))

    @staticmethod
    def _adam(group, p, g, st, corr=None) -> None:
        """optax.scale_by_adam, then scale by -lr, then apply_updates; the
        group's ``count`` is this step's.  ``corr``: the bias corrections as
        0-d device tensors (``step_scalars``), else from ``count``.  The
        moments are written in place, each element rounded as
        ``(1 - b) * g + b * m`` rounds it (float sums and products are
        commutative)."""
        b1, b2 = group["b1"], group["b2"]
        mu = st["mu"].mul_(b1).add_((1 - b1) * g)
        nu = st["nu"].mul_(b2).add_((1 - b2) * (g * g))
        if corr is None:
            # the bias corrections in f64, rounded to f32 (as optax computes
            # them with jax_enable_x64, which the JAX Engine turns on)
            count = group["count"]
            mu_hat = mu / np.float32(1 - b1 ** count)
            nu_hat = nu / np.float32(1 - b2 ** count)
        elif p.device.type == "cuda":
            mu_hat = mu * corr[0]
            nu_hat = nu * corr[1]
        else:
            mu_hat = mu / corr[0]
            nu_hat = nu / corr[1]
        upd = mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])
        p.add_(-group["lr"] * upd)

    @staticmethod
    def _rowwise_adagrad(group, p, g, st, split=None) -> None:
        """recom_tpu/train.py::rowwise_adagrad: one accumulator per row of a
        2-D table (the mean of its squared gradients), elementwise
        otherwise.  ``split``: (mesh, axis, d) of a table split by columns
        over ``axis``: the row's sum of squares is its columns' partial
        sums summed over the axis, then divided by the whole width d, as
        GSPMD reduces ``jnp.mean`` of a column-sharded array.  The
        accumulator is written in place."""
        if p.dim() == 2 and split is not None:
            mesh, axis, d = split
            sq = mesh.all_reduce((g * g).sum(dim=1), axis)
            acc = st["acc"].add_(sq / d)
            s = torch.rsqrt(acc + group["eps"])[:, None]
        elif p.dim() == 2:
            acc = st["acc"].add_((g * g).mean(dim=1))
            s = torch.rsqrt(acc + group["eps"])[:, None]
        else:
            acc = st["acc"].add_(g * g)
            s = torch.rsqrt(acc + group["eps"])
        upd = -group["lr"] * g
        upd.mul_(s)
        p.add_(upd)

    def slot_params(self) -> list:
        """The param each state leaf of ``_slots`` belongs to, in that
        order (None for an Adam group's count)."""
        out = []
        for group in self.param_groups:
            if group["rule"] == "adam":
                out += [None] + list(group["params"]) * 2
            else:
                out += list(group["params"])
        return out

    def state_tensors(self) -> list:
        """Every state value in optax's tree order (``_slots``): tensors,
        and each Adam count as an int."""
        return [d[k] for d, k in self._slots()]

    def _slots(self) -> list:
        """Where each state leaf lives, in the order of
        ``jax.tree_util.tree_leaves(optimizer.init(params))`` for the JAX
        factory of the same name: (dict, key) pairs.  The param groups
        follow optax's states in order (``dlrm_optimizer``: the
        multi_transform's "tables", then "tower"; a masked-out param has
        no leaf), and each group's params are in the params tree's order.
        An Adam group gives its one count, then every param's mu, then
        every nu (``ScaleByAdamState``; the learning-rate scale that
        follows has none); a row-wise AdaGrad group its accumulators."""
        slots = []
        for group in self.param_groups:
            states = [self.state[p] for p in group["params"]]
            if group["rule"] == "adam":
                slots.append((group, "count"))
                slots += [(st, "mu") for st in states]
                slots += [(st, "nu") for st in states]
            else:
                slots += [(st, "acc") for st in states]
        return slots

    def state_leaves(self) -> List[np.ndarray]:
        """Every state value in optax's tree order (``_slots``), as
        numpy: the layout of the JAX Trainer's ``opt_state.npz``."""
        return [v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.int32)
                for v in (d[k] for d, k in self._slots())]

    def _old_leaf_count(self) -> int:
        """The leaf count of this package's layout before it followed
        optax: every param's sorted state keys, one count each."""
        return sum((3 if g["rule"] == "adam" else 1) * len(g["params"])
                   for g in self.param_groups)

    def load_state_leaves(self, leaves: List[np.ndarray]) -> None:
        """The inverse of ``state_leaves``, into this optimizer's state:
        each tensor written in place (a captured step reads it), each Adam
        count set.  Raises ValueError on a wrong leaf count or a wrong
        shape, before anything is written."""
        slots = self._slots()
        if len(slots) != len(leaves):
            old = self._old_leaf_count()
            hint = (f"; {old} is the count of this package's earlier "
                    "per-param layout (count, mu, nu per param), which is "
                    "no longer read" if len(leaves) == old != len(slots)
                    else "")
            raise ValueError(
                f"opt_state leaf count mismatch: checkpoint has "
                f"{len(leaves)}, the optimizer has {len(slots)}; the same "
                f"optimizer is required for resume{hint}"
            )
        for i, ((d, k), arr) in enumerate(zip(slots, leaves)):
            old = d[k]
            want = tuple(old.shape) if isinstance(old, torch.Tensor) else ()
            if tuple(np.shape(arr)) != want:
                raise ValueError(f"opt_state leaf{i} ({k}): shape "
                                 f"{np.shape(arr)}, expected {want}")
        for (d, k), arr in zip(slots, leaves):
            old = d[k]
            if isinstance(old, torch.Tensor):
                with torch.no_grad():
                    old.copy_(torch.as_tensor(np.asarray(arr),
                                              dtype=old.dtype))
            else:
                d[k] = int(arr)


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> OptimizerFactory:
    """``optax.adam`` on every param."""

    def make(params: Dict) -> OptaxOptimizer:
        return OptaxOptimizer([{
            "params": param_leaves(params), "rule": "adam",
            "lr": learning_rate, "b1": b1, "b2": b2, "eps": eps,
            "eps_root": 0.0,
        }])

    return make


def rowwise_adagrad(learning_rate: float = 0.01,
                    eps: float = 1e-10) -> OptimizerFactory:
    """Row-wise AdaGrad on every param (recom_tpu/train.py): one
    accumulator per row of a 2-D table, the mean of the row's squared
    gradients, cutting the state of an [R, d] table from R*d to R floats;
    any other rank keeps an elementwise accumulator."""

    def make(params: Dict) -> OptaxOptimizer:
        return OptaxOptimizer([{
            "params": param_leaves(params), "rule": "rowwise_adagrad",
            "lr": learning_rate, "eps": eps,
        }])

    return make


def dlrm_optimizer(table_lr: float = 0.01,
                   tower_lr: float = 1e-3) -> OptimizerFactory:
    """The standard DLRM split: row-wise AdaGrad on the embedding tables,
    Adam on the dense tower."""

    def make(params: Dict) -> OptaxOptimizer:
        return OptaxOptimizer([
            {"params": tree_leaves(params["stacked"]),
             "rule": "rowwise_adagrad", "lr": table_lr, "eps": 1e-10},
            {"params": tree_leaves(params["tower"]), "rule": "adam", "lr": tower_lr, "b1": 0.9,
             "b2": 0.999, "eps": 1e-8, "eps_root": 0.0},
        ])

    return make


def _host_tensor(x: np.ndarray, pin: bool) -> torch.Tensor:
    """``x`` as a host tensor, in pinned memory where ``pin`` (the source
    of a non-blocking copy to the card)."""
    t = torch.from_numpy(x)
    if not pin:
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def forward_logits(engine: Engine, arrays, signature=None) -> torch.Tensor:
    """Engine forward with the final activation stripped (losses want
    logits), of the batch's rows on one device and of the rank's data
    slice on a mesh.  ``signature`` is required on the single-blob wire
    path (the blob's layout is keyed by it)."""
    return engine._forward(arrays, signature, mode=(), logits_only=True,
                           gather=False)["output"]


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``'s formula, per example."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


class _Phases:
    """The boundaries of a step's device phases, ``NAMES``.  On the card
    four timing events, external so that a capture records them as nodes
    of the step's graph (whether the span recorder is on or not, so the
    graph is the same), read after the step's loss (``report``); elsewhere
    host spans around the eager phases."""

    NAMES = ("device.forward", "device.backward", "device.optimizer")

    def __init__(self, device: torch.device):
        self.events = ([torch.cuda.Event(enable_timing=True, external=True)
                        for _ in range(4)]
                       if device.type == "cuda" else None)

    @contextlib.contextmanager
    def phase(self, i: int):
        """Phase ``i`` of the step: on the card between events ``i`` and
        ``i + 1``, recorded on the current stream; elsewhere a host span."""
        if self.events is None:
            with spans.span(self.NAMES[i]):
                yield
            return
        if i == 0:
            self.events[0].record()
        yield
        self.events[i + 1].record()

    def report(self, parent) -> None:
        """While the recorder is on, record the last step's device phases
        under ``parent``; the step's events must be done (its loss read)."""
        if self.events is None or not spans.enabled():
            return
        ev = self.events
        spans.device(self.NAMES,
                     [a.elapsed_time(b) for a, b in zip(ev, ev[1:])],
                     spans.now(), parent)


class Trainer:
    """Mini training loop: BCE loss on the tower's logits, masked over the
    padded batch, and an optax-rule optimizer, on one device or on a mesh.

    ``device``: default ``"cuda"`` (raises where there is none); ``"cpu"``
    runs every kernel's plain version.  ``mesh``: as ``Engine``'s, for a
    ``config.mesh_shape``.  The Engine's params become leaf tensors that
    require grad, updated in place by ``step``; the same
    ``trainer.engine`` serves them.

    On a mesh (recom_tpu/train.py:98-231 under GSPMD) each rank holds its
    leaves: a striped table's stripe, a column-split table's columns, every
    other leaf whole.  Each rank takes its slice of the labels and mask
    over the "data" axis (``Engine.shard_batch_arrays``' cut, as
    recom_tpu/train.py:217-223 shards them), and the loss is the global
    masked mean: the rank's masked BCE sum over the whole batch's mask
    count, summed over "data" by ``parallel.mesh.psum`` (identity
    backward), so every rank returns the same float.  The gradient of
    every leaf is then summed over "data" (``Mesh.grad_all_reduce``), and
    never over "model": the model ranks of a data slice compute one
    replicated loss, so a replicated leaf's gradient is already whole on
    each of them, and a stripe's or column slice's is its own part of the
    whole.  ``adam`` and row-wise AdaGrad then step each rank's leaves
    locally, except that row-wise AdaGrad on a column-split leaf sums each
    row's squares over "model" first (``OptaxOptimizer._rowwise_adagrad``).

    On one card ``step`` runs through one captured CUDA graph per shape
    signature (``_programs``, keyed ``(signature, "train")``, the
    counterpart of the JAX Trainer's ``_step_cache``): the first step of a
    signature is an eager pass, which serves it, then the capture; later
    ones replay.  The graphs share one memory pool, the Trainer's own
    (``_capture``): a replay writes nothing the Engine's serving programs
    hold.  The CPU and a mesh step eagerly, and ``_programs`` maps each
    key to None.
    """

    def __init__(
        self,
        model: ModelSpec,
        config: Optional[EngineConfig] = None,
        optimizer: Optional[OptimizerFactory] = None,
        params: Optional[Dict] = None,
        device=None,
        mesh=None,
    ):
        if config is not None and config.table_dtype != "float32":
            raise ValueError(
                "training requires table_dtype='float32' (bf16/int8 table "
                "storage is an inference-serving optimization)"
            )
        with spans.span("trainer.init"):
            self._init(model, config, optimizer, params, device, mesh)

    def _init(self, model, config, optimizer, params, device, mesh) -> None:
        self.engine = Engine(model, config, params, device=device, mesh=mesh)
        for leaf in param_leaves(self.engine.device_params):
            leaf.requires_grad_(True)
        with spans.span("trainer.optimizer"):
            self.optimizer = (optimizer or adam(1e-3))(
                self.engine.device_params)
        eng = self.engine
        # id(leaf) -> its layout over the mesh's model axis
        self._layouts = {
            id(eng.device_params["stacked"][str(g.gid)]): eng.layout(g)
            for g in eng.compiled.groups}
        if eng.mesh is not None and hasattr(self.optimizer, "column_split"):
            model_axis = eng._axes()[1]
            m = eng.mesh.shape[model_axis]
            for g in eng.compiled.groups:
                if eng.layout(g) == "columns":
                    leaf = eng.device_params["stacked"][str(g.gid)]
                    self.optimizer.column_split[id(leaf)] = (
                        eng.mesh, model_axis, g.dim)
        self._data_axis = None if eng.mesh is None else eng._axes()[0]
        # (signature, "train") -> its captured Program on one card; -> None
        # (a signature stepped eagerly) on the CPU and on a mesh
        self._programs: Dict = {}
        # (signature, "train") -> the _Phases its program records
        self._phases: Dict = {}
        self._capture = (CudaCapture(eng.device)
                         if eng._capture is not None else None)

    @property
    def params(self) -> Dict:
        return self.engine.device_params

    @staticmethod
    def _labels_mask(prepared: PreparedBatch, labels):
        """(labels, mask): f32 ``[Bp]`` host arrays, the batch's labels and
        ones in its rows, zeros in the padding."""
        bp, b = prepared.batch_padded, prepared.batch_size
        lab = np.zeros((bp,), np.float32)
        lab[:b] = np.asarray(labels, np.float32)
        mask = np.zeros((bp,), np.float32)
        mask[:b] = 1.0
        return lab, mask

    def _masked_loss(self, arrays, signature, lab_t, mask_t) -> torch.Tensor:
        """The masked mean BCE on one device: the forward of the device
        ``arrays``, labels and mask ``[Bp]`` on the device."""
        logits = forward_logits(self.engine, arrays, signature)
        per = sigmoid_bce(logits[:, 0], lab_t)
        return (per * mask_t).sum() / torch.clamp(mask_t.sum(), min=1.0)

    def loss(self, prepared: PreparedBatch, labels) -> torch.Tensor:
        """The masked mean BCE of one prepared batch (a 0-d tensor, under
        autograd); on a mesh the global one, the same on every rank, whose
        gradient is the rank's part (see the class docstring)."""
        eng = self.engine
        bp, b = prepared.batch_padded, prepared.batch_size
        lab, mask = self._labels_mask(prepared, labels)
        if eng.mesh is None:
            return self._masked_loss(eng.to_device(prepared),
                                     prepared.signature,
                                     torch.from_numpy(lab).to(eng.device),
                                     torch.from_numpy(mask).to(eng.device))
        logits = forward_logits(eng, eng.to_device(prepared),
                                prepared.signature)
        n = eng.mesh.shape[self._data_axis]
        r = eng.mesh.axis_index(self._data_axis)
        cut = slice(r * (bp // n), (r + 1) * (bp // n))
        lab_t = torch.from_numpy(lab[cut]).to(eng.device)
        mask_t = torch.from_numpy(mask[cut]).to(eng.device)
        count = torch.tensor(max(float(b), 1.0), device=eng.device)
        per = sigmoid_bce(logits[:, 0], lab_t)
        return psum(eng.mesh, (per * mask_t).sum() / count, self._data_axis)

    def reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum ``grads`` (one a leaf, in the params tree's order) over the
        mesh's "data" axis, in place; nothing on one device."""
        if self.engine.mesh is not None:
            self.engine.mesh.grad_all_reduce(grads, self._data_axis)

    def value_and_grad(self, batch: Dict, labels):
        """(loss, grads) of one raw batch without a step: grads mirrors
        ``params`` (``{"stacked": {gid: ...}, "tower": {key: [{"w", "b"}]}}``),
        on a mesh the rank's leaves (stripes, column slices) summed over
        the "data" axis."""
        loss = self.loss(self.engine.prepare(batch), labels)
        leaves = param_leaves(self.params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, leaves)]
        self.reduce_grads(grads)
        by_leaf = {id(p): g for g, p in zip(grads, leaves)}
        return float(loss.detach()), tree_map(lambda p: by_leaf[id(p)],
                                              self.params)

    def step(self, batch: Dict, labels) -> float:
        """One optimizer step on a raw batch; returns its loss (before the
        update).  On one card through the signature's program
        (``_program_step``; reading the loss is the step's one host sync),
        elsewhere eagerly.

        Spans (``utils/spans``): ``step``, with the step's number, and
        under it ``prepare``; on one card ``step.stage``, ``step.load`` and
        ``step.replay`` (or ``capture``), ``step.loss_wait`` (the host
        blocked in the loss read) and, timed by the card's events, the
        device phases ``device.forward`` (the forward and the masked loss),
        ``device.backward`` (``torch.autograd.grad``) and
        ``device.optimizer`` (``OptaxOptimizer.apply``); elsewhere those
        three host spans around the eager phases, then ``step.loss_wait``."""
        with spans.span("step", fresh=True) as sp:
            return self._step(batch, labels, sp)

    def _step(self, batch: Dict, labels, sp) -> float:
        eng = self.engine
        prepared = eng.prepare(batch)
        if self._capture is not None:
            loss, phases = self._program_step(prepared, labels)
        else:
            loss, phases = self._eager_step(prepared, labels), None
        with spans.span("step.loss_wait"):
            value = float(loss)
        eng.stats["d2h_bytes"] += loss.nbytes
        if phases is not None:
            phases.report(sp)
        return value

    def _eager_step(self, prepared: PreparedBatch, labels) -> torch.Tensor:
        """One step run eagerly (the CPU, a mesh); its loss, detached."""
        self._programs.setdefault((prepared.signature, "train"), None)
        self.optimizer.zero_grad(set_to_none=True)
        with spans.span("device.forward"):
            loss = self.loss(prepared, labels)
        with spans.span("device.backward"):
            loss.backward()
            if self.engine.mesh is not None:
                leaves = param_leaves(self.params)
                for p in leaves:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                self.reduce_grads([p.grad for p in leaves])
        with spans.span("device.optimizer"):
            self.optimizer.step()
        return loss.detach()

    def _program_step(self, prepared: PreparedBatch, labels):
        """Queue one step through the ``(signature, "train")`` program and
        return its loss, a 0-d device tensor: the program's static output,
        which the next replay overwrites; and the program's ``_Phases``.  The batch's staged arrays
        (``Engine._stage``), the labels, the mask and the Adam groups'
        step scalars (``OptaxOptimizer.step_scalars`` after ``advance``)
        are the program's inputs.  The first step of a signature captures
        the program (``Program.capture``: an eager pass of ``_train_fn``,
        which is this step, then the capture, which runs nothing); a later
        one loads the inputs and replays it.  Holds the Engine's dispatch
        lock: the update writes the params that its forwards read.  A
        capture that raises, or whose graph holds other kernels than the
        step launched, raises: nothing steps eagerly instead."""
        eng, opt = self.engine, self.optimizer
        if not isinstance(opt, OptaxOptimizer):
            raise TypeError(
                "a captured training step needs an OptaxOptimizer (adam, "
                "rowwise_adagrad, dlrm_optimizer), got "
                f"{type(opt).__name__}")
        pin = eng.device.type == "cuda"
        with spans.span("step.stage"):
            arrays, _ = eng._stage(prepared)
            lab, mask = self._labels_mask(prepared, labels)
            opt.advance()
            host = {"arrays": arrays, "labels": _host_tensor(lab, pin),
                    "mask": _host_tensor(mask, pin),
                    "scalars": _host_tensor(opt.step_scalars(eng.device),
                                            pin)}
        key = (prepared.signature, "train")
        with eng._dispatch_lock:
            eng.stats["h2d_bytes"] += sum(t.nbytes for t in tree_leaves(host))
            prog = self._programs.get(key)
            if prog is None:
                phases = _Phases(eng.device)
                prog, out = Program.capture(
                    self._capture, eng.device, host,
                    lambda inputs: self._train_fn(inputs, prepared.signature,
                                                  phases))
                self._programs[key] = prog
                self._phases[key] = phases
                return out["loss"], phases
            with spans.span("step.load"):
                prog.load(host)
            with spans.span("step.replay"):
                return prog.replay()["loss"], self._phases[key]

    def _train_fn(self, inputs: Dict, signature, phases: _Phases) -> Dict:
        """The step a program holds, on its static ``inputs``: the forward
        and the masked BCE, the gradients by ``torch.autograd.grad`` (the
        step's temporaries: no ``.grad`` is kept), and the optimizer's
        update in place with the step scalars read on the device, each a
        phase of ``phases``.  Returns ``{"loss": the loss before the
        update}``."""
        with phases.phase(0):
            loss = self._masked_loss(inputs["arrays"], signature,
                                     inputs["labels"], inputs["mask"])
        leaves = self.optimizer.leaves()
        with phases.phase(1):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with phases.phase(2):
            self.optimizer.apply(
                [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, leaves)], inputs["scalars"])
        return {"loss": loss.detach()}

    def _state_layout(self, p, t) -> str:
        """How a state tensor ``t`` of param ``p`` lies over the mesh:
        ``"striped"`` (a stripe's rows), ``"columns"`` (a column slice,
        for a state of the param's shape) or ``"whole"``."""
        layout = self._layouts.get(id(p)) if p is not None else None
        if layout == "striped":
            return "striped"
        if layout == "columns" and t.dim() == p.dim():
            return "columns"
        return "whole"

    def global_state_leaves(self) -> List[np.ndarray]:
        """The optimizer state in optax's leaf order, as numpy, each leaf
        in its global physical layout (recom_tpu/train.py:139-150: a
        striped leaf's stripes one after another, a column-split leaf's
        columns side by side): gathered over the model axis on a mesh,
        where every rank calls it alike."""
        if self.engine.mesh is None:
            return self.optimizer.state_leaves()
        mesh, model = self.engine.mesh, self.engine._axes()[1]
        out = []
        for p, t in zip(self.optimizer.slot_params(),
                        self.optimizer.state_tensors()):
            if not isinstance(t, torch.Tensor):
                out.append(np.asarray(t, np.int32))
                continue
            kind = self._state_layout(p, t)
            t = t.detach()
            if kind == "striped":
                t = mesh.all_gather(t, model).flatten(0, 1)
            elif kind == "columns":
                t = mesh.all_gather(t, model).movedim(0, -2).flatten(-2)
            out.append(t.cpu().numpy())
        return out

    def load_global_state_leaves(self, leaves: List[np.ndarray]) -> None:
        """The inverse of ``global_state_leaves``: each rank takes its
        stripe or column slice of each leaf."""
        if self.engine.mesh is not None:
            model = self.engine._axes()[1]
            m = self.engine.mesh.shape[model]
            k = self.engine.mesh.axis_index(model)
            local = []
            for p, t, arr in zip(self.optimizer.slot_params(),
                                 self.optimizer.state_tensors(), leaves):
                kind = (self._state_layout(p, t)
                        if isinstance(t, torch.Tensor) else "whole")
                if kind == "striped":
                    per = np.shape(arr)[0] // m
                    arr = arr[k * per:(k + 1) * per]
                elif kind == "columns":
                    w = np.shape(arr)[-1] // m
                    arr = arr[..., k * w:(k + 1) * w]
                local.append(arr)
            leaves = local
        self.optimizer.load_state_leaves(leaves)

    def save(self, path: str) -> None:
        """Checkpoint the full training state for exact resume: the engine
        checkpoint (spec + portable params, runtime/checkpoint.py, which
        the JAX package's load_checkpoint reads) plus the optimizer state
        in ``opt_state.npz``, in optax's tree order: the JAX Trainer's
        ``restore`` resumes from it, and ``restore`` here from the JAX
        Trainer's ``save``.  On a mesh every rank calls it; the params and
        state are gathered (``global_state_leaves``) and rank 0 writes, so
        a save of either package resumes in the other on the same mesh
        shape."""
        from recom_tpu_torch.runtime.checkpoint import save_checkpoint

        save_checkpoint(path, self.engine)
        leaves = self.global_state_leaves()
        mesh = self.engine.mesh
        if mesh is None or mesh.rank == 0:
            np.savez(os.path.join(path, "opt_state.npz"),
                     **{f"leaf{i}": x for i, x in enumerate(leaves)})
        if mesh is not None:
            mesh.barrier()

    @classmethod
    def restore(
        cls,
        path: str,
        config: Optional[EngineConfig] = None,
        optimizer: Optional[OptimizerFactory] = None,
        device=None,
        mesh=None,
    ) -> "Trainer":
        """Rebuild a Trainer from ``save``: the engine from the stored spec
        and params, the optimizer state into a fresh optimizer's (on a
        mesh, each rank its slice of each leaf)."""
        from recom_tpu_torch.runtime.checkpoint import load_checkpoint

        model, params = load_checkpoint(path)
        tr = cls(model, config, optimizer=optimizer, params=params,
                 device=device, mesh=mesh)
        with np.load(os.path.join(path, "opt_state.npz")) as data:
            leaves = [data[f"leaf{i}"] for i in range(len(data.files))]
        tr.load_global_state_leaves(leaves)
        return tr
