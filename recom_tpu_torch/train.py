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
giving a ``torch.optim.Optimizer``.

    >>> tr = Trainer(make_model_e(), EngineConfig(), optimizer=dlrm_optimizer())
    >>> loss = tr.step(raw_batch, labels)
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from recom_tpu_torch.config import EngineConfig
from recom_tpu_torch.ir.spec import ModelSpec
from recom_tpu_torch.runtime.executor import Engine
from recom_tpu_torch.runtime.host_prep import PreparedBatch

OptimizerFactory = Callable[[Dict], torch.optim.Optimizer]

_INT32_MAX = np.iinfo(np.int32).max


def param_leaves(params: Dict) -> List[torch.Tensor]:
    """The params tree's tensors in the port's fixed order: the stacked
    tables in group order, then each tower key's layers, w before b."""
    out = list(params["stacked"].values())
    for layers in params["tower"].values():
        for layer in layers:
            out += [layer["w"], layer["b"]]
    return out


class OptaxOptimizer(torch.optim.Optimizer):
    """optax's update rules as a ``torch.optim.Optimizer``.  Each param
    group names its ``rule``, ``"adam"`` (``lr``, ``b1``, ``b2``, ``eps``,
    ``eps_root``) or ``"rowwise_adagrad"`` (``lr``, ``eps``).  State is made
    at construction, as optax's ``init`` makes it; a param with no gradient
    steps with a zero one, as JAX's dense cotangent would."""

    def __init__(self, param_groups: List[Dict]):
        super().__init__(param_groups, defaults={})
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = self._init_state(group["rule"], p)

    @staticmethod
    def _init_state(rule: str, p: torch.Tensor) -> Dict:
        if rule == "adam":
            return {"count": 0, "mu": torch.zeros_like(p),
                    "nu": torch.zeros_like(p)}
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
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if group["rule"] == "adam":
                    self._adam(group, p, g, self.state[p])
                else:
                    self._rowwise_adagrad(group, p, g, self.state[p])
        return loss

    @staticmethod
    def _adam(group, p, g, st) -> None:
        """optax.scale_by_adam, then scale by -lr, then apply_updates."""
        b1, b2 = group["b1"], group["b2"]
        mu = (1 - b1) * g + b1 * st["mu"]
        nu = (1 - b2) * (g * g) + b2 * st["nu"]
        count = min(st["count"] + 1, _INT32_MAX)
        # the bias corrections in f64, rounded to f32 (as optax computes
        # them with jax_enable_x64, which the JAX Engine turns on)
        mu_hat = mu / np.float32(1 - b1 ** count)
        nu_hat = nu / np.float32(1 - b2 ** count)
        upd = mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])
        p.add_(-group["lr"] * upd)
        st.update(count=count, mu=mu, nu=nu)

    @staticmethod
    def _rowwise_adagrad(group, p, g, st) -> None:
        """recom_tpu/train.py::rowwise_adagrad: one accumulator per row of a
        2-D table (the mean of its squared gradients), elementwise
        otherwise."""
        if p.dim() == 2:
            acc = st["acc"] + (g * g).mean(dim=1)
            s = torch.rsqrt(acc + group["eps"])[:, None]
        else:
            acc = st["acc"] + g * g
            s = torch.rsqrt(acc + group["eps"])
        upd = -group["lr"] * g
        upd.mul_(s)
        p.add_(upd)
        st["acc"] = acc

    def state_leaves(self) -> List[np.ndarray]:
        """Every state value in a fixed order (param groups, their params,
        then each param's state keys sorted), as numpy."""
        out = []
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                for k in sorted(st):
                    v = st[k]
                    out.append(v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v, np.int32))
        return out

    def load_state_leaves(self, leaves: List[np.ndarray]) -> None:
        """The inverse of ``state_leaves``, into this optimizer's state."""
        slots = [(self.state[p], k)
                 for group in self.param_groups for p in group["params"]
                 for k in sorted(self.state[p])]
        if len(slots) != len(leaves):
            raise ValueError(
                f"opt_state leaf count mismatch: checkpoint has "
                f"{len(leaves)}, the optimizer has {len(slots)}; the same "
                "optimizer is required for resume"
            )
        for (st, k), arr in zip(slots, leaves):
            old = st[k]
            if isinstance(old, torch.Tensor):
                if tuple(arr.shape) != tuple(old.shape):
                    raise ValueError(f"opt_state leaf {k}: shape "
                                     f"{arr.shape}, expected {old.shape}")
                st[k] = torch.as_tensor(arr, dtype=old.dtype,
                                        device=old.device).clone()
            else:
                st[k] = int(arr)


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
        tower = param_leaves({"stacked": {}, "tower": params["tower"]})
        return OptaxOptimizer([
            {"params": list(params["stacked"].values()),
             "rule": "rowwise_adagrad", "lr": table_lr, "eps": 1e-10},
            {"params": tower, "rule": "adam", "lr": tower_lr, "b1": 0.9,
             "b2": 0.999, "eps": 1e-8, "eps_root": 0.0},
        ])

    return make


def forward_logits(engine: Engine, arrays, signature=None) -> torch.Tensor:
    """Engine forward with the final activation stripped (losses want
    logits).  ``signature`` is required on the single-blob wire path (the
    blob's layout is keyed by it)."""
    return engine._forward(arrays, signature, mode=(),
                           logits_only=True)["output"]


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``'s formula, per example."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


class Trainer:
    """Mini training loop: BCE loss on the tower's logits, masked over the
    padded batch, and an optax-rule optimizer, on one device.

    ``device``: default ``"cuda"`` (raises where there is none); ``"cpu"``
    runs every kernel's plain version.  The Engine's params become leaf
    tensors that require grad, updated in place by ``step``; the same
    ``trainer.engine`` serves them."""

    def __init__(
        self,
        model: ModelSpec,
        config: Optional[EngineConfig] = None,
        optimizer: Optional[OptimizerFactory] = None,
        params: Optional[Dict] = None,
        device=None,
    ):
        if config is not None and config.table_dtype != "float32":
            raise ValueError(
                "training requires table_dtype='float32' (bf16/int8 table "
                "storage is an inference-serving optimization)"
            )
        if config is not None and config.mesh_shape is not None:
            raise NotImplementedError(
                "training on a mesh is not ported to recom_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 13)"
            )
        self.engine = Engine(model, config, params, device=device)
        for leaf in param_leaves(self.engine.device_params):
            leaf.requires_grad_(True)
        self.optimizer = (optimizer or adam(1e-3))(self.engine.device_params)

    @property
    def params(self) -> Dict:
        return self.engine.device_params

    def loss(self, prepared: PreparedBatch, labels) -> torch.Tensor:
        """The masked mean BCE of one prepared batch (a 0-d tensor, under
        autograd)."""
        eng = self.engine
        bp, b = prepared.batch_padded, prepared.batch_size
        lab = np.zeros((bp,), np.float32)
        lab[:b] = np.asarray(labels, np.float32)
        mask = np.zeros((bp,), np.float32)
        mask[:b] = 1.0
        lab_t = torch.from_numpy(lab).to(eng.device)
        mask_t = torch.from_numpy(mask).to(eng.device)
        logits = forward_logits(eng, eng.to_device(prepared),
                                prepared.signature)
        per = sigmoid_bce(logits[:, 0], lab_t)
        return (per * mask_t).sum() / torch.clamp(mask_t.sum(), min=1.0)

    def value_and_grad(self, batch: Dict, labels):
        """(loss, grads) of one raw batch without a step: grads mirrors
        ``params`` (``{"stacked": {gid: ...}, "tower": {key: [{"w", "b"}]}}``)."""
        loss = self.loss(self.engine.prepare(batch), labels)
        leaves = param_leaves(self.params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = iter(g if g is not None else torch.zeros_like(p)
                     for g, p in zip(grads, leaves))
        tree: Dict = {"stacked": {k: next(grads)
                                  for k in self.params["stacked"]},
                      "tower": {}}
        for key, layers in self.params["tower"].items():
            tree["tower"][key] = [{"w": next(grads), "b": next(grads)}
                                  for _ in layers]
        return float(loss.detach()), tree

    def step(self, batch: Dict, labels) -> float:
        """One optimizer step on a raw batch; returns its loss (before the
        update)."""
        prepared = self.engine.prepare(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(prepared, labels)
        loss.backward()
        self.optimizer.step()
        return float(loss.detach())

    def save(self, path: str) -> None:
        """Checkpoint the full training state for exact resume: the engine
        checkpoint (spec + portable params, runtime/checkpoint.py, which
        the JAX package's load_checkpoint reads) plus the optimizer state
        in ``opt_state.npz``, in this package's own leaf order."""
        from recom_tpu_torch.runtime.checkpoint import save_checkpoint

        save_checkpoint(path, self.engine)
        np.savez(
            os.path.join(path, "opt_state.npz"),
            **{f"leaf{i}": x
               for i, x in enumerate(self.optimizer.state_leaves())},
        )

    @classmethod
    def restore(
        cls,
        path: str,
        config: Optional[EngineConfig] = None,
        optimizer: Optional[OptimizerFactory] = None,
        device=None,
    ) -> "Trainer":
        """Rebuild a Trainer from ``save``: the engine from the stored spec
        and params, the optimizer state into a fresh optimizer's."""
        from recom_tpu_torch.runtime.checkpoint import load_checkpoint

        model, params = load_checkpoint(path)
        tr = cls(model, config, optimizer=optimizer, params=params,
                 device=device)
        with np.load(os.path.join(path, "opt_state.npz")) as data:
            leaves = [data[f"leaf{i}"] for i in range(len(data.files))]
        tr.optimizer.load_state_leaves(leaves)
        return tr
