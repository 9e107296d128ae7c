"""The plain reference: a configuration's forward pass, loss and training
steps in plain PyTorch, from the raw batches and the seed's weights.

It imports nothing of the program.  The ids come from ``ids.py``; a column
pools its rows left to right in f32 (a mean multiplies by the reciprocal of
its count, as TF's unweighted ``SparseSegmentMean`` does); the tower is its
architecture's module's forward (``towers/<arch>.py``), its layers ``x @ w
+ b`` with ReLU between them, then the sigmoid.  Training is the masked
mean of the sigmoid's binary cross-entropy, ``torch.autograd.grad``, and
the update rule the configuration states for the tables and for the tower
(``rules/<rule>.py``; a row-wise rule keeps its state an element on the
tables the program stacks for its one-hot path).  It works on the rows
the batches touch: a row no batch touches has a zero gradient, and no
rule moves a row whose gradient and state are zero.

``precision``: ``"float32"`` as the configuration states it (TF32 off), or
``"tf32"``, the control: every product with its inputs in TF32, by the
card's TF32 switch, or on the CPU by rounding them to TF32's 10 mantissa
bits.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from recbench import spec, towers, weights
from recbench.reference import ids as ref_ids
from recbench.reference import rules


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest even at TF32's 10 mantissa bits (the
    gradient passes through as if unrounded)."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (bits.view(torch.float32) - x.detach())


class Reference:
    def __init__(self, cfg: Dict, seed: int, device, precision="float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        self.precision = precision
        self.classes = spec.classes(cfg)
        self._tables: Dict[int, torch.Tensor] = {}

    # -- weights ---------------------------------------------------------
    def table(self, ci: int) -> torch.Tensor:
        if ci not in self._tables:
            self._tables[ci] = weights.class_table(self.cfg, ci, self.seed,
                                                   self.device)
        return self._tables[ci]

    def release(self) -> None:
        self._tables.clear()

    @contextlib.contextmanager
    def _matmuls(self):
        cuda = torch.backends.cuda.matmul
        old = (cuda.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.precision == "tf32" and self.device.type == "cuda"
        cuda.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            cuda.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def _mm_in(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32" and self.device.type != "cuda":
            return _tf32(x)
        return x

    # -- forward ---------------------------------------------------------
    @staticmethod
    def _pool(cls, table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """``[B, C, d]`` pooled rows of ``table`` at ``rows`` (``[B, C]`` or
        ``[B, C, L]``, -1 none), left to right in f32."""
        if rows.dim() == 2:
            rows = rows[:, :, None]
        valid = rows >= 0
        acc = None
        for pos in range(rows.shape[2]):
            r = rows[:, :, pos]
            v = table[r.clamp(min=0)] * valid[:, :, pos, None]
            acc = v if acc is None else acc + v
        if cls.combiner == "mean":
            n = valid.sum(dim=2, keepdim=True).to(torch.float32)
            acc = acc * torch.where(n > 0, 1.0 / n.clamp(min=1), 0.0)
        elif cls.combiner != "sum":
            raise ValueError(f"unknown combiner {cls.combiner!r}")
        return acc

    def _dense(self, batch: Dict) -> torch.Tensor:
        cols = [np.asarray(batch[f], np.float32)
                for f in spec.dense_fields(self.cfg)]
        return torch.from_numpy(np.stack(cols, axis=1)).to(self.device)

    def _tower(self, tower: Dict, dense: torch.Tensor,
               emb: List[torch.Tensor], logits: bool) -> torch.Tensor:
        """The tower's module's forward (``towers/<arch>.py``): logits, or
        through the configuration's final activation."""
        final = None if logits else self.cfg["tower"]["final_activation"]
        return spec.tower(self.cfg).forward(self._mm_in, self.cfg, tower,
                                            dense, emb, final)

    def class_rows(self, batch: Dict) -> List[np.ndarray]:
        """Each class's ids as rows of its stacked table."""
        return [ref_ids.flat_ids(c, ref_ids.class_ids(c, batch))
                for c in self.classes]

    @torch.no_grad()
    def scores(self, batch: Dict) -> np.ndarray:
        """The model's output for every row of ``batch`` (the sigmoid)."""
        tw = weights.tower(self.cfg, self.seed, self.device)
        with self._matmuls():
            emb = [self._pool(c, self.table(ci),
                              torch.from_numpy(r).to(self.device))
                   for ci, (c, r) in enumerate(zip(self.classes,
                                                   self.class_rows(batch)))]
            out = self._tower(tw, self._dense(batch), emb, logits=False)
        return out.cpu().numpy()

    # -- training --------------------------------------------------------
    def train(self, batches: List[Dict], labels: List[np.ndarray],
              half_batch: bool = False) -> Dict:
        """Steps on ``batches`` in turn from the seed's weights: each step's
        loss, each leaf's first gradient norm, and each leaf's change after
        the last step.  ``half_batch`` plants a fault: the loss is the mean
        over the first half of each batch alone."""
        opt = self.cfg["optimizer"]
        tab_opt, tw_opt = opt["tables"], opt["tower"]
        tab_rule, tw_rule = rules.load(tab_opt["rule"]), rules.load(
            tw_opt["rule"])
        rows = [self.class_rows(b) for b in batches]
        compact, p0, per_el, table_of = [], [], [], []
        for ci, cls in enumerate(self.classes):
            uniq = np.unique(np.concatenate(
                [r[ci][r[ci] >= 0] for r in rows]))
            tidx = np.searchsorted(cls.offsets, uniq, side="right") - 1
            p0.append(self.table(ci)[torch.from_numpy(uniq).to(self.device)]
                      .clone())
            per_el.append(torch.from_numpy(cls.per_element[tidx]).to(
                self.device))
            table_of.append(torch.from_numpy(tidx).to(self.device))
            compact.append([torch.from_numpy(np.where(
                r[ci] >= 0, np.searchsorted(uniq, r[ci]), -1)).to(self.device)
                for r in rows])
        self.release()
        tables = [p.clone().requires_grad_(True) for p in p0]
        tw0 = towers.flatten(weights.tower(self.cfg, self.seed, self.device))
        names, tw_leaves0 = list(tw0), list(tw0.values())
        tw_leaves = [t.clone().requires_grad_(True) for t in tw_leaves0]
        tw_el = [t.dim() != 2 for t in tw_leaves]
        tab_st = [tab_rule.init(p, e) for p, e in zip(tables, per_el)]
        tw_st = [tw_rule.init(t, e) for t, e in zip(tw_leaves, tw_el)]
        losses, first = [], None
        for step, (batch, lab) in enumerate(zip(batches, labels), start=1):
            tw = towers.unflatten(dict(zip(names, tw_leaves)))
            with self._matmuls():
                emb = [self._pool(c, tables[ci], compact[ci][step - 1])
                       for ci, c in enumerate(self.classes)]
                z = self._tower(tw, self._dense(batch), emb, logits=True)
            y = torch.from_numpy(np.asarray(lab, np.float32)).to(self.device)
            per = -y * F.logsigmoid(z) - (1.0 - y) * F.logsigmoid(-z)
            mask = torch.ones_like(per)
            if half_batch:
                mask[per.shape[0] // 2:] = 0.0
            loss = (per * mask).sum() / mask.sum()
            grads = torch.autograd.grad(loss, tables + tw_leaves)
            losses.append(float(loss.detach()))
            g_tab, g_tw = grads[:len(tables)], grads[len(tables):]
            if step == 1:
                first = self._leaf_norms(g_tab, table_of, g_tw, names)
            with torch.no_grad():
                for p, g, st, e in zip(tables, g_tab, tab_st, per_el):
                    tab_rule.update(p, g, st, tab_opt, step, e)
                for p, g, st, e in zip(tw_leaves, g_tw, tw_st, tw_el):
                    tw_rule.update(p, g, st, tw_opt, step, e)
        with torch.no_grad():
            change = self._leaf_norms(
                [p - q for p, q in zip(tables, p0)], table_of,
                [p - q for p, q in zip(tw_leaves, tw_leaves0)], names)
        return {"losses": losses, "grad_norms": first,
                "update_norms": change}

    def _leaf_norms(self, tab, table_of, tw, names) -> Dict[str, float]:
        """{leaf: norm}: each table's rows of the class tensors ``tab``
        (``table_of`` gives each row's table), and the tower's leaves."""
        out: Dict[str, float] = {}
        for cls, t, idx in zip(self.classes, tab, table_of):
            sq = torch.zeros(cls.count, dtype=torch.float64,
                             device=self.device)
            sq.index_add_(0, idx, (t.double() ** 2).sum(dim=1))
            for name, v in zip(cls.tables, sq.sqrt().cpu().numpy()):
                out[name] = float(v)
        for n, t in zip(names, tw):
            out[n] = float(t.double().norm())
        return out
