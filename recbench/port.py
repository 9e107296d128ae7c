"""The benchmark's one door into the program under test, ``recom_tpu_torch``:
build its Engine, Trainer and ServingPipeline from a configuration, wrap
its calls in spans for a traced run, and read back the state it produced,
to be judged.  Nothing else of the benchmark imports the program, and the
reference imports nothing of it.
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, List, Tuple

import torch

from recbench import towers


def program():
    """The program's package (fails where the checkout holds none)."""
    return importlib.import_module("recom_tpu_torch")


def load_kernels() -> None:
    """Build or load every hand kernel and the native host ops from the
    program's in-checkout cache: a warm checkout builds nothing."""
    from recom_tpu_torch.native import build as native_build
    from recom_tpu_torch.ops import kernels

    kernels.build_all()
    for name in kernels.LIBRARIES:
        kernels.library(name)
    native_build.get_lib()
    native_build.get_pylib()


def model(cfg: Dict):
    models = importlib.import_module("recom_tpu_torch.models")
    return getattr(models, cfg["builder"])(**cfg.get("builder_args", {}))


def engine_config(cfg: Dict):
    return program().EngineConfig(**cfg.get("engine_config", {}))


def make_engine(cfg: Dict, params: Dict, device):
    return program().Engine(model(cfg), engine_config(cfg), params=params,
                            device=device)


def optimizer(cfg: Dict):
    """The program's optimizer for the configuration's rules: one param
    group of the stacked tables and one of the tower, each group the
    configuration's entry for it (``rule`` and its hyperparameters)."""
    from recom_tpu_torch.train import OptaxOptimizer
    from recom_tpu_torch.utils.tree import tree_leaves

    def group(params, entry: Dict) -> Dict:
        out = {"params": tree_leaves(params), **entry}
        if entry["rule"] == "adam":
            out.setdefault("eps_root", 0.0)
        return out

    opt = cfg["optimizer"]

    def make(params: Dict):
        return OptaxOptimizer([group(params["stacked"], opt["tables"]),
                               group(params["tower"], opt["tower"])])

    return make


def make_trainer(cfg: Dict, params: Dict, device):
    return program().Trainer(model(cfg), engine_config(cfg),
                             optimizer=optimizer(cfg), params=params,
                             device=device)


def make_pipeline(engine, mix: Dict):
    return program().ServingPipeline(engine, prep_workers=mix["prep_workers"],
                                     max_inflight=mix["max_inflight"])


def table_views(engine) -> Dict[str, torch.Tensor]:
    """{table: its rows in the program's stacked leaf}, views."""
    out = {}
    for g in engine.compiled.groups:
        leaf = engine.device_params["stacked"][str(g.gid)]
        for i, m in enumerate(g.members):
            out[m.table] = (leaf[i, :m.vocab_size] if leaf.dim() == 3 else
                            leaf[m.row_offset:m.row_offset + m.vocab_size])
    return out


def tower_views(engine) -> Dict[str, torch.Tensor]:
    """{"tower/<part>/<layer>/<key>": leaf}, by the names the tower's
    module gives its leaves (``towers.flatten``).  The first top layer's
    rows may be in the program's own order: compare only what a row order
    leaves alone, such as a norm."""
    return towers.flatten(engine.device_params["tower"])


def first_grad_norms(trainer, cfg: Dict) -> Dict[str, float]:
    """Each leaf's first gradient norm, worked out from the optimizer's
    state after one step by the rule that the configuration states for the
    leaf (``reference/rules/<rule>.py``, ``first_grad_sq``)."""
    from recbench.reference import rules

    eng = trainer.engine
    state = trainer.optimizer.state
    opt = cfg["optimizer"]
    tab_rule, tw_rule = rules.load(opt["tables"]["rule"]), rules.load(
        opt["tower"]["rule"])
    sq: Dict[str, torch.Tensor] = {}
    for g in eng.compiled.groups:
        leaf = eng.device_params["stacked"][str(g.gid)]
        st = state[leaf]
        for i, m in enumerate(g.members):
            if leaf.dim() == 3:
                part = {k: v[i, :m.vocab_size] for k, v in st.items()}
            else:
                part = {k: v[m.row_offset:m.row_offset + m.vocab_size]
                        for k, v in st.items()}
            sq[m.table] = tab_rule.first_grad_sq(
                part, opt["tables"], (m.vocab_size, g.dim))
    for name, t in tower_views(eng).items():
        sq[name] = tw_rule.first_grad_sq(state[t], opt["tower"],
                                         tuple(t.shape))
    return _floats({k: v.sqrt() for k, v in sq.items()})


def change_norms(engine, before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{leaf: norm of (leaf now - ``before[leaf]``)} over the leaves that
    ``before`` names."""
    now = {**table_views(engine), **tower_views(engine)}
    return _floats({k: (now[k] - v).double().norm() for k, v in before.items()})


def _floats(norms: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(norms)
    vals = torch.stack([norms[k] for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


class Spans:
    """Host-clock spans (``time.perf_counter``) of the program's calls, on
    whatever thread makes them, for the per-layer metrics and for what the
    host did in the device's idle gaps: ``Engine.prepare``,
    ``Engine.dispatch``, ``InFlight.result`` and ``Trainer.step``.
    ``submitted(batch, t)`` notes when a request entered the pipeline; a
    request's queue wait ends where its prepare starts.  Installed only in a
    traced run."""

    def __init__(self):
        self.records: Dict[str, List[Tuple[float, float]]] = {
            "prepare": [], "dispatch": [], "result": [], "queue_wait": [],
            "step": []}
        self._submit: Dict[int, float] = {}
        self._undo: List = []

    def submitted(self, batch: Dict, t: float) -> None:
        self._submit[id(batch)] = t

    def _wrap(self, name: str, fn, queue: bool = False):
        rec = self.records[name]
        waits = self.records["queue_wait"]
        submit = self._submit

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            if queue:
                t_sub = submit.pop(id(args[0]), None)
                if t_sub is not None:
                    waits.append((t_sub, t0))
            try:
                return fn(*args, **kwargs)
            finally:
                rec.append((t0, time.perf_counter()))
        return wrapped

    def install(self, engine, trainer=None) -> None:
        """Wrap ``engine``'s calls (and ``trainer.step``, as "step")."""
        from recom_tpu_torch.runtime.executor import InFlight

        engine.prepare = self._wrap("prepare", engine.prepare, queue=True)
        engine.dispatch = self._wrap("dispatch", engine.dispatch)
        result = InFlight.result
        wrapped = self._wrap("result", result)
        InFlight.result = lambda rec, *a, **k: wrapped(rec, *a, **k)
        self._undo = [lambda: delattr(engine, "prepare"),
                      lambda: delattr(engine, "dispatch"),
                      lambda: setattr(InFlight, "result", result)]
        if trainer is not None:
            trainer.step = self._wrap("step", trainer.step)
            self._undo.append(lambda: delattr(trainer, "step"))

    def uninstall(self) -> None:
        for undo in self._undo:
            undo()
        self._undo = []


def free_device_memory() -> None:
    """Give back the device memory of objects already dropped."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reset_memory_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    """The most device memory the process has held since the last reset
    (0 on the CPU)."""
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))
