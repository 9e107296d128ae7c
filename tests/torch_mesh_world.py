"""A world of torch.distributed ranks for the port's mesh tests.

``World(n, tmpdir, device)`` spawns ``n`` rank processes (the ``spawn``
start method) that join one gloo process group through a ``FileStore``
under ``tmpdir``, so parallel test workers never race for a port.  Each
rank then serves the cases the test process sends it: ``World.run(case,
**kwargs)`` calls ``CASES[case](ctx, **kwargs)`` on every rank and returns
the ranks' results in rank order, or raises with a rank's traceback.

The ranks import torch and recom_tpu_torch only.  Models cross as the
serde JSON both packages write; params and batches as numpy.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import traceback

import numpy as np

CASE_TIMEOUT_S = 240


def _rank_main(rank, n, store_path, device, inq, outq):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, n)
    dist.init_process_group("gloo", store=store, world_size=n, rank=rank)
    ctx = Ctx(rank, device)
    while True:
        msg = inq.get()
        if msg is None:
            break
        case, kwargs = msg
        try:
            outq.put((rank, True, CASES[case](ctx, **kwargs)))
        except BaseException:
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    def __init__(self, n: int, tmpdir: str, device: str = "cpu"):
        ctx = mp.get_context("spawn")
        self.n = n
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(n)]
        store = os.path.join(str(tmpdir), "store")
        self.procs = [
            ctx.Process(target=_rank_main,
                        args=(r, n, store, device, self.inqs[r], self.outq),
                        daemon=True)
            for r in range(n)
        ]
        # tests/test_tf_import_real.py and test_tf_ground_truth.py hide
        # every card from the process they are collected in
        # (CUDA_VISIBLE_DEVICES=-1, for TF), and a spawned rank inherits
        # the environment: a card world's ranks start with the card
        # visible, and the variable is put back as it was
        hidden = device != "cpu" and \
            os.environ.get("CUDA_VISIBLE_DEVICES") == "-1"
        if hidden:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        try:
            for p in self.procs:
                p.start()
        finally:
            if hidden:
                os.environ["CUDA_VISIBLE_DEVICES"] = "-1"

    def run(self, case: str, **kwargs):
        for q in self.inqs:
            q.put((case, kwargs))
        got = {}
        while len(got) < self.n:
            try:
                rank, ok, res = self.outq.get(timeout=CASE_TIMEOUT_S)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if not p.is_alive()]
                raise RuntimeError(f"case {case}: ranks answered "
                                   f"{sorted(got)}, dead {dead}")
            if not ok:
                raise RuntimeError(f"case {case} failed on rank {rank}:\n"
                                   f"{res}")
            got[rank] = res
        return [got[r] for r in range(self.n)]

    def close(self):
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


class Ctx:
    """A rank's state: its meshes (one per shape, made once: making one is
    collective) and device."""

    def __init__(self, rank, device):
        self.rank = rank
        self.device = device
        self.meshes = {}

    def mesh(self, shape):
        """The mesh of ``shape`` over the first ranks of the world; None on
        a rank outside it (a (1, 2) mesh in a world of 4)."""
        from recom_tpu_torch.parallel import make_mesh

        shape = tuple(shape)
        if shape not in self.meshes:
            try:
                self.meshes[shape] = make_mesh(shape, backend="gloo",
                                               device=self.device)
            except ValueError as e:
                if "outside" not in str(e):
                    raise
                self.meshes[shape] = None
        return self.meshes[shape]


def _np(x):
    return x.detach().cpu().numpy()


def op_lookup(ctx, shape, kind, table, ids, offs, code, weights=None,
              chunks=1, capacity_factor=2.0, dedup=True):
    """The op-level psum or all-to-all lookup of a [B, C, L] batch (the JAX
    layout) on the rank's data slice: (pooled [b_loc, C, d], overflow)."""
    import torch

    from recom_tpu_torch.parallel import (
        all_to_all_group_pooled,
        sharded_group_pooled,
    )
    from recom_tpu_torch.parallel.multihost import from_global

    mesh = ctx.mesh(shape)
    n_data = mesh.shape["data"]
    r = mesh.axis_index("data")
    b_loc = ids.shape[0] // n_data
    cut = lambda x: torch.from_numpy(np.ascontiguousarray(
        np.transpose(x[r * b_loc:(r + 1) * b_loc], (1, 0, 2)))).to(
            mesh.device)
    stripe = from_global(mesh, "striped", table)
    w = None if weights is None else cut(weights)
    if kind == "psum":
        out = sharded_group_pooled(mesh, stripe, cut(ids), offs, code, w)
        return _np(out), 0
    out, ov = all_to_all_group_pooled(mesh, stripe, cut(ids), offs, code, w,
                                      capacity_factor=capacity_factor,
                                      dedup=dedup, chunks=chunks)
    return _np(out), int(ov)


def _engine(ctx, shape, model_json, cfg, params):
    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.ir.serde import model_from_json

    mesh = ctx.mesh(shape)
    return Engine(model_from_json(model_json), EngineConfig(**cfg),
                  params=params, mesh=mesh)


def serve(ctx, shape, model_json, cfg, params, batches, pooled=True,
          concat=False, export=False):
    """``predict`` of each batch on a mesh Engine: per batch the result (or
    ``{"raised": message}``), then the engine's counters and layouts, and
    with ``export`` its ``export_params`` (the stored values as f32)."""
    from recom_tpu_torch.runtime.checkpoint import export_params

    eng = _engine(ctx, shape, model_json, cfg, params)
    outs = []
    for b in batches:
        try:
            outs.append(eng.predict(b, return_pooled=pooled,
                                    return_concat=concat))
        except RuntimeError as e:
            outs.append({"raised": str(e)})
    rep = eng.stats_report()
    return {"outs": outs, "stats": dict(eng.stats),
            "layouts": {g["gid"]: (g["layout"], g["backend"])
                        for g in rep["groups"]},
            "sharded": sorted(eng._sharded_gids),
            "dim_sharded": sorted(eng._dim_sharded_gids),
            "collectives": sorted(eng.mesh.timers.samples),
            **({"params": export_params(eng)} if export else {})}


def pipeline(ctx, shape, model_json, cfg, params, batches, prep_workers=3,
             max_inflight=3, retries=1):
    """Sequential ``predict`` of each batch, then the same batches through
    a ``ServingPipeline``: each future's output or ``{"raised": msg}``."""
    from recom_tpu_torch.runtime.server import ServingPipeline

    eng = _engine(ctx, shape, model_json, cfg, params)
    want = []
    for b in batches:
        try:
            want.append(eng.predict(b)["output"])
        except RuntimeError as e:
            want.append({"raised": str(e)})
    pre = dict(eng.stats)
    got = []
    with ServingPipeline(eng, prep_workers=prep_workers,
                         max_inflight=max_inflight, retries=retries) as pipe:
        futs = [pipe.submit(b) for b in batches]
        for f in futs:
            try:
                got.append(f.result(timeout=120))
            except RuntimeError as e:
                got.append({"raised": str(e)})
        pstats = dict(pipe.stats)
    return {"want": want, "got": got, "pipe_stats": pstats,
            "stats_before": pre, "stats": dict(eng.stats)}


def lifecycle(ctx, shape, model_json, cfg, params, batch, updates,
              tables=None):
    """export_params, then ``update_table_rows`` of each (table, ids,
    values), then ``predict`` (pooled) and export_params again; and the
    Engine after ``reload_params`` of the first export."""
    from recom_tpu_torch.runtime.checkpoint import export_params

    eng = _engine(ctx, shape, model_json, cfg, params)
    before = export_params(eng, tables)
    hits = [eng.update_table_rows(t, ids, vals) for t, ids, vals in updates]
    out = eng.predict(batch, return_pooled=True)
    after = export_params(eng, tables)
    eng.reload_params(params)
    reloaded = eng.predict(batch, return_pooled=True)
    return {"before": before, "after": after, "out": out, "hits": hits,
            "reloaded": reloaded,
            "leaf_shapes": {k: tuple(getattr(v, "q", v).shape)
                            for k, v in eng.device_params["stacked"].items()}}


def collectives(ctx, shape):
    """The Mesh's three collectives on this rank's tensors."""
    import torch

    mesh = ctx.mesh(shape)
    r = ctx.rank
    x = torch.arange(6, dtype=torch.float32, device=mesh.device) + 10 * r
    out = {"coords": mesh.coords}
    for axis in ("data", "model", None):
        out[f"reduce/{axis}"] = _np(mesh.all_reduce(x.clone(), axis))
        out[f"gather/{axis}"] = _np(mesh.all_gather(x[:3], axis))
    n = mesh.shape["model"]
    out["a2a"] = _np(mesh.all_to_all(
        torch.arange(n * 2, dtype=torch.int32).reshape(n, 2) + 100 * r,
        "model"))
    return out


class Recording:
    """An array-like over ``array`` that records the indices it is read
    at."""

    def __init__(self, array):
        self.array = array
        self.shape = array.shape
        self.dtype = array.dtype
        self.reads = []

    def __getitem__(self, idx):
        self.reads.append(repr(idx))
        return self.array[idx]


def multihost(ctx, table_path, shape, local_world):
    """``init`` a second time (a no-op), ``global_mesh`` (with
    ``LOCAL_WORLD_SIZE`` set to ``local_world`` for its host-split form),
    ``from_global`` of an mmap'd table in each layout (the indices it
    read), and ``gather_to_host``."""
    import torch
    import torch.distributed as dist

    from recom_tpu_torch.parallel import multihost

    multihost.init("localhost:1", dist.get_world_size(), ctx.rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
    gm = multihost.global_mesh(device=ctx.device)
    gm_dp = multihost.global_mesh(data_parallel_hosts=True,
                                  device=ctx.device)
    mesh = ctx.mesh(shape)
    out = {"shape": gm.shape, "dp_shape": gm_dp.shape,
           "coords": (gm.coords, gm_dp.coords)}
    for layout in ("replicated", "striped", "columns"):
        table = Recording(np.load(table_path, mmap_mode="r"))
        part = multihost.from_global(mesh, layout, table)
        out[layout] = {"part": _np(part), "reads": table.reads,
                       "gathered": multihost.gather_to_host(part)}
    out["by_mesh"] = multihost.gather_to_host(
        torch.full((2,), float(ctx.rank)), mesh, "model")
    return out


def op_grad(ctx, shape, kind, table, ids, offs, code, g_out, weights=None,
            chunks=1):
    """The gradient of ``(pooled * g_out).sum()`` in the table through the
    op-level psum or all-to-all lookup of a [B, C, L] batch (the JAX
    layout): each rank's pooled rows of its data slice, backward through
    the collectives' transposes, then summed over "data".  Returns the
    rank's stripe gradient and coordinates."""
    import torch

    from recom_tpu_torch.parallel import (
        all_to_all_group_pooled,
        sharded_group_pooled,
    )
    from recom_tpu_torch.parallel.multihost import from_global

    mesh = ctx.mesh(shape)
    n_data = mesh.shape["data"]
    r = mesh.axis_index("data")
    b_loc = ids.shape[0] // n_data
    rows = slice(r * b_loc, (r + 1) * b_loc)
    cut = lambda x: torch.from_numpy(np.ascontiguousarray(
        np.transpose(x[rows], (1, 0, 2)))).to(mesh.device)
    stripe = from_global(mesh, "striped", table).requires_grad_(True)
    w = None if weights is None else cut(weights)
    if kind == "psum":
        out = sharded_group_pooled(mesh, stripe, cut(ids), offs, code, w)
    else:
        out, _ = all_to_all_group_pooled(mesh, stripe, cut(ids), offs, code,
                                         w, chunks=chunks)
    (out * torch.from_numpy(g_out[rows])).sum().backward()
    grad = stripe.grad
    mesh.grad_all_reduce([grad], "data")
    return _np(grad), mesh.coords


def _optimizer(opt):
    from recom_tpu_torch import train

    name, kw = opt
    return getattr(train, name)(**kw)


def train(ctx, shape, model_json, cfg, params, stream, opt=("adam", {}),
          grads=False, save_after=None, save_path=None, restore_path=None):
    """A mesh Trainer (or ``Trainer.restore`` of ``restore_path``) stepped
    on each (batch, labels) of ``stream``: the losses, the exported params
    after the steps, and with ``grads`` the first batch's
    ``value_and_grad`` first (loss, the rank's leaves' gradients by
    group id and tower key, each group's layout).  ``save_after``: steps
    after which ``Trainer.save`` writes ``save_path``.  None on a rank
    outside the mesh."""
    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.ir.serde import model_from_json
    from recom_tpu_torch.runtime.checkpoint import export_params
    from recom_tpu_torch.train import Trainer, tree_map

    mesh = ctx.mesh(shape)
    if mesh is None:
        return None
    config = EngineConfig(**cfg)
    if restore_path is not None:
        tr = Trainer.restore(restore_path, config, _optimizer(opt),
                             mesh=mesh)
    else:
        tr = Trainer(model_from_json(model_json), config, _optimizer(opt),
                     params=params, mesh=mesh)
    out = {"coords": mesh.coords,
           "layouts": {g.gid: tr.engine.layout(g)
                       for g in tr.engine.compiled.groups}}
    if grads:
        loss, gr = tr.value_and_grad(*stream[0])
        out["grad_loss"] = loss
        out["grads"] = tree_map(_np, gr)
    losses = []
    for i, (b, l) in enumerate(stream):
        losses.append(tr.step(b, l))
        if save_after == i + 1:
            tr.save(save_path)
    out["losses"] = losses
    out["params"] = export_params(tr.engine)
    return out


def dryrun(ctx, n):
    """``entry.dryrun_multichip(n)`` on every rank."""
    from recom_tpu_torch import entry

    return entry.dryrun_multichip(n, device=ctx.device, backend="gloo")


def train_multi(ctx, **kw):
    """``tools.train_multi.run`` on every rank (rank 0 gets the document)."""
    from recom_tpu_torch.tools import train_multi as tm

    return tm.run(device=ctx.device, backend="gloo", **kw)


def scaling(ctx, **kw):
    """``tools.scaling.sweep`` on every rank (rank 0 gets the rows)."""
    from recom_tpu_torch.tools import scaling as sc

    return sc.sweep(device=ctx.device, backend="gloo", **kw)


def visible_devices(ctx):
    """The rank's CUDA_VISIBLE_DEVICES (None where it is not set)."""
    return os.environ.get("CUDA_VISIBLE_DEVICES")


CASES = {f.__name__: f for f in (visible_devices, op_lookup, serve,
                                 pipeline, lifecycle, collectives, multihost,
                                 op_grad, train, dryrun, train_multi,
                                 scaling)}
