"""The port's training on a mesh of ranks (recom_tpu_torch.train.Trainer
with ``EngineConfig(mesh_shape=...)``, the collectives' transposes in
recom_tpu_torch.parallel), mirroring the training tests of
tests/test_sharding.py, and the mesh tools (train_multi, scaling,
multihost_demo, benchmark --mesh).

Each case runs in a gloo world of 4 CPU processes, spawned once for the
module (tests/torch_mesh_world.py), on mesh shapes (2, 2), (1, 4), (4, 1)
and (1, 2) (ranks 2 and 3 then sit out).  The JAX side runs on the
virtual CPU devices of tests/conftest.py.  Gates: gradients within atol
1e-5 of JAX's and of the port's single-device gradient
(test_sharding.py:168's tolerance); a replicated leaf's gradient on (1, m)
``==`` the single device's (the model axis is never summed: summing it
makes it m times too large); the mesh Trainer's 5 losses within rtol
1e-5 of the JAX mesh Trainer's and its exported params within atol 1e-5;
a checkpoint saved on a (2, 2) mesh by either package resumes in the
other, the next 3 losses within rtol 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.ir.serde import model_to_json
from recom_tpu.models import make_random_batch
from recom_tpu.models.synthetic import make_dlrm_model
from recom_tpu.ops import lookup_xla
from recom_tpu.parallel import (
    all_to_all_group_pooled as j_a2a,
    make_mesh as j_make_mesh,
    sharded_group_pooled as j_psum,
)
from recom_tpu.parallel.sharded_lookup import (
    pad_rows_to_multiple,
    stripe_rows,
    unstripe_rows,
)
from recom_tpu.runtime.checkpoint import export_params as j_export
from recom_tpu.train import Trainer as JTrainer
from recom_tpu.train import dlrm_optimizer as j_dlrm
from recom_tpu.train import forward_logits as j_forward_logits
from recom_tpu.train import rowwise_adagrad as j_rowwise
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import EngineConfig, Trainer
from recom_tpu_torch.ir.serde import model_from_json
from recom_tpu_torch.ops.lookup_gather import group_pooled
from recom_tpu_torch.train import dlrm_optimizer

from torch_mesh_world import World

needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("mesh_train_world"))
    yield w
    w.close()


def _labels(n, seed):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.float32)


def _stream(model, n, bs, seed):
    return [(make_random_batch(model, bs, seed=seed + i),
             _labels(bs, seed + 100 + i)) for i in range(n)]


# --- op level: the lookups' gradients (test_sharding.py:138) --------------


def _op_grad_case(seed, C, V, d, B, L, pool_size):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((C * V, d)).astype(np.float32)
    ids = rng.integers(0, pool_size, size=(B, C, L)).astype(np.int32)
    ids[rng.random((B, C, L)) < 0.3] = -1
    offs = (np.arange(C) * V).astype(np.int32)
    g_out = rng.standard_normal((B, C, d)).astype(np.float32)
    return table, ids, offs, g_out


def _port_op_grad(world, shape, kind, table, ids, offs, code, g_out,
                  **kw):
    """The logical [R, d] gradient from the ranks' stripes: the model
    ranks of data row 0 (every data row holds the same after the data
    reduction, checked)."""
    res = world.run("op_grad", shape=shape, kind=kind, table=table, ids=ids,
                    offs=offs, code=code, g_out=g_out, **kw)
    d_ax, m = shape
    for r in range(m, d_ax * m):
        np.testing.assert_array_equal(res[r][0], res[r % m][0])
    stripes = np.concatenate([res[k][0] for k in range(m)])
    return unstripe_rows(stripes, m)[:table.shape[0]]


def _one_device_grads(table, ids, offs, code, g_out):
    """(the JAX package's dense gradient, the port's single-device
    ``group_pooled`` gradient) of the same loss."""
    def loss_dense(t):
        return (lookup_xla.group_pooled(t, jnp.asarray(ids), offs, code)
                * g_out).sum()

    jd = np.asarray(jax.jit(jax.grad(loss_dense))(jnp.asarray(table)))
    tt = torch.from_numpy(table).requires_grad_(True)
    (group_pooled(tt, torch.from_numpy(np.ascontiguousarray(
        ids.transpose(1, 0, 2))), offs, code)
     * torch.from_numpy(g_out)).sum().backward()
    return jd, tt.grad.numpy()


@needs_8
@pytest.mark.parametrize("chunks", [1, 2])
def test_exchange_grad_accumulates_duplicates(world, chunks):
    """Heavy duplicates (8 distinct ids a column) through the dedup'd
    exchange on (2, 2): each id's cotangents gather into its table row, as
    JAX's gradient of the same exchange and both packages' dense lookup
    give it."""
    table, ids, offs, g_out = _op_grad_case(11, 2, 32, 4, 16, 4, 8)
    code = np.zeros((2,), np.int32)
    shape = (2, 2)
    got = _port_op_grad(world, shape, "a2a", table, ids, offs, code, g_out,
                        chunks=chunks)
    jmesh = j_make_mesh(shape)
    tp = stripe_rows(pad_rows_to_multiple(table, 2), 2)

    def loss_sharded(t):
        out, _ = j_a2a(jmesh, t, ids, offs, code, chunks=chunks)
        return (out * g_out).sum()

    gs = np.asarray(jax.jit(jax.grad(loss_sharded))(jnp.asarray(tp)))
    jgot = unstripe_rows(gs, 2)[:table.shape[0]]
    jd, td = _one_device_grads(table, ids, offs, code, g_out)
    np.testing.assert_allclose(got, jgot, atol=1e-5)
    np.testing.assert_allclose(got, td, atol=1e-5)
    np.testing.assert_allclose(got, jd, atol=1e-5)


@needs_8
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_psum_path_grad_matches_jax_and_one_device(world, shape):
    """The psum path's gradient (X1b's plain version on each stripe, the
    psum's identity backward, MEAN and SQRTN divisors through torch)."""
    table, ids, offs, g_out = _op_grad_case(12, 3, 40, 8, 16, 4, 40)
    code = np.array([0, 1, 2], np.int32)
    got = _port_op_grad(world, shape, "psum", table, ids, offs, code, g_out)
    jmesh = j_make_mesh(shape)
    m = shape[1]
    tp = stripe_rows(pad_rows_to_multiple(table, m), m)

    def loss_sharded(t):
        return (j_psum(jmesh, t, ids, offs, code) * g_out).sum()

    gs = np.asarray(jax.jit(jax.grad(loss_sharded))(jnp.asarray(tp)))
    jgot = unstripe_rows(gs, m)[:table.shape[0]]
    jd, td = _one_device_grads(table, ids, offs, code, g_out)
    np.testing.assert_allclose(got, jgot, atol=1e-5)
    np.testing.assert_allclose(got, td, atol=1e-5)
    np.testing.assert_allclose(got, jd, atol=1e-5)


# --- the Trainer on a mesh --------------------------------------------------


def _model(name="mt"):
    """Every column type; the 2^15-row list group is striped, the two
    10 000-row string groups stay under ``shard_rows_above`` (and split by
    columns under ``dim_shard_above=4``)."""
    return make_dlrm_model(4, 2, 2, 2, 1, 4, [8], [16], name=name,
                           large_rows=1 << 15)


def _mesh_cfg(shape, **kw):
    return dict(mesh_shape=shape, use_pallas=False, shard_rows_above=25_000,
                shard_comm="all_to_all", batch_buckets=(32,), **kw)


def _train(world, shape, model, cfg, params, stream, opt, **kw):
    res = world.run("train", shape=shape, model_json=model_to_json(model),
                    cfg=cfg, params=params, stream=stream, opt=opt, **kw)
    n = shape[0] * shape[1]
    assert all(r is None for r in res[n:])
    for r in res[1:n]:
        np.testing.assert_array_equal(r["losses"], res[0]["losses"])
    return res[:n]


def _jax_value_and_grad(eng, batch, labels):
    """The JAX mesh Engine's loss and gradients, as its Trainer takes them
    (recom_tpu/train.py:98-231)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    prepared = eng.prepare(batch)
    bp, b = prepared.batch_padded, prepared.batch_size
    lab = np.zeros(bp, np.float32)
    lab[:b] = labels
    mask = np.zeros(bp, np.float32)
    mask[:b] = 1.0
    arrays = eng.shard_batch_arrays(prepared.arrays)
    sh = NamedSharding(eng.mesh, P("data"))
    lab, mask = jax.device_put(lab, sh), jax.device_put(mask, sh)

    def loss_fn(params):
        logits = j_forward_logits(eng, params, arrays, prepared.signature)
        per = optax.sigmoid_binary_cross_entropy(logits[:, 0], lab)
        return (per * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    return jax.jit(jax.value_and_grad(loss_fn))(eng.device_params)


def _rank_part(res, full, gid, layout, shape):
    """Each rank's part of a global (physical-layout) gradient or param
    ``full`` of group ``gid``: its stripe, its columns, or all of it."""
    m = shape[1]
    k = res["coords"][1]
    if layout == "striped":
        per = full.shape[0] // m
        return full[k * per:(k + 1) * per]
    if layout == "columns":
        w = full.shape[1] // m
        return full[:, k * w:(k + 1) * w]
    return full


@needs_8
def test_dim_sharded_group_grad_matches_jax(world):
    """On (1, 4) with ``dim_shard_above=4`` the 8-wide string groups are
    split by columns (X1b on each rank's columns, the all_gather's own-slice
    backward) and the 32-wide list group striped: each rank's gradient of
    each leaf is its part of the JAX mesh Engine's, within 1e-5, and of
    the port's single-device gradient."""
    model = _model("dimgrad")
    shape = (1, 4)
    cfg = _mesh_cfg(shape, dim_shard_above=4)
    params = init_model_params(model)
    stream = _stream(model, 1, 32, 5)
    res = _train(world, shape, model, cfg, params, stream, ("adam", {}),
                 grads=True)
    layouts = res[0]["layouts"]
    assert "columns" in layouts.values() and "striped" in layouts.values()
    jeng = JEngine(model, JConfig(**cfg), params=params)
    jloss, jgrads = _jax_value_and_grad(jeng, *stream[0])
    one = Trainer(model_from_json(model_to_json(model)),
                  EngineConfig(**dict(cfg, mesh_shape=None)), params=params,
                  device="cpu")
    loss1, grads1 = one.value_and_grad(*stream[0])
    for r in res:
        np.testing.assert_allclose(r["grad_loss"], float(jloss), rtol=1e-6)
        for gid, layout in r["layouts"].items():
            got = r["grads"]["stacked"][str(gid)]
            want = _rank_part(r, np.asarray(jgrads["stacked"][str(gid)]),
                              gid, layout, shape)
            np.testing.assert_allclose(got, want, atol=1e-5,
                                       err_msg=f"group {gid} ({layout})")
            if layout != "striped":
                np.testing.assert_allclose(
                    got, _rank_part(r, grads1["stacked"][str(gid)].numpy(),
                                    gid, layout, shape),
                    atol=1e-5, err_msg=f"group {gid} vs one device")
        for key, layers in r["grads"]["tower"].items():
            for i, layer in enumerate(layers):
                for wb in ("w", "b"):
                    np.testing.assert_allclose(
                        layer[wb], jgrads["tower"][key][i][wb], atol=1e-5,
                        err_msg=f"tower {key}[{i}].{wb}")


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_replicated_leaf_grads_equal_one_device_on_1xm(world, shape):
    """On (1, m) every rank's loss and each replicated leaf's gradient (the
    tower, the replicated tables) ``==`` the single-device Trainer's: the
    pooled rows are bit for bit the single device's under the exchange,
    and no gradient is summed over "model" (summed, it is m times the
    single device's)."""
    model = _model("repl")
    cfg = _mesh_cfg(shape)
    params = init_model_params(model)
    stream = _stream(model, 1, 32, 7)
    res = _train(world, shape, model, cfg, params, stream, ("adam", {}),
                 grads=True)
    one = Trainer(model_from_json(model_to_json(model)),
                  EngineConfig(**dict(cfg, mesh_shape=None)), params=params,
                  device="cpu")
    loss1, grads1 = one.value_and_grad(*stream[0])
    replicated = [gid for gid, lay in res[0]["layouts"].items()
                  if lay == "replicated"]
    assert replicated and "striped" in res[0]["layouts"].values()
    for r in res:
        assert r["grad_loss"] == loss1
        for gid in replicated:
            np.testing.assert_array_equal(
                r["grads"]["stacked"][str(gid)],
                grads1["stacked"][str(gid)].numpy(), err_msg=f"group {gid}")
        for key, layers in r["grads"]["tower"].items():
            for i, layer in enumerate(layers):
                for wb in ("w", "b"):
                    np.testing.assert_array_equal(
                        layer[wb], grads1["tower"][key][i][wb].numpy(),
                        err_msg=f"tower {key}[{i}].{wb}")


TRAINER_OPTS = {
    "dlrm": (("dlrm_optimizer", {}), j_dlrm),
    "rowwise_adagrad": (("rowwise_adagrad", {}), j_rowwise),
}


@needs_8
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_mesh_trainer_matches_jax_trainer(world, shape):
    """The mesh Trainer (dlrm_optimizer; the list table striped, the
    string tables split by columns where the model axis splits them) on 5
    batches against the JAX Trainer on the same mesh shape, params,
    batches and labels: losses within rtol 1e-5, exported params within
    atol 1e-5."""
    model = _model("mtr")
    cfg = _mesh_cfg(shape, dim_shard_above=4)
    params = init_model_params(model)
    stream = _stream(model, 5, 32, 20)
    res = _train(world, shape, model, cfg, params, stream,
                 ("dlrm_optimizer", {}))
    jtr = JTrainer(model, JConfig(**cfg), optimizer=j_dlrm(), params=params)
    jl = [jtr.step(b, lab) for b, lab in stream]
    np.testing.assert_allclose(res[0]["losses"], jl, rtol=1e-5)
    _params_close(res[0]["params"], j_export(jtr.engine), 1e-5)


def _params_close(got, want, atol):
    assert set(got["tables"]) == set(want["tables"])
    for name, t in want["tables"].items():
        np.testing.assert_allclose(got["tables"][name], t, atol=atol,
                                   err_msg=name)
    for key, layers in want["tower"].items():
        for i, layer in enumerate(layers):
            for wb in ("w", "b"):
                np.testing.assert_allclose(got["tower"][key][i][wb],
                                           layer[wb], atol=atol,
                                           err_msg=f"tower {key}[{i}].{wb}")


def test_trainer_loss_decreases(world):
    """A mirror of tests/test_sharding.py:257 on (2, 2): the 2048-row table
    striped, 5 steps of one batch, the loss falls."""
    m = make_dlrm_model(3, 1, 1, 1, 1, 2, [4], [8, 1], name="train",
                        large_rows=2048)
    cfg = dict(mesh_shape=(2, 2), shard_rows_above=1024, use_pallas=False,
               batch_buckets=(32,))
    b = make_random_batch(m, 32, seed=5)
    labels = np.random.default_rng(0).integers(0, 2, 32)
    res = _train(world, (2, 2), m, cfg, init_model_params(m),
                 [(b, labels)] * 5, ("adam", {}))
    assert "striped" in res[0]["layouts"].values()
    losses = res[0]["losses"]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


@needs_8
def test_rowwise_adagrad_on_a_column_split_leaf_matches_jax(world):
    """Row-wise AdaGrad on tables split by columns over (1, 4): each row's
    squares summed over "model" before the mean, as GSPMD reduces it; 3
    steps' losses within rtol 1e-5 and the params within atol 1e-5 of the
    JAX mesh Trainer's."""
    model = make_dlrm_model(0, 2, 2, 2, 0, 2, [4], [8], name="dimada",
                            dim=8)
    shape = (1, 4)
    cfg = dict(mesh_shape=shape, dim_shard_above=4, use_pallas=False,
               batch_buckets=(32,))
    params = init_model_params(model)
    stream = _stream(model, 3, 32, 40)
    res = _train(world, shape, model, cfg, params, stream,
                 ("rowwise_adagrad", {"learning_rate": 0.05}))
    assert set(res[0]["layouts"].values()) == {"columns"}
    jtr = JTrainer(model, JConfig(**cfg), optimizer=j_rowwise(0.05),
                   params=params)
    jl = [jtr.step(b, lab) for b, lab in stream]
    np.testing.assert_allclose(res[0]["losses"], jl, rtol=1e-5)
    _params_close(res[0]["params"], j_export(jtr.engine), 1e-5)


@needs_8
@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_mesh_checkpoint_resumes_across_packages(world, tmp_path, saved_by):
    """A Trainer.save on a (2, 2) mesh after 2 steps (dlrm_optimizer: the
    striped table's row accumulators in the striped physical layout, the
    split tables' whole) resumed by the other package's Trainer.restore on
    the same mesh shape: its next 3 losses within rtol 1e-4 of the saving
    run's own continuation."""
    model = _model("resume")
    shape = (2, 2)
    cfg = _mesh_cfg(shape, dim_shard_above=4)
    params = init_model_params(model)
    stream = _stream(model, 5, 32, 60)
    path = str(tmp_path / "ckpt")
    if saved_by == "jax":
        jtr = JTrainer(model, JConfig(**cfg), optimizer=j_dlrm(),
                       params=params)
        for b, lab in stream[:2]:
            jtr.step(b, lab)
        jtr.save(path)
        want = [jtr.step(b, lab) for b, lab in stream[2:]]
        res = _train(world, shape, model, cfg, None, stream[2:],
                     ("dlrm_optimizer", {}), restore_path=path)
        got = res[0]["losses"]
    else:
        res = _train(world, shape, model, cfg, params, stream,
                     ("dlrm_optimizer", {}), save_after=2, save_path=path)
        want = res[0]["losses"][2:]
        jtr = JTrainer.restore(path, JConfig(**cfg), optimizer=j_dlrm())
        got = [jtr.step(b, lab) for b, lab in stream[2:]]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_dryrun_multichip_on_a_world_of_4(world):
    """A mirror of tests/test_sharding.py:297: entry.dryrun_multichip(4) on
    every rank of the world, mesh (2, 2)."""
    res = world.run("dryrun", n=4)
    for r in res:
        assert r["mesh"] == (2, 2) and r["sharded_groups"]
        assert r["pooled_vs_oracle"] == "bit-exact" and r["steps"] == 9
        assert r["loss_last"] < r["loss_first"] - 1e-4
        assert r["arms"] == {"pallas": "bit-exact", "dev_hash": "bit-exact"}
        assert r["loss_last"] == res[0]["loss_last"]


# --- the tools ----------------------------------------------------------------


@pytest.mark.parametrize("comm", ["all_to_all", "psum"])
def test_scaling_wire_model_equals_jax(comm):
    from recom_tpu.tools.scaling import wire_model as j_wire
    from recom_tpu_torch.tools.scaling import wire_model

    for m, batch, cols, rowlen, dim in ((1, 64, 4, 1, 8), (2, 1024, 16, 1, 64),
                                        (4, 512, 26, 3, 32),
                                        (8, 2048, 5, 12, 32)):
        for factor in (2.0, 0.5):
            assert wire_model(m, batch, cols, rowlen, dim, comm, factor) == \
                j_wire(m, batch, cols, rowlen, dim, comm, factor)


def test_scaling_sweep_on_a_world_of_4(world):
    """``scaling.sweep`` over model axes 1, 2 and 4 of the world, both
    comms: rank 0 gets one row a size, the others None."""
    for comm in ("all_to_all", "psum"):
        res = world.run("scaling", rows_per_shard=256, dim=8, batch=32,
                        n_columns=4, iters=2, comm=comm, mesh_sizes=[1, 2, 4],
                        chunks=2)
        assert all(r is None for r in res[1:])
        rows = res[0]
        assert [r["model_axis"] for r in rows] == [1, 2, 4]
        assert all(r["latency_ms"] > 0 for r in rows)
        assert "efficiency_vs_m2" in rows[2]


def test_train_multi_four_steps(world):
    """``tools.train_multi.run`` for 4 steps on (2, 2): both arms' losses,
    their largest gap, the param end-state deltas and both AUCs in its
    document."""
    res = world.run("train_multi", steps=4, batch=32, lr=1e-3,
                    mesh=(2, 2), eval_n=256)
    doc = res[0]
    assert all(r is None for r in res[1:])
    assert doc["sharded_groups"]
    assert doc["loss_max_abs_delta"] < 1e-4
    assert 0.0 <= doc["auc_single"] <= 1.0 and 0.0 <= doc["auc_mesh"] <= 1.0
    assert max(doc["param_end_state_max_abs_delta"].values()) < 1e-4


def _tool(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m"] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_multihost_demo_spawn_2_prints_ok():
    out = _tool(["recom_tpu_torch.tools.multihost_demo", "--spawn", "2",
                 "--device", "cpu"])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "MULTIHOST OK" in out.stdout


def test_benchmark_mesh_1x2_serves_on_two_ranks():
    import json

    out = _tool(["recom_tpu_torch.tools.benchmark", "--model", "micro10",
                 "--mesh", "1x2", "--spawn", "2", "--device", "cpu",
                 "--batch-size", "16", "--num-iterations", "3"])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    text = out.stdout[out.stdout.index("{"):]
    res = json.loads(text[:text.rindex("}") + 1])
    assert res["mesh"] == [1, 2] and res["rank"] == 0
    assert res["latency_ms"]["p50"] > 0 and res["examples_per_s"] > 0


# --- the card: a world of 2 ranks sharing one card over gloo ----------------


@pytest.mark.cuda
@pytest.mark.parametrize("comm", ["all_to_all", "psum"])
def test_mesh_training_on_one_card_matches_single_device(tmp_path, comm):
    """The mesh Trainer on (1, 2), two ranks on one card over gloo (K1 and
    K3a on the one-hot groups, X1 and X1b on the gather groups, X1b in its
    mesh roles): the first batch's loss and replicated gradients ``==`` the
    single-device card Trainer's under the exchange (within 1e-6 and 1e-5
    under psum), the stripes' gradients within 1e-5 of its table
    gradient, 3 dlrm_optimizer losses within rtol 1e-5 and the exported
    params within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from recom_tpu_torch.ops import kernels

    kernels.build_all()
    model = _model("card")
    cfg = dict(shard_rows_above=25_000, batch_buckets=(64,),
               dim_shard_above=4, shard_comm=comm)
    params = init_model_params(model)
    stream = _stream(model, 3, 64, 80)
    one = Trainer(model_from_json(model_to_json(model)), EngineConfig(**cfg),
                  optimizer=dlrm_optimizer(), params=params, device="cuda")
    loss1, grads1 = one.value_and_grad(*stream[0])
    grads1 = {gid: g.cpu().numpy() for gid, g in grads1["stacked"].items()}
    losses1 = [one.step(b, lab) for b, lab in stream]
    from recom_tpu_torch.runtime.checkpoint import export_params

    final1 = export_params(one.engine)
    w = World(2, tmp_path, device="cuda:0")
    try:
        res = w.run("train", shape=(1, 2), model_json=model_to_json(model),
                    cfg=dict(cfg, mesh_shape=(1, 2)), params=params,
                    stream=stream, opt=("dlrm_optimizer", {}), grads=True)
    finally:
        w.close()
    exact = comm == "all_to_all"
    for r in res:
        if exact:
            assert r["grad_loss"] == loss1
        else:
            np.testing.assert_allclose(r["grad_loss"], loss1, rtol=1e-6)
        for gid, layout in r["layouts"].items():
            got = r["grads"]["stacked"][str(gid)]
            if layout == "replicated" and exact:
                np.testing.assert_array_equal(got, grads1[str(gid)])
            elif layout != "striped":
                want = _rank_part(r, grads1[str(gid)], gid, layout, (1, 2))
                np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(r["losses"], losses1, rtol=1e-5)
        _params_close(r["params"], final1, 1e-5)
    striped = [gid for gid, lay in res[0]["layouts"].items()
               if lay == "striped"]
    assert striped
    for gid in striped:
        phys = np.concatenate([r["grads"]["stacked"][str(gid)] for r in res])
        rows = grads1[str(gid)].shape[0]
        np.testing.assert_allclose(unstripe_rows(phys, 2)[:rows],
                                   grads1[str(gid)], atol=1e-5)
