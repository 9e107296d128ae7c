"""Entry points of the port (after the root ``__graft_entry__.py``).

entry(device=None)  -> (forward fn, (params, arrays)) on the flagship model
                       (model E's columns, large tables at 2^16 rows, batch
                       128): ``fn(params, arrays)`` is the port's
                       ``Engine._forward`` output on the card.
dryrun_multichip(n, device=None, backend=None)
                    -> the JAX dryrun's checks: a tiny model with every
                       column type, its pooled outputs ``==`` the oracle
                       before training, 9 ``Trainer`` steps on one batch
                       with the loss falling, and the K1
                       (``use_pallas=True``) and device-hash arms ``==`` the
                       oracle; on one device (n == 1) or, called on every
                       rank of a world of n ranks, on a mesh of them.
"""

from __future__ import annotations


def _flagship(scale_large_rows: int = 1 << 16):
    """Model E's column structure (880 bucketize + 50 int-hash + 50
    str-hash + 15 sparse + 5 large; reference examples/python/dlrm.py:193)
    with the large tables shrunk so the entry stays light."""
    from recom_tpu_torch.models.synthetic import make_dlrm_model

    return make_dlrm_model(
        880, 50, 50, 15, 5, 32, [32], [1024, 1024, 128],
        name="E_entry", large_rows=scale_large_rows,
    )


def forward_entry(model, batch, config=None, params=None, device=None):
    """(fn, (params, arrays), engine) for ``model`` and one raw ``batch``:
    the batch prepared by ``host_prep.prepare_batch`` (structured arrays,
    one per group) and put on the engine's device; ``fn(params, arrays)``
    runs the engine's forward on ``params`` (a ``device_params`` tree) and
    returns its output tensor."""
    import torch

    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.runtime.host_prep import prepare_batch

    eng = Engine(model, config or EngineConfig(), params=params,
                 device=device)
    prepared = prepare_batch(eng.compiled, batch)
    arrays = eng.to_device(prepared)
    signature = prepared.signature

    def fn(p, a):
        saved = eng.device_params
        eng.device_params = p
        try:
            with torch.inference_mode():
                return eng._forward(a, signature)["output"]
        finally:
            eng.device_params = saved

    return fn, (eng.device_params, arrays), eng


def entry(device=None):
    from recom_tpu_torch.models import make_random_batch

    model = _flagship()
    batch = make_random_batch(model, 128, seed=0)
    fn, args, _ = forward_entry(model, batch, device=device)
    return fn, args


def dryrun_multichip(n_devices: int, device=None, backend=None) -> dict:
    """The JAX dryrun's checks (``__graft_entry__.py:42-130``) on one
    device (``n_devices == 1``) or on a ("data", "model") mesh of
    ``n_devices`` ranks: every rank of an initialised torch.distributed
    world of at least that many ranks calls it alike (``device`` and
    ``backend`` as ``make_mesh`` takes them; ranks share a card over
    ``backend="gloo"``).  The mesh is ``(n / 2, 2)`` for an even n, else
    ``(n, 1)``; the 4096-row list table is striped (``shard_rows_above``
    2048) and looked up by the all-to-all exchange.  Pooled outputs ``==``
    the oracle before training, 9 ``Trainer`` steps on one batch with the
    loss falling, and the K1 (``use_pallas=True``) and device-hash arms
    ``==`` the oracle.  On a mesh the wire is off, in both packages, so the
    device-hash arm is the same engine with ``device_hash=True``.  Returns
    what it saw."""
    import numpy as np

    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.models import make_random_batch
    from recom_tpu_torch.models.synthetic import make_dlrm_model
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.runtime.checkpoint import export_params
    from recom_tpu_torch.train import Trainer

    mesh, mesh_cfg = None, {}
    model_axis, data_axis = 1, 1
    if n_devices > 1:
        import torch.distributed as dist

        from recom_tpu_torch.parallel import make_mesh

        if not dist.is_initialized() or dist.get_world_size() < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}): call it on every rank of "
                f"a torch.distributed world of {n_devices} ranks "
                "(parallel.multihost.init)")
        model_axis = 2 if n_devices % 2 == 0 else 1
        data_axis = n_devices // model_axis
        mesh = make_mesh((data_axis, model_axis), backend=backend,
                         device=device)
        device = mesh.device
        mesh_cfg = dict(mesh_shape=(data_axis, model_axis),
                        shard_rows_above=2048,  # stripe the 4096-row table
                        shard_comm="all_to_all")  # bit-exact (psum: 1e-6)
    # tiny model with every column type
    model = make_dlrm_model(
        4, 2, 2, 2, 1, 4, [8], [16], name="dryrun", large_rows=4096
    )
    bs = data_axis * 8
    tr = Trainer(model, EngineConfig(batch_buckets=(bs,), use_pallas=False,
                                     **mesh_cfg),
                 device=device, mesh=mesh)
    if model_axis > 1 and not tr.engine._sharded_gids:
        raise AssertionError("expected a row-sharded table group")
    batch = make_random_batch(model, bs, seed=0)

    # pooled outputs bit-exact against the NumPy oracle before any training
    params0 = export_params(tr.engine)      # the pre-training snapshot
    ref = OracleModel(model, params=params0).pooled_outputs(batch)
    got = tr.engine.predict(batch, return_pooled=True)["pooled"]
    for name, want in ref.items():
        np.testing.assert_array_equal(
            np.asarray(got[name]), want, err_msg=f"pooled {name}"
        )

    labels = np.random.default_rng(0).integers(0, 2, bs)
    loss1 = tr.step(batch, labels)
    losses = [tr.step(batch, labels) for _ in range(8)]
    if not (np.isfinite(loss1) and np.all(np.isfinite(losses))):
        raise AssertionError(f"non-finite losses: {loss1}, {losses}")
    # the same batch re-stepped: the loss must fall, not merely stay near
    if not losses[-1] < loss1 - 1e-4:
        raise AssertionError(
            f"training did not reduce loss: {loss1} -> {losses[-1]}")

    # the K1 arm and the device-hash arm: pooled outputs bit-exact against
    # the oracle of the first engine's exported params
    arm_results = {}
    for arm, kw in (
        ("pallas", dict(use_pallas=True)),
        ("dev_hash", dict(use_pallas=False, device_hash=True)),
    ):
        eng2 = Engine(model, EngineConfig(batch_buckets=(bs,), **kw,
                                          **mesh_cfg),
                      params=params0, device=tr.engine.device, mesh=mesh)
        got2 = eng2.predict(batch, return_pooled=True)["pooled"]
        for name, want in ref.items():
            np.testing.assert_array_equal(
                np.asarray(got2[name]), want, err_msg=f"pooled [{arm}] {name}"
            )
        arm_results[arm] = "bit-exact"

    summary = {
        "device": str(tr.engine.device),
        "mesh": (data_axis, model_axis),
        "sharded_groups": sorted(tr.engine._sharded_gids),
        "pooled_vs_oracle": "bit-exact",
        "loss_first": float(loss1),
        "loss_last": float(losses[-1]),
        "steps": 9,
        "arms": arm_results,
    }
    if mesh is None or mesh.rank == 0:
        print(
            f"dryrun_multichip OK on {summary['device']}: mesh="
            f"({data_axis}x{model_axis}), sharded_groups="
            f"{summary['sharded_groups']}, pooled bit-exact vs oracle, loss "
            f"{loss1:.4f} -> {losses[-1]:.4f} over 9 steps; arms bit-exact: "
            + ", ".join(f"{k}={v}" for k, v in arm_results.items())
        )
    return summary


if __name__ == "__main__":
    dryrun_multichip(1)
