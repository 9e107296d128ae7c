"""The port's entry points (recom_tpu_torch/entry.py, after the root
__graft_entry__.py) on the CPU: the entry machinery against the JAX
``Engine._forward`` on the scaled model of
tests/test_sharding.py::test_graft_entry_single_chip (rtol 1e-4 / atol
1e-5), the flagship entry against ``Engine.predict``, and
``dryrun_multichip`` on one device (on a mesh: tests/test_torch_mesh_train.py)."""

import jax
import numpy as np
import pytest
import torch

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.models import make_random_batch
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.runtime.host_prep import prepare_batch as j_prepare
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import EngineConfig
from recom_tpu_torch import entry
from recom_tpu_torch.models.synthetic import make_dlrm_model as t_make_dlrm

torch.set_num_threads(1)

SCALED = (8, 2, 2, 2, 1, 4, [8], [16, 1])


def test_entry_machinery_matches_jax_forward():
    jm = j_make_dlrm(*SCALED, name="entry", large_rows=4096)
    tm = t_make_dlrm(*SCALED, name="entry", large_rows=4096)
    params = init_model_params(jm)
    batch = make_random_batch(jm, 16, seed=0)
    jeng = JEngine(jm, JConfig(use_pallas=False), params=params)
    prepared = j_prepare(jeng.compiled, batch)
    want = np.asarray(jax.jit(lambda p, a: jeng._forward(p, a)["output"])(
        jeng.device_params, prepared.arrays))
    fn, (p, arrays), eng = entry.forward_entry(
        tm, batch, config=EngineConfig(use_pallas=False), params=params,
        device="cpu")
    got = fn(p, arrays).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:16], want[:16], rtol=1e-4, atol=1e-5)
    # fn reads the params it is given: zero weights and biases give the
    # sigmoid of 0
    zero = {"stacked": p["stacked"], "tower": {
        k: [{"w": torch.zeros_like(l["w"]), "b": torch.zeros_like(l["b"])}
            for l in layers]
        for k, layers in p["tower"].items()}}
    np.testing.assert_array_equal(fn(zero, arrays).numpy(),
                                  np.full_like(got, 0.5))
    np.testing.assert_array_equal(fn(p, arrays).numpy(), got)


def test_entry_flagship_equals_predict_on_cpu():
    model = entry._flagship()
    assert len(model.embedding_columns) == 1000
    fn, args = entry.entry(device="cpu")
    out = fn(*args).numpy()
    assert out.shape == (128, 1) and np.isfinite(out).all()
    # the same batch through predict on an engine of the same params
    from recom_tpu_torch import Engine
    from recom_tpu_torch.models import make_random_batch as t_batch

    batch = t_batch(model, 128, seed=0)
    eng = Engine(model, EngineConfig(), device="cpu")
    np.testing.assert_array_equal(eng.predict(batch)["output"], out)


def test_dryrun_multichip_one_device_on_cpu():
    res = entry.dryrun_multichip(1, device="cpu")
    assert res["pooled_vs_oracle"] == "bit-exact" and res["steps"] == 9
    assert res["loss_last"] < res["loss_first"] - 1e-4
    assert res["arms"] == {"pallas": "bit-exact", "dev_hash": "bit-exact"}


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_mesh_raises_naming_item_13(n):
    """A mesh runs on every rank of a torch.distributed world
    (tests/test_torch_mesh_train.py runs it on 4); with no world it
    raises, naming what it needs."""
    with pytest.raises(RuntimeError, match=f"world of {n} ranks"):
        entry.dryrun_multichip(n, device="cpu")


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        entry.entry()
    with pytest.raises(RuntimeError, match="is_available"):
        entry.dryrun_multichip(1)


@pytest.mark.cuda
def test_entry_on_the_card_equals_predict():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from recom_tpu_torch import Engine
    from recom_tpu_torch.models import make_random_batch as t_batch

    fn, args = entry.entry()
    out = fn(*args).cpu().numpy()
    model = entry._flagship()
    eng = Engine(model, EngineConfig())
    np.testing.assert_array_equal(
        eng.predict(t_batch(model, 128, seed=0))["output"], out)
    entry.dryrun_multichip(1)
