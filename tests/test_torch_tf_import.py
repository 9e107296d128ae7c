"""The port's TF graph importer (``recom_tpu_torch.importers``, a copy of
``recom_tpu.importers``) against the JAX package's, and the port's Engine
serving what it imports.

Every import test of the JAX package runs here a second time with both
packages in it (``shadowed``): each call of the JAX importer also runs the
port's on the same bytes and arguments, and must give the same spec (the
two ``serde.model_to_json`` strings equal), the same weights (``==``), the
same warnings, the same imported tower and the same ``import_params``; where
the JAX importer raises, the port must raise the same exception type with
the same message.  Each Engine the test builds is also built by the port
(``Engine(device="cpu")``, same spec through serde, same config and
params); its ``predict`` must give pooled outputs ``==`` the JAX Engine's,
pooled outputs also ``==`` the port's oracle, the output within rtol 1e-4
/ atol 1e-5 and the concat within rtol 1e-6 / atol 1e-6
(tests/test_postlookup.py's tolerance for post ops), and it is
the port's result that the test then holds to the oracle and to TF's own
session output, with the test's own tolerance (``==`` where it uses
``assert_array_equal``).

Here: the synthetic GraphDefs of tests/test_tf_import.py and the import
cases of tests/test_postlookup.py (real TF graphs; they skip without TF),
and model E written as a feature-column GraphDef by chip_smoke.py's
``model_graphdef``.  tests/test_torch_tf_import_real.py runs
tests/test_tf_import_real.py the same way."""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

import chip_smoke
import recom_tpu
import recom_tpu.importers as j_importers
import recom_tpu.importers.tf_graph as j_tf
import test_postlookup
import test_tf_import
from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.compiler.lowering import lower_model as j_lower
from recom_tpu.ir import serde as j_serde
from recom_tpu.models.synthetic import make_dlrm_model as j_make_dlrm
from recom_tpu.models.synthetic import make_model_e as j_make_model_e
from recom_tpu.models.synthetic import make_random_batch
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig
from recom_tpu_torch import importers as t_importers
from recom_tpu_torch.compiler.lowering import lower_model as t_lower
from recom_tpu_torch.importers import tf_graph as t_tf
from recom_tpu_torch.ir import serde as t_serde
from recom_tpu_torch.models import make_dlrm_model as t_make_dlrm
from recom_tpu_torch.models import make_model_e as t_make_model_e
from recom_tpu_torch.oracle import OracleModel as TOracle

torch.set_num_threads(1)

IMPORTERS = ("import_tf_graphdef", "import_tf_saved_model",
             "load_checkpoint_tables")
MINI_E = (6, 2, 2, 2, 1, 4, [8], [16])


# ---------------------------------------------------------------------------
# the harness: both importers and both Engines on every call of a JAX test
# ---------------------------------------------------------------------------


def port_model(jmodel):
    """The port's spec of a JAX spec, through the JSON both packages
    write."""
    return t_serde.model_from_json(j_serde.model_to_json(jmodel))


def port_config(jcfg) -> EngineConfig:
    jcfg = jcfg or JConfig()
    return EngineConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(EngineConfig)})


def assert_same_params(a, b, what=""):
    """Two numpy pytrees of dicts and lists, leaf for leaf, with ``==``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), what
        for k in a:
            assert_same_params(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_params(x, y, f"{what}/{i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, what
        np.testing.assert_array_equal(x, y, err_msg=what)


def assert_same_import(jres, tres):
    """One importer call's results in both packages: spec, weights,
    warnings, imported tower and import_params."""
    if isinstance(jres, dict):                      # load_checkpoint_tables
        assert_same_params(jres, tres, "tables")
        return
    (jm, jw), (tm, tw) = jres, tres
    assert type(tm).__module__.startswith("recom_tpu_torch.")
    assert t_serde.model_to_json(tm) == j_serde.model_to_json(jm)
    assert_same_params(jw, tw, "weights")
    assert getattr(tm, "import_warnings", None) == getattr(
        jm, "import_warnings", None)
    assert_same_params(getattr(jm, "imported_tower_params", None) or {},
                       getattr(tm, "imported_tower_params", None) or {},
                       "imported_tower_params")
    assert_same_params(j_tf.import_params(jm, jw),
                       t_tf.import_params(tm, tw), "import_params")


class Shadow:
    """What one shadowed test did: importer calls compared, refusals
    compared, predicts compared."""

    def __init__(self):
        self.imports = self.refusals = self.predicts = 0
        self._depth = 0

    def importer(self, name):
        j_fn, t_fn = getattr(j_tf, name), getattr(t_tf, name)

        def both(*args, **kwargs):
            if self._depth:                 # a call from inside the other
                return j_fn(*args, **kwargs)
            self._depth += 1
            try:
                try:
                    jres = j_fn(*args, **kwargs)
                except Exception as e:
                    with pytest.raises(Exception) as got:
                        t_fn(*args, **kwargs)
                    assert type(got.value) is type(e)
                    assert str(got.value) == str(e)
                    self.refusals += 1
                    raise
                tres = t_fn(*args, **kwargs)
            finally:
                self._depth -= 1
            assert_same_import(jres, tres)
            self.imports += 1
            return jres

        return both

    def engine_class(self):
        shadow = self

        class ShadowEngine(JEngine):
            """The JAX Engine, with the port's Engine beside it; predict
            returns the port's result once the two agree (and its pooled
            outputs equal the port's oracle's)."""

            def __init__(self, model, config=None, params=None):
                if params is None:
                    params = init_model_params(model)
                super().__init__(model, config, params)
                self.port = Engine(port_model(model), port_config(config),
                                   params=params, device="cpu")
                self.oracle = TOracle(port_model(model), params)

            def predict(self, batch, batch_size=None, return_pooled=False,
                        return_concat=False):
                jout = super().predict(batch, batch_size, return_pooled,
                                       return_concat)
                out = self.port.predict(batch, batch_size, return_pooled,
                                        return_concat)
                np.testing.assert_allclose(out["output"], jout["output"],
                                           rtol=1e-4, atol=1e-5)
                if return_concat:
                    np.testing.assert_allclose(out["concat"], jout["concat"],
                                               rtol=1e-6, atol=1e-6)
                if return_pooled:
                    ref = self.oracle.forward(batch)["pooled"]
                    assert set(out["pooled"]) == set(jout["pooled"]) == set(
                        ref)
                    for col, r in jout["pooled"].items():
                        np.testing.assert_array_equal(out["pooled"][col], r,
                                                      err_msg=col)
                        np.testing.assert_array_equal(out["pooled"][col],
                                                      ref[col], err_msg=col)
                shadow.predicts += 1
                return out

        return ShadowEngine


def shadow_cases(module, keep=lambda name: True):
    """``pytest.param(test function, its parameters)`` for every test
    function of ``module`` that ``keep`` admits, one per parametrised case;
    a case the test's own ``skipif`` skips is skipped here too."""
    cases = []
    for name, fn in sorted(vars(module).items()):
        if not (name.startswith("test_") and inspect.isfunction(fn)
                and keep(name)):
            continue
        marks = getattr(fn, "pytestmark", [])
        params = [{}]
        for m in marks:
            if m.name == "parametrize":
                names = m.args[0]
                names = ([n.strip() for n in names.split(",")]
                         if isinstance(names, str) else list(names))
                params = [dict(p, **dict(zip(names, v if len(names) > 1
                                             else (v,))))
                          for p in params for v in m.args[1]]
        skip = [pytest.mark.skip(reason=m.kwargs.get("reason", "skipif"))
                for m in marks if m.name == "skipif" and m.args[0]]
        for p in params:
            pid = "-".join(str(v) for v in p.values())
            cases.append(pytest.param(fn, p, marks=skip,
                                      id=f"{name}[{pid}]" if p else name))
    return cases


def shadowed(fn, params, tmp_path, monkeypatch) -> Shadow:
    """Run the JAX test ``fn`` with both importers and both Engines in it
    (the package attributes and the test module's own names patched)."""
    shadow = Shadow()
    wrapped = {name: shadow.importer(name) for name in IMPORTERS}
    wrapped["Engine"] = shadow.engine_class()
    for mod in (j_tf, j_importers, recom_tpu):
        for name, f in wrapped.items():
            if name in vars(mod) or (mod is recom_tpu and name == "Engine"):
                monkeypatch.setattr(mod, name, f)
    for name, f in wrapped.items():
        if name in fn.__globals__:
            monkeypatch.setitem(fn.__globals__, name, f)
    kwargs = dict(params)
    for arg in inspect.signature(fn).parameters:
        if arg not in kwargs:
            kwargs[arg] = {"tmp_path": tmp_path,
                           "monkeypatch": monkeypatch}[arg]
    fn(**kwargs)
    assert shadow.imports + shadow.refusals + shadow.predicts > 0, (
        f"{fn.__name__} reached neither importer nor Engine")
    return shadow


# ---------------------------------------------------------------------------
# the synthetic graphs and the post-lookup import cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn,params", shadow_cases(test_tf_import))
def test_synthetic_graphs_import_and_serve_as_jax(fn, params, tmp_path,
                                                  monkeypatch):
    shadowed(fn, params, tmp_path, monkeypatch)


@pytest.mark.parametrize("fn,params", shadow_cases(
    test_postlookup, keep=lambda name: name.startswith("test_import_")))
def test_postlookup_imports_serve_as_jax(fn, params, tmp_path, monkeypatch):
    shadow = shadowed(fn, params, tmp_path, monkeypatch)
    assert shadow.imports >= 1 and shadow.predicts >= 1


def test_port_importers_expose_the_entry_points():
    for name in ("import_tf_graphdef", "import_tf_saved_model",
                 "import_params", "load_checkpoint_tables"):
        assert getattr(t_importers, name) is getattr(t_tf, name)


def test_strict_refusals_are_the_same():
    """The refusals of tests/test_tf_import.py's strict cases, one by one:
    the same exception type and message from both importers, and the same
    warnings under strict=False."""
    graphs = [test_tf_import._bucketize_slot_graph(residue_op="Softplus"),
              test_tf_import.node("x", "Placeholder",
                                  dtype=test_tf_import.av_type(1))]
    for g in graphs:
        with pytest.raises(ValueError) as want:
            j_tf.import_tf_graphdef(g, name="m", strict=True)
        with pytest.raises(ValueError) as got:
            t_tf.import_tf_graphdef(g, name="m", strict=True)
        assert str(got.value) == str(want.value)
    jm, _ = j_tf.import_tf_graphdef(graphs[0], name="m", strict=False)
    tm, _ = t_tf.import_tf_graphdef(graphs[0], name="m", strict=False)
    assert tm.import_warnings == jm.import_warnings
    assert any("Softplus" in w for w in tm.import_warnings)


# ---------------------------------------------------------------------------
# model E as a GraphDef (chip_smoke.model_graphdef)
# ---------------------------------------------------------------------------


def _groups(compiled):
    return [(g.gid, g.dim, g.ragged, g.pallas_vocab, g.stacked_rows,
             [(m.table, m.row_offset, m.vocab_size) for m in g.members])
            for g in compiled.groups]


def test_model_e_graphdef_imports_as_model_e():
    """model_graphdef(make_model_e(scale=0.02)) through both importers:
    equal specs, equal to the native model's, and the same four groups
    as the native model lowers to."""
    native = t_make_model_e(scale=0.02)
    data = chip_smoke.model_graphdef(native)
    tm, tw = t_tf.import_tf_graphdef(data, tower=native.tower,
                                     name=native.name)
    jnative = j_make_model_e(scale=0.02)
    jm, jw = j_tf.import_tf_graphdef(data, tower=jnative.tower,
                                     name=jnative.name)
    assert t_serde.model_to_json(tm) == j_serde.model_to_json(jm)
    assert t_serde.model_to_json(tm) == t_serde.model_to_json(native)
    assert tw == jw == {}                  # VariableV2 tables: no values
    assert len(tm.import_warnings) == len(native.tables)
    cfg = EngineConfig()
    want = _groups(t_lower(native, cfg))
    assert _groups(t_lower(tm, cfg)) == want
    assert _groups(j_lower(jm, JConfig())) == want
    assert [len(g[5]) for g in want] == [19, 1, 1, 1]


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_imported_model_e_serves_as_native(table_dtype):
    """Model E's column kinds at test size (the 2^23-row tables cut to
    20 000 rows), written and imported, served with the native model's
    params: outputs == the native engine's, pooled == the JAX Engine's on
    the JAX import of the same bytes."""
    native = t_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    jnative = j_make_dlrm(*MINI_E, name="mini", large_rows=20_000)
    data = chip_smoke.model_graphdef(native)
    tm, _ = t_tf.import_tf_graphdef(data, tower=native.tower, name="mini")
    jm, _ = j_tf.import_tf_graphdef(data, tower=jnative.tower, name="mini")
    params = init_model_params(jnative)
    batch = make_random_batch(jnative, 50, seed=9)
    cfg = EngineConfig(table_dtype=table_dtype)
    out = Engine(tm, cfg, params=params, device="cpu").predict(
        batch, return_pooled=True, return_concat=True)
    want = Engine(native, cfg, params=params, device="cpu").predict(
        batch, return_pooled=True, return_concat=True)
    for key in ("output", "concat"):
        np.testing.assert_array_equal(out[key], want[key])
    jout = JEngine(jm, JConfig(table_dtype=table_dtype),
                   params=params).predict(batch, return_pooled=True)
    assert set(out["pooled"]) == set(want["pooled"]) == set(jout["pooled"])
    for col in want["pooled"]:
        np.testing.assert_array_equal(out["pooled"][col], want["pooled"][col])
        np.testing.assert_array_equal(out["pooled"][col], jout["pooled"][col])
    np.testing.assert_allclose(out["output"], jout["output"], rtol=1e-4,
                               atol=1e-5)


def test_model_e_graphdef_is_small_and_refuses_unwritable_columns():
    """Model E's full-width graph holds shapes, not weights (a few MB for
    5.37 GB of tables), and the writer refuses a transform it has no TF
    idiom for rather than writing a different column."""
    from recom_tpu_torch.ir import spec as S

    data = chip_smoke.model_graphdef(t_make_model_e())
    assert len(data) < 4 << 20
    jm, _ = j_tf.import_tf_graphdef(data, tower=j_make_model_e().tower,
                                    name="E")
    assert len(jm.embedding_columns) == 1000 and len(jm.columns) == 1032
    assert json.loads(j_serde.model_to_json(jm)) == json.loads(
        t_serde.model_to_json(t_make_model_e()))
    bad = t_make_dlrm(1, 0, 0, 0, 0, 1, [4], [4], name="bad")
    col = bad.columns[0]
    bad.columns[0] = dataclasses.replace(col, transforms=(S.Mod(7),))
    with pytest.raises(RuntimeError, match="no writer for Mod"):
        chip_smoke.model_graphdef(bad)
