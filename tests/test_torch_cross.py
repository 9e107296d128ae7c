"""Mirrors of tests/test_cross.py's engine and serde tests through the
port: a hashed feature cross (``CrossHash``, the analogue of
tf.feature_column.crossed_column) on dense and on list members, served by
the port's Engine on the CPU and held ``==`` to the oracle and to the JAX
Engine; and the port's serde round trip of a cross column, whose JSON is
the JAX package's."""

import numpy as np
import torch

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.ir import spec as js
from recom_tpu.ir.serde import model_to_json as j_to_json
from recom_tpu.oracle import OracleModel
from recom_tpu.oracle.hashing import cross_hash
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig
from recom_tpu_torch.ir import spec as ts
from recom_tpu_torch.ir.serde import model_from_json, model_to_json

torch.set_num_threads(1)


def cross_model(S, nb=1000):
    """tests/test_cross.py's ``cross_model`` on the spec module ``S``."""
    tables = {"t": S.TableSpec("t", nb, 4)}
    cols = [
        S.FeatureColumn(
            "city_x_device",
            S.FeatureSource("city_x_device", S.FeatureKind.CROSS,
                            fields=("city", "device")),
            (S.CrossHash(nb),),
            S.LookupSpec("t", S.Combiner.SUM),
        )
    ]
    return S.ModelSpec("cross", tables, cols,
                       S.TowerSpec(arch="mlp", top_mlp=(),
                                   final_activation=None))


def _served(batch):
    """(the port's pooled column, the JAX Engine's, the oracle's) on the
    same params, both engines with use_pallas=False as in the source."""
    jm, tm = cross_model(js), cross_model(ts)
    params = init_model_params(jm)
    out = Engine(tm, EngineConfig(use_pallas=False), params=params,
                 device="cpu").predict(batch, return_pooled=True)
    jout = JEngine(jm, JConfig(use_pallas=False), params=params).predict(
        batch, return_pooled=True)
    ref = OracleModel(jm, params).forward(batch)
    col = "city_x_device"
    return out["pooled"][col], jout["pooled"][col], ref["pooled"][col]


def test_dense_cross_oracle_and_engine():
    """tests/test_cross.py:72."""
    batch = {
        "city": ["SF", "NYC", "SF"],
        "device": np.array([1, 2, 1], np.int64),
    }
    jm = cross_model(js)
    sp = OracleModel(jm).column_ids(jm.columns[0], batch)
    np.testing.assert_array_equal(
        sp.values, [cross_hash(("SF", 1), 1000),
                    cross_hash(("NYC", 2), 1000),
                    cross_hash(("SF", 1), 1000)])
    got, jgot, want = _served(batch)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got[0], got[2])


def test_list_cross_combinatorial():
    """tests/test_cross.py:92: row 0 crosses SF x {1, 2} and LA x {1, 2},
    four ids; row 1 one."""
    batch = {
        "city": [["SF", "LA"], ["NYC"]],
        "device": [[1, 2], [3]],
    }
    jm = cross_model(js)
    sp = OracleModel(jm).column_ids(jm.columns[0], batch)
    np.testing.assert_array_equal(sp.row_ids, [0, 0, 0, 0, 1])
    assert sp.values[0] == cross_hash(("SF", 1), 1000)
    got, jgot, want = _served(batch)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jgot)


def test_cross_serde_roundtrip():
    """tests/test_cross.py:113 through the port's serde; its JSON is the
    JAX package's, byte for byte."""
    m = cross_model(ts)
    s = model_to_json(m)
    m2 = model_from_json(s)
    assert m2.columns[0].source.fields == ("city", "device")
    assert isinstance(m2.columns[0].transforms[0], ts.CrossHash)
    assert model_to_json(m2) == s
    assert s == j_to_json(cross_model(js))
    assert m2.spec_hash() == cross_model(js).spec_hash()
