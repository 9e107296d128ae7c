"""Mirrors of tests/test_clamp.py's engine tests through the port (the
first, :35, is tests/test_torch_engine.py's
``test_overrange_ids_clamp_to_member_like_jax``): a weighted bucketize
column, a two-byte delimiter, a bucketize chain past its table's rows, the
native branchless bucketize on +-inf / NaN / exact boundaries, and device
bucketize boundaries rounded up to f32 (ceil32).  Each is held as its
source holds it, to the JAX package's oracle on the same params, and the
port's Engine also ``==`` the JAX Engine's pooled outputs where the source
serves one."""

import numpy as np
import pytest
import torch

from recom_tpu import Engine as JEngine
from recom_tpu import EngineConfig as JConfig
from recom_tpu.ir import spec as js
from recom_tpu.oracle import OracleModel
from recom_tpu.utils.params import init_model_params
from recom_tpu_torch import Engine, EngineConfig
from recom_tpu_torch.ir import spec as ts

torch.set_num_threads(1)


def _tower(S):
    return S.TowerSpec(arch="mlp", bottom_mlp=(), top_mlp=(4, 1),
                       final_activation=None)


def _pooled(S_model, params, batch, **kw):
    """The port's pooled outputs (CPU) and the JAX Engine's (interpret
    mode) for the model builder ``S_model`` under the config ``kw``."""
    out = Engine(S_model(ts), EngineConfig(**kw), params=params,
                 device="cpu").predict(batch, return_pooled=True)
    jout = JEngine(S_model(js), JConfig(interpret=True, **kw),
                   params=params).predict(batch, return_pooled=True)
    return out["pooled"], jout["pooled"]


def _weighted_bucketize(S):
    tables = {"t": S.TableSpec("t", 11, 4)}
    cols = [
        S.FeatureColumn(
            "wb", S.FeatureSource("wb", S.FeatureKind.DENSE_FLOAT),
            (S.Bucketize(list(range(0, 50, 5))),),
            S.LookupSpec("t", S.Combiner.MEAN, weight_field="w"),
        ),
    ]
    return S.ModelSpec("wbz", tables, cols, _tower(S))


@pytest.mark.parametrize("wire_pack", [True, False])
def test_weighted_bucketize_column_matches_oracle(wire_pack):
    """tests/test_clamp.py:77: a weighted bucketize column (forced ragged)
    on both encodings."""
    model = _weighted_bucketize(js)
    params = init_model_params(model)
    rng = np.random.default_rng(3)
    batch = {"wb": rng.uniform(-5, 55, 32).astype(np.float32),
             "w": rng.uniform(0.2, 2.0, 32).astype(np.float32)}
    ref = OracleModel(model, params=params).forward(batch)
    got, jgot = _pooled(_weighted_bucketize, params, batch,
                        wire_pack=wire_pack, batch_buckets=(32,))
    np.testing.assert_array_equal(got["wb"], ref["pooled"]["wb"])
    np.testing.assert_array_equal(got["wb"], jgot["wb"])


def _multibyte(S):
    tables = {"t": S.TableSpec("t", 300, 4)}
    cols = [
        S.FeatureColumn(
            "tags", S.FeatureSource("tags", S.FeatureKind.STRING_LIST,
                                    delimiter="||"),
            (S.HashBucket(300),), S.LookupSpec("t", S.Combiner.SUM),
        ),
    ]
    return S.ModelSpec("md", tables, cols, _tower(S))


@pytest.mark.parametrize("device_hash", [True, False])
@pytest.mark.parametrize("wire_pack", [True, False])
def test_multibyte_delimiter_matches_oracle(wire_pack, device_hash):
    """tests/test_clamp.py:108: '||' splits on the two bytes, empty pieces
    (leading, trailing) hashed as the oracle does; on the port's wire with
    and without the strings hashed by X2's plain version."""
    model = _multibyte(js)
    params = init_model_params(model)
    batch = {"tags": np.asarray(
        ["a||b||c", "xyz", "", "q||r", "lone||", "||lead"], dtype="S"
    )}
    ref = OracleModel(model, params=params).forward(batch)
    got, jgot = _pooled(_multibyte, params, batch, wire_pack=wire_pack,
                        device_hash=device_hash, batch_buckets=(8,))
    np.testing.assert_array_equal(got["tags"], ref["pooled"]["tags"])
    np.testing.assert_array_equal(got["tags"], jgot["tags"])


def _overrange_bucketize(S):
    tables = {"t": S.TableSpec("t", 5, 4), "u": S.TableSpec("u", 5, 4)}
    cols = [
        S.FeatureColumn("bz", S.FeatureSource("bz", S.FeatureKind.DENSE_FLOAT),
                        (S.Bucketize([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),),
                        S.LookupSpec("t", S.Combiner.MEAN)),
        S.FeatureColumn("u", S.FeatureSource("u", S.FeatureKind.DENSE_INT),
                        (S.NumToId(5, default_id=0),),
                        S.LookupSpec("u", S.Combiner.MEAN)),
    ]
    return S.ModelSpec("bzc", tables, cols, _tower(S))


@pytest.mark.parametrize("host_bucketize", [True, False])
@pytest.mark.parametrize("wire_pack", [True, False])
def test_overrange_bucketize_lut_clamps(wire_pack, host_bucketize):
    """tests/test_clamp.py:139: a bucketize chain with more boundaries
    than table rows clamps to the member's last row; in the port also with
    the raw floats bucketized on the device (K2's plain version)."""
    model = _overrange_bucketize(js)
    params = init_model_params(model)
    batch = {"bz": np.asarray([-1.0, 0.5, 3.5, 9.9], np.float32),
             "u": np.asarray([0, 1, 2, 3], np.int64)}
    want_rows = params["tables"]["t"][[0, 1, 4, 4]].astype(np.float32)
    got, jgot = _pooled(_overrange_bucketize, params, batch,
                        wire_pack=wire_pack, host_bucketize=host_bucketize,
                        batch_buckets=(4,))
    np.testing.assert_array_equal(got["bz"], want_rows)
    np.testing.assert_array_equal(got["bz"], jgot["bz"])


def test_bucketize_flag2_inf_nan_edges():
    """tests/test_clamp.py:170 on the port's copy of the native host ops:
    the branchless (flag-2) bucketize == float64 searchsorted on +inf,
    -inf, NaN and exact-boundary inputs, under every flag."""
    from recom_tpu_torch.native import ops as native_ops
    from recom_tpu_torch.native.build import get_lib

    if get_lib() is None:
        pytest.skip("native lib unavailable")
    bounds64 = np.arange(1.0, 9.0)                  # uniform -> flag 2
    b32 = native_ops.ceil32(bounds64)
    kmax = 16
    bounds32 = np.full((1, kmax), np.inf, np.float32)
    bounds32[0, :8] = b32
    counts = np.asarray([8], np.int32)
    inv_ds = np.asarray([(8 - 1) / (b32[-1] - b32[0])], np.float32)
    x = np.asarray(
        [np.inf, -np.inf, np.nan, 0.5, 1.0, 8.0, 4.4, 7.999999],
        np.float32,
    )
    want = np.searchsorted(bounds64, x.astype(np.float64), side="right")
    for flag in (0, 1, 2):
        out = np.zeros((1, 8), np.int8)
        native_ops.bucketize_multi(
            [x], bounds32, counts, inv_ds,
            np.asarray([flag], np.uint8), None, None, out, 8,
        )
        np.testing.assert_array_equal(
            out[0].astype(np.int64), want, err_msg=f"flag={flag}"
        )


BZ32_BOUNDS = [0.7, 1.3, 2.2, 3.1]       # all round down in f32


def _bz32(S):
    tables = {"t": S.TableSpec("t", len(BZ32_BOUNDS) + 1, 4, init_seed=3)}
    cols = [
        S.FeatureColumn(
            "x", S.FeatureSource("x", S.FeatureKind.DENSE_FLOAT),
            (S.Bucketize(BZ32_BOUNDS),), S.LookupSpec("t", S.Combiner.MEAN),
        )
    ]
    return S.ModelSpec("bz32", tables, cols, _tower(S))


@pytest.mark.parametrize("kw", [
    {},                                           # wire + host bucketize
    {"host_bucketize": False},                    # device bucketize (K2)
    {"host_bucketize": False, "wire_pack": False},
], ids=["wire_host", "wire_device", "structured_device"])
def test_device_bucketize_boundaries_match_oracle_f64(kw):
    """tests/test_clamp.py:202: inputs on, just below and just above the
    f32 roundings of boundaries that round down bucket as the oracle's
    f64 comparison says, on the host and on the device.  Held to the numpy
    oracle, as the source holds it (no subnormal here; XLA on the CPU
    would read one as zero, ROADMAP Queue 3)."""
    model = _bz32(js)
    params = init_model_params(model)
    probes = np.asarray(BZ32_BOUNDS, np.float32)
    x = np.concatenate([
        probes,
        np.nextafter(probes, np.float32(-np.inf)),
        np.nextafter(probes, np.float32(np.inf)),
        np.asarray([0.0, 5.0], np.float32),
    ]).astype(np.float32)
    batch = {"x": x}
    want = OracleModel(model, params=params).pooled_outputs(batch)["x"]
    got = Engine(_bz32(ts), EngineConfig(**kw), params=params,
                 device="cpu").predict(batch, return_pooled=True)
    np.testing.assert_array_equal(got["pooled"]["x"], want)
