"""The port's importer and Engine against REAL TensorFlow: every test of
tests/test_tf_import_real.py (one TF 2.21 graph per idiom of
docs/IMPORT_CONTRACT.md's table -- bucketized, string / int / delimited
hash, vocabulary lists with OOV buckets and defaults, identity and the
delimited int list, weighted and sparse-softmax, indicator, crossed,
numeric of width k, host-eval pre-math, shared embeddings, the PostPool
tails, frozen MLP towers -- and the SavedModel and checkpoint cases) run
with both packages in it, as tests/test_torch_tf_import.py's ``shadowed``
says: the port's importer gives the JAX importer's spec, weights and
refusals, and the port's Engine (on the CPU) serves what the test then
holds to TF's own session output with the test's own tolerance, after
agreeing with the JAX Engine (pooled ``==``, output rtol 1e-4 / atol
1e-5).  Skips without TensorFlow, as the JAX file does."""

import os

import pytest

# the JAX file hides every card from the process it is imported into
# (CUDA_VISIBLE_DEVICES=-1, for TF); keep the card visible to the port's
# tests collected beside this one
_visible = os.environ.get("CUDA_VISIBLE_DEVICES")
try:
    import test_tf_import_real  # skips this module without TensorFlow
finally:
    if _visible is None:
        os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    else:
        os.environ["CUDA_VISIBLE_DEVICES"] = _visible

from test_torch_tf_import import shadow_cases, shadowed  # noqa: E402


@pytest.mark.parametrize("fn,params", shadow_cases(test_tf_import_real))
def test_real_tf_graphs_import_and_serve_as_jax(fn, params, tmp_path,
                                                monkeypatch):
    shadowed(fn, params, tmp_path, monkeypatch)
