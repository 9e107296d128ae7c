"""The traffic generators reproduce by seed."""

import numpy as np
import pytest

from recbench import spec
from recbench.traffic import batches
from recbench.tests import tiny

SEED = 2**31 + 12345


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("cell", ["e_serve_c4_b2048", "criteo_train_b2048"])
def test_pool_repeats_by_seed(cell):
    work, cfg, mix = tiny.cell(cell)
    one, two = (batches.make_pool(cfg, mix, SEED) for _ in range(2))
    for a, b in zip(one, two):
        _same(a, b)
    other = batches.make_pool(cfg, mix, SEED + 1)
    assert any(not np.array_equal(one[0][k], other[0][k]) for k in one[0])
    # a batch of the pool is the same whatever the pool's size
    _same(batches.make_pool(cfg, dict(mix, pool=1), SEED)[0], one[0])
    assert not all(np.array_equal(one[0][k], one[1][k]) for k in one[0])


def test_labels_repeat_by_seed():
    mix = tiny.mix("steps_b2048")
    a = batches.make_labels(mix, SEED, 3)
    np.testing.assert_array_equal(a, batches.make_labels(mix, SEED, 3))
    assert set(np.unique(a)) <= {0.0, 1.0}
    assert not np.array_equal(a, batches.make_labels(mix, SEED, 4))


def test_values_follow_the_mix():
    cfg = spec.config("model_e")
    mix = spec.mix("closed_c4_b2048")
    b = batches.make_batch(cfg, mix["values"], 256, SEED, 0)
    assert len(b) == 1000 + 32
    x = b["bucketize0"]
    assert x.dtype == np.float32 and x.min() >= -1 and x.max() < 10000
    assert b["categ_hashbucket0"].dtype == np.dtype("S8")
    items = [len(s.split(b";")) for s in b["categ_large_hashbucket_sparse0"]]
    assert min(items) >= 1 and max(items) <= 10
    assert b["categ_hashbucket_int0"].max() < 100
    crit = batches.make_batch(spec.config("criteo_dlrm"),
                              spec.mix("criteo_steps_b2048")["values"],
                              4096, SEED, 0)
    assert crit["cat0"].max() > 2**31
    assert crit["int0"].min() >= 0
    assert crit["int0"].max() <= np.float32(np.log1p(99))
