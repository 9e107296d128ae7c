"""The counts of operations and bytes against numbers worked by hand."""

import numpy as np
import pytest

from recbench import spec
from recbench.counts import model as counts
from recbench.reference import ids as ref_ids
from recbench.traffic import batches

SEED = 99


def _dense(layers):
    """{part: [(in, out), ...]} of dense layers ``{"w": (in, out), "b":
    (out,)}``."""
    for part in layers.values():
        for layer in part:
            assert layer["b"] == (layer["w"][1],) and len(layer) == 2
    return {part: [layer["w"] for layer in ls]
            for part, ls in layers.items()}


def test_model_e_tower():
    layers = _dense(spec.tower_layers(spec.config("model_e")))
    # 32 dense through bottom [32], then 880 + 50 + 50 + 15 columns of 8
    # and 5 of 32
    top_in = 32 + 880 * 8 + 50 * 8 + 50 * 8 + 15 * 8 + 5 * 32
    assert top_in == 8152
    assert layers["top"] == [(8152, 1024), (1024, 1024), (1024, 128),
                             (128, 1)]
    assert sum(i * o for i, o in layers["top"]) == 9_527_424
    assert layers["bottom"] == [(32, 32)]


def test_criteo_tower():
    layers = _dense(spec.tower_layers(spec.config("criteo_dlrm")))
    assert layers["bottom"] == [(13, 512), (512, 256), (256, 64), (64, 16)]
    # the bottom's 16 beside the 27 * 26 / 2 = 351 pairs of 27 vectors
    assert layers["top"] == [(367, 512), (512, 256), (256, 1)]
    macs = sum(i * o for part in layers.values() for i, o in part)
    assert macs == 155_136 + 319_232


def _items(cfg, batch):
    out = []
    for cls in spec.classes(cfg):
        ids = ref_ids.class_ids(cls, batch)
        out.append((cls, int((ids >= 0).sum()),
                    len(np.unique(ref_ids.flat_ids(cls, ids)[ids >= 0]))))
    return out


def test_criteo_forward_and_step():
    cfg = spec.config("criteo_dlrm")
    mix = spec.mix("criteo_steps_b2048")
    b = 512
    batch = batches.make_batch(cfg, mix["values"], b, SEED, 0)
    got = counts.batch_counts(cfg, batch)
    # per row: 2 x 474 368 MACs, 351 pairs of 16, 26 pooled rows of 16
    assert got["forward"]["ops"] == b * (2 * 474_368 + 2 * 351 * 16
                                         + 26 * 16)
    params = 155_136 + 512 + 256 + 64 + 16 + 319_232 + 512 + 256 + 1
    ((cls, items, distinct),) = _items(cfg, batch)
    assert items == 26 * b
    # params, output, 13 dense and 26 ids a row, the distinct rows
    assert got["forward"]["bytes"] == 4 * (params + b + b * 13 + b * 26
                                           + 16 * distinct)
    # the cat columns are ints hashed on the host: nothing for the card's
    # hashing; the lookups read the ids and the distinct rows and write 26
    # pooled rows a row
    assert got["hash"] == {"ops": 0.0, "bytes": 0.0}
    assert got["lookup"]["bytes"] == 4 * (26 * b + 16 * distinct
                                          + 26 * 16 * b)
    assert got["lookup_grad"] == got["lookup"]
    assert got["step"]["ops"] == pytest.approx(
        3 * got["forward"]["ops"] + 14 * params
        - b * 26 * 16 + 5 * 16 * distinct, rel=0, abs=0.5)
    # row-wise AdaGrad's state: an element on the 14 tables of at most
    # 4096 rows (the program's one-hot stack), a row on the others
    ids = ref_ids.flat_ids(cls, ref_ids.class_ids(cls, batch))
    small = cls.rows[np.searchsorted(cls.offsets, ids.ravel(),
                                     side="right") - 1] <= 4096
    rows = np.unique(ids.ravel())
    small_rows = int(small[np.unique(ids.ravel(), return_index=True)[1]]
                     .sum())
    assert len(rows) == distinct
    state = 4 * (16 * small_rows + (distinct - small_rows))
    assert got["step"]["bytes"] == pytest.approx(
        4 * (b * 13 + b * 26 + b) + 8 * 4 * params + 2 * 4 * 16 * distinct
        + 2 * state, rel=0, abs=0.5)


def test_model_e_forward():
    cfg = spec.config("model_e")
    mix = spec.mix("closed_c4_b2048")
    b = 256
    batch = batches.make_batch(cfg, mix["values"], b, SEED, 0)
    got = counts.batch_counts(cfg, batch)
    items = _items(cfg, batch)
    pooled = sum(n * cls.dim for cls, n, _ in items)
    assert got["forward"]["ops"] == b * 2 * (9_527_424 + 1024) + pooled
    # the 70 string classes' raw bytes: 8 a string, 9 an item of a list
    # less one a row
    raw = 50 * b * 8 + sum(
        9 * n - b * cls.count for cls, n, _ in items[3:])
    assert got["hash"]["bytes"] == raw + 4 * sum(n for _, n, _ in items[2:])
    assert got["step"]["ops"] > 3 * 2 * b * 9_527_424
