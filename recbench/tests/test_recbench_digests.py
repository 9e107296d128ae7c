"""The yardstick gives what it gave before towers and column kinds became
modules found by name: digests of the batches, the weights, the counts and
the reference's training steps, taken on the tree before that change
(``DIGESTS``) and held here bit for bit.

* every field of batches 0 and 15 of a cell's pool at full size;
* the tower's leaves, and the first ``HEAD_ROWS`` rows of each class
  table, on the CPU (a table's head drawn as ``weights.class_table`` draws
  it, ``_table_head``, since whole tables take gigabytes; held to
  ``class_table`` itself at the CPU sizes);
* ``counts.pool_counts`` of the whole pool at full size;
* ``Reference.train`` over the checked steps at the CPU sizes
  (``tests/tiny.py``), one CPU thread.
"""

import hashlib
import json
import math

import numpy as np
import pytest
import torch

from recbench import spec, weights
from recbench.counts import model as counts
from recbench.reference.model import Reference
from recbench.tests import tiny
from recbench.traffic import batches

CONFIGS = {"model_e": "steps_b2048", "criteo_dlrm": "criteo_steps_b2048"}
SEEDS = (2**31 + 77, 4_000_000_007)
HEAD_ROWS = 4096
CASES = [(name, seed) for name in CONFIGS for seed in SEEDS]

DIGESTS = {
    ("model_e", 2147483725): {
        "batch0":
            "ccb8a8d5089cd66a134edaa8c5d02e5e4661238eb5622f7fad9f69344405147e",
        "batch15":
            "d57e15cd34f01449dc5f8f5f19c6660bb5d8eaed1db94837868834cfc68a34bf",
        "weights":
            "9683ec6f5e92f922229c404ec5fa8af5523fff57790cc7a7fad9ec1433130c49",
        "counts":
            "5dbedaf8982da492f7042f8ced15d18243ad715fafdf2148d7fdfa35a964d3b6",
        "train":
            "4648106a612418ac384b71929bf353be99a98a4916f06fb733f4923d3829d62d",
    },
    ("model_e", 4000000007): {
        "batch0":
            "7c2e47c08175ec3114ac977c4fe803794fd2b6f394b4c327a7b5947140856274",
        "batch15":
            "05df54899ada7b262a119b0e84eccc46b66d966ef2aab5d15c2aa87e43be5e1e",
        "weights":
            "a6952449ad7fbc359f47bd5cf3bdb9e7ef62bfcab6fc94ec30bbeb63439dce52",
        "counts":
            "d41d3becc19f45d5740c05d5b7719f1e9bf7f18eca81fea73c0d949859cbf4a3",
        "train":
            "640f64d476a536e53d8a12a0954207ea439880dc796d671fde4aba526e396808",
    },
    ("criteo_dlrm", 2147483725): {
        "batch0":
            "491143643f9e4d18f9f3c9017d8ca8dcb9dbf59193d532d98e175a114f34e6cd",
        "batch15":
            "037e829d6487a569dd2431fa1e9160fcd3d204134477e1c473245d154a16a15b",
        "weights":
            "f6f15aa4e0dc93956f17158ee877dac2834b333716db038ed09131bcc4cf5cf5",
        "counts":
            "d062e0c1aceb6dac5110ce938256aeba22f018b427d497e5204df64554729893",
        "train":
            "f46b3bc720125373a23e1dd0cf9395a242de98836dcfa515d0d3e84c7bde5189",
    },
    ("criteo_dlrm", 4000000007): {
        "batch0":
            "7740f009ab99f398a47939e6376b7f917cffcc983411d2bde18c2cfed6d90df4",
        "batch15":
            "7e787dd8dfbf54a00715ee09ac7a82c0d4479424c7d3e7af43879df4a2f69ef4",
        "weights":
            "2da25463aa5da840ecdfb001591bd2653b41ef60f23ad4288d9111bb6d7b5fc8",
        "counts":
            "d314363e5da8f989fa711dc6c83e5e58df189610842ec5739c12ba04d366f9ba",
        "train":
            "868fadcb1e73ab94597fa5a579fb5df9fdaa5420850f8027281f4b5c911ccc42",
    },
}


def _hash_arrays(items) -> str:
    h = hashlib.sha256()
    for name, a in items:
        a = np.ascontiguousarray(a)
        h.update(f"{name}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _hash_json(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()
                          ).hexdigest()


def _table_head(cfg, index: int, seed: int, rows: int) -> torch.Tensor:
    """The first ``rows`` rows of ``weights.class_table(cfg, index, seed,
    "cpu")``: each chunk's generator seeded alike, a chunk's head drawn
    alone (the CPU's normal draws fill blocks of 16 values in order, so a
    draw's head is a shorter draw's, short of its last 16 values)."""
    cls = spec.classes(cfg)[index]
    out = []
    for j, (a, b) in enumerate(weights._chunks(cls)):
        lo = int(cls.offsets[a])
        if lo >= rows:
            break
        hi = int(cls.offsets[b]) if b < cls.count else cls.total_rows
        want = min(hi, rows) - lo
        n = hi - lo
        if want < n:
            values = 16 * math.ceil(want * cls.dim / 16) + 16
            n = min(n, math.ceil(values / cls.dim))
        gen = torch.Generator()
        gen.manual_seed(weights._seed(seed, "table", index, j))
        head = torch.randn((n, cls.dim), generator=gen)[:want]
        out.append(head.mul_(1.0 / math.sqrt(cls.dim)))
    return torch.cat(out)


def batch_digest(name: str, seed: int, k: int) -> str:
    cfg, mix = spec.config(name), spec.mix(CONFIGS[name])
    batch = batches.make_batch(cfg, mix["values"], mix["batch"], seed, k)
    return _hash_arrays(batch.items())


def weights_digest(name: str, seed: int) -> str:
    cfg = spec.config(name)
    items = [(f"tower/{part}/{i}/{k}", t.numpy())
             for part, layers in weights.tower(cfg, seed, "cpu").items()
             for i, layer in enumerate(layers) for k, t in layer.items()]
    items += [(f"table/{ci}", _table_head(cfg, ci, seed, HEAD_ROWS).numpy())
              for ci in range(len(spec.classes(cfg)))]
    return _hash_arrays(items)


def counts_digest(name: str, seed: int) -> str:
    cfg, mix = spec.config(name), spec.mix(CONFIGS[name])
    return _hash_json(counts.pool_counts(cfg, batches.make_pool(cfg, mix,
                                                                seed)))


def train_digest(name: str, seed: int) -> str:
    cfg, mix = tiny.config(name), tiny.mix(CONFIGS[name])
    n = mix["checked_steps"]
    pool = [batches.make_batch(cfg, mix["values"], mix["batch"], seed, k)
            for k in range(n)]
    labels = [batches.make_labels(mix, seed, k) for k in range(n)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = Reference(cfg, seed, "cpu").train(pool, labels)
    finally:
        torch.set_num_threads(threads)
    return _hash_json(got)


def digests(name: str, seed: int) -> dict:
    return {"batch0": batch_digest(name, seed, 0),
            "batch15": batch_digest(name, seed, 15),
            "weights": weights_digest(name, seed),
            "counts": counts_digest(name, seed),
            "train": train_digest(name, seed)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_table_head_is_class_table(name):
    cfg = tiny.config(name)
    for ci in range(len(spec.classes(cfg))):
        whole = weights.class_table(cfg, ci, SEEDS[0], "cpu")
        for rows in (1, 100, whole.shape[0]):
            assert torch.equal(_table_head(cfg, ci, SEEDS[0], rows),
                               whole[:rows])


@pytest.mark.parametrize("name, seed", CASES)
@pytest.mark.parametrize("k", (0, 15))
def test_batches_are_the_parents(name, seed, k):
    assert batch_digest(name, seed, k) == DIGESTS[name, seed][f"batch{k}"]


@pytest.mark.parametrize("name, seed", CASES)
def test_weights_are_the_parents(name, seed):
    assert weights_digest(name, seed) == DIGESTS[name, seed]["weights"]


@pytest.mark.parametrize("name, seed", CASES)
def test_counts_are_the_parents(name, seed):
    assert counts_digest(name, seed) == DIGESTS[name, seed]["counts"]


@pytest.mark.parametrize("name, seed", CASES)
def test_reference_train_is_the_parents(name, seed):
    assert train_digest(name, seed) == DIGESTS[name, seed]["train"]
