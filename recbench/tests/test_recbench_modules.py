"""Tower architectures and column kinds are modules found by name
(``towers/<arch>.py``, ``kinds/<kind>.py``): nothing else names one, and a
new one comes as a new module, with no edit to any file that is here."""

import ast
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from recbench import kinds, spec, towers, weights
from recbench.counts import model as counts
from recbench.reference.model import Reference
from recbench.tests import tiny
from recbench.traffic import batches


def _module_names(package) -> set:
    return {f[:-3] for f in os.listdir(os.path.dirname(package.__file__))
            if f.endswith(".py") and f != "__init__.py"}


def _named(path, names):
    """The lines of ``path`` holding a string constant that is one of
    ``names``, other than as a subscript's key (a mix's ``values["..."]``
    range is no column kind)."""
    tree = ast.parse(open(path).read())
    keys = {id(node.slice) for node in ast.walk(tree)
            if isinstance(node, ast.Subscript)}
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and node.value in names
            and id(node) not in keys]


def test_no_module_names_an_arch_or_a_kind():
    names = _module_names(towers) | _module_names(kinds)
    assert {"mlp", "dlrm_dot", "dense_float", "string_list"} <= names
    found = {}
    for dirpath, dirs, files in os.walk(spec.PKG):
        rel = os.path.relpath(dirpath, spec.PKG)
        if rel.split(os.sep)[0] in ("towers", "kinds", "tests",
                                    "__pycache__"):
            continue
        for f in files:
            if f.endswith(".py"):
                lines = _named(os.path.join(dirpath, f), names)
                if lines:
                    found[os.path.join(rel, f)] = lines
    assert not found


def test_an_unknown_module_names_its_file():
    with pytest.raises(ValueError, match="recbench/towers/nope.py"):
        towers.load("nope")
    with pytest.raises(ValueError, match="recbench/kinds/nope.py"):
        kinds.load("nope")


TOWER = '''
    """A test tower: every input into one linear layer."""
    import math

    import torch

    from recbench import spec


    def layers(cfg):
        n = cfg["dense"]["count"] + sum(c.dim * c.count
                                        for c in spec.classes(cfg))
        return {"top": [{"w": (n, 1), "b": (1,)}]}


    def draw(layer, gen, device):
        n_in, n_out = layer["w"]
        w = torch.randn((n_in, n_out), generator=gen, device=device)
        return {"w": w.mul_(1 / math.sqrt(n_in)),
                "b": torch.full((n_out,), 0.25, device=device)}


    def forward(mm_in, cfg, tower, dense, emb, final):
        x = torch.cat([dense] + [e.flatten(1) for e in emb], dim=1)
        z = mm_in(x) @ mm_in(tower["top"][0]["w"])
        z = (z + tower["top"][0]["b"])[:, 0]
        return z if final is None else torch.sigmoid(z)


    def ops(cfg):
        n = layers(cfg)["top"][0]["w"][0]
        return {"forward": 2 * n, "step": 6 * n}
'''

KIND = '''
    """A test kind: two integers a row, each hashed as its decimal
    string."""
    import numpy as np

    from recbench import kinds
    from recbench.reference.hashing import decimal_bytes

    SINGLE = False
    DEVICE_HASHED = False


    def make(rng, cls, values, batch):
        lo, hi = values["dense_int"]
        return list(rng.integers(lo, hi, (cls.count, batch, 2)))


    def ids(cls, column, rows):
        kinds.need_hash(cls)
        v = np.asarray(column, np.int64)
        return kinds.hash_rows(decimal_bytes(v.ravel()), rows).reshape(
            v.shape)
'''


@pytest.fixture
def added(tmp_path, monkeypatch):
    """``towers/affine_test.py`` and ``kinds/int_pair_test.py`` in a
    directory of their own on the finders' paths."""
    for package, name, src in ((towers, "affine_test", TOWER),
                               (kinds, "int_pair_test", KIND)):
        d = tmp_path / package.__name__.split(".")[-1]
        d.mkdir()
        (d / f"{name}.py").write_text(textwrap.dedent(src))
        monkeypatch.setattr(package, "__path__",
                            list(package.__path__) + [str(d)])
        monkeypatch.delitem(sys.modules, f"{package.__name__}.{name}",
                            raising=False)
    yield
    for name in ("recbench.towers.affine_test",
                 "recbench.kinds.int_pair_test"):
        sys.modules.pop(name, None)


def test_a_new_tower_and_kind_are_new_files(added):
    cfg = tiny.config("criteo_dlrm")
    cfg["columns"].append({"field": "pair", "count": 3,
                           "kind": "int_pair_test", "transform": "hash",
                           "table": "emb_pair", "rows": 50, "dim": 16,
                           "combiner": "sum"})
    cfg["tower"]["arch"] = "affine_test"
    mix = tiny.mix("criteo_steps_b2048")
    seed, b = 11, mix["batch"]
    pool = [batches.make_batch(cfg, mix["values"], b, seed, k)
            for k in range(3)]
    labels = [batches.make_labels(mix, seed, k) for k in range(3)]
    assert pool[0]["pair2"].shape == (b, 2)

    n_in = 13 + 26 * 16 + 3 * 16
    tw = weights.tower(cfg, seed, "cpu")
    assert list(tw) == ["top"]
    assert tw["top"][0]["w"].shape == (n_in, 1)
    assert torch.equal(tw["top"][0]["b"], torch.full((1,), 0.25))
    assert list(towers.flatten(spec.tower_layers(cfg))) == [
        "tower/top/0/w", "tower/top/0/b"]

    ref = Reference(cfg, seed, "cpu")
    scores = ref.scores(pool[0])
    assert scores.shape == (b,) and np.all((scores > 0) & (scores < 1))
    got = ref.train(pool, labels)
    assert len(got["losses"]) == 3 and all(np.isfinite(got["losses"]))
    assert {"emb_pair0", "emb_pair2", "tower/top/0/w"} <= set(
        got["grad_norms"])
    assert got["update_norms"]["emb_pair1"] > 0

    c = counts.batch_counts(cfg, pool[0])
    # the tower's 2 n_in a row; 26 + 3 x 2 pooled rows of 16 a row
    assert c["forward"]["ops"] == b * (2 * n_in + (26 + 3 * 2) * 16)
    assert c["hash"] == {"ops": 0.0, "bytes": 0.0}
