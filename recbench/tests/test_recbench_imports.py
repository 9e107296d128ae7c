"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``recom_tpu_torch`` is not ``recom_tpu``."""

import ast
import json
import os
import subprocess
import sys

import pytest

from recbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "recom_tpu"}
# the yardstick that must not lean on the program
PLAIN = ("reference", "counts", "traffic/batches.py", "weights.py",
         "spec.py", "check.py", "control.py", "readers.py", "metrics",
         "towers", "kinds")


def _sources():
    for dirpath, _, files in os.walk(spec.PKG):
        if os.path.basename(dirpath) in ("tests", "__pycache__"):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, spec.PKG))
def test_sources(path):
    tops = {name.split(".")[0] for name in _imported(path)}
    assert not tops & FORBIDDEN
    rel = os.path.relpath(path, spec.PKG)
    if rel.startswith(PLAIN):
        assert "recom_tpu_torch" not in tops, rel


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    """What a run loads: the harness, the program through it, the
    reference and the readers."""
    mods = _loaded(
        "import recbench.run, recbench.control, recbench.trace\n"
        "from recbench import port, spec\n"
        "port.program(); port.model(spec.config('criteo_dlrm'))\n"
        "import recom_tpu_torch.train, recom_tpu_torch.runtime.server\n"
        "[spec.metric_reader(m['name']) for m in "
        "spec.benchmark()['end_to_end'] + spec.benchmark()['per_layer']]")
    assert "recom_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_no_program():
    mods = _loaded("import recbench.reference.model, recbench.control, "
                   "recbench.counts.model, recbench.traffic.batches\n"
                   "import os, importlib\n"
                   "for d in ('towers', 'kinds'):\n"
                   "    for f in os.listdir(os.path.join('recbench', d)):\n"
                   "        if f.endswith('.py') and f != '__init__.py':\n"
                   "            importlib.import_module("
                   "f'recbench.{d}.{f[:-3]}')")
    assert not mods & (FORBIDDEN | {"recom_tpu_torch"})


def test_run_sees_forbidden_modules():
    from recbench import run

    assert "jax" not in run.loaded_forbidden()
    sys.modules["recom_tpu"] = sys.modules["recbench"]
    try:
        assert run.loaded_forbidden() == ["recom_tpu"]
    finally:
        del sys.modules["recom_tpu"]
