"""The port's import contract: recom_tpu_torch (and chip_smoke.py,
predict_latency.py and postpool_latency.py) import torch and numpy,
never jax and nothing of the JAX package recom_tpu, not even its jax-free
modules (the port keeps its own copies)."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "recom_tpu_torch")


def _port_sources():
    out = [os.path.join(ROOT, f)
           for f in ("chip_smoke.py", "predict_latency.py",
                     "postpool_latency.py")]
    for dirpath, _, files in os.walk(PORT):
        if os.sep + "build" in dirpath[len(PORT):]:
            continue
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "recom_tpu")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax_and_no_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_engine_runs_without_loading_jax_or_reference():
    """In a fresh interpreter: import the port, build an Engine on the CPU
    and predict; then neither jax nor any recom_tpu module is loaded."""
    code = """
import sys
import recom_tpu_torch
from recom_tpu_torch import Engine, EngineConfig
from recom_tpu_torch.models import make_dlrm_model, make_random_batch
m = make_dlrm_model(6, 2, 2, 2, 1, 4, [8], [16], name="mini",
                    large_rows=20_000)
out = Engine(m, EngineConfig(), device="cpu").predict(
    make_random_batch(m, 11, seed=0))
assert out["output"].shape == (11, 1)
bad = [k for k in sys.modules
       if k.split(".")[0] in ("jax", "jaxlib", "recom_tpu")]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
