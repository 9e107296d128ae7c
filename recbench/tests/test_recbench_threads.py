"""The host threads a run gives the program come from its cell's mix, and
the tools that run a cell under the benchmark's environment
(``span_report.py`` at the checkout's root) take them from
``run.host_threads``."""

import importlib.util
import os
import subprocess
import sys

import pytest

from recbench import run, spec
from recbench.tests import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]] + tiny.held_cells()


@pytest.mark.parametrize("cell", CELLS)
def test_host_threads_are_the_mixs(cell):
    mix = spec.mix(spec.workload(cell)["traffic"])
    n = run.host_threads(cell)
    if "host_threads" in mix:
        assert n == mix["host_threads"]
    else:
        workers = mix.get("prep_workers", 1)
        assert n == max(1, min(4, len(os.sched_getaffinity(0)) // workers))


def test_the_reexec_loads_no_torch():
    """``run.pinned_process`` reads the cell's mix before it re-executes the
    process: what that imports is paid twice in every run's ``setup_s``."""
    code = ("import sys, recbench.run; recbench.run.host_threads("
            "'e_train_b2048'); print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"


def _benchmark_env(monkeypatch, cell):
    n = str(run.host_threads(cell))
    for k, v in (("PYTHONHASHSEED", "0"), ("RECOM_TPU_NATIVE_THREADS", n),
                 ("OMP_NUM_THREADS", n)):
        monkeypatch.setenv(k, v)

    def execve(*a):
        raise AssertionError(f"re-executed under the benchmark's own "
                             f"environment: {a[1]}")

    monkeypatch.setattr(os, "execve", execve)


@pytest.mark.parametrize("cell", CELLS)
def test_run_stays_in_its_environment(monkeypatch, cell):
    _benchmark_env(monkeypatch, cell)
    run.pinned_process(["--workload", cell, "--seed", "1"])


@pytest.mark.parametrize("cell", CELLS)
def test_span_report_stays_in_the_benchmarks_environment(monkeypatch, cell):
    path = os.path.join(spec.ROOT, "span_report.py")
    if not os.path.exists(path):
        pytest.skip("this checkout has no span_report.py")
    mod_spec = importlib.util.spec_from_file_location("span_report", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    _benchmark_env(monkeypatch, cell)
    mod.pinned(["--workload", cell])
