"""The reduction of a traced window: idle gaps put down to the innermost
host span, and the window read on the host's clock."""

import time

import pytest

from recbench.counts.model import WORK
from recbench.trace import Tracer, kernel_files, kernel_work


def test_gaps_go_to_the_innermost_span():
    gaps = [(0, 100), (200, 300)]
    host = [(0, 300, "step"), (10, 60, "prepare"), (250, 260, "dispatch"),
            (255, 258, "result")]
    got = Tracer._label_gaps(gaps, host)
    assert {k: round(v * 1e9) for k, v in got.items()} == {
        "step": 140, "prepare": 50, "dispatch": 7, "result": 3}
    assert Tracer._label_gaps([(0, 10)], []) == {"other": 1e-08}


def test_window_on_the_cpu():
    spans = {"prepare": [], "queue_wait": []}
    with Tracer() as tr:
        t0 = time.perf_counter()
        time.sleep(0.05)
        spans["prepare"].append((t0, time.perf_counter()))
        spans["queue_wait"].append((t0 - 1.0, t0))
    got = tr.summary(spans)
    assert got["busy_s"] == 0.0 and got["work_s"] == {}
    assert 0.05 <= got["window_s"] < 1.0
    labels = dict(got["idle_gaps"])
    # the whole window is one gap; the sleep's span covers most of it
    assert labels["prepare"] > 0.8 * got["window_s"]
    assert "queue_wait" not in labels


@pytest.mark.parametrize("name, work", [
    ("void onehot_lookup_kernel<8, float, float>(Args)", "lookup"),
    ("void onehot_lookup_kernel<8, unsigned short, float>(Args)", "lookup"),
    ("void pooled_gather_kernel<(int)0>(Args)", "lookup"),
    ("void hash_rows_kernel<true>(Args)", "lookup"),
    ("void onehot_grad_kernel<false, 8>(Args)", "lookup_grad"),
    ("void pooled_gather_grad_kernel(Args)", "lookup_grad"),
    ("void partition_kernel(Args)", "lookup_grad"),
    ("cutlass_80_simt_sgemm_256x128_8x4_nn_align1", None),
])
def test_kernel_files_name_the_work(name, work):
    kernels = kernel_files()
    assert {k["work"] for k in kernels} <= set(WORK)
    assert kernel_work(name, kernels) == work
