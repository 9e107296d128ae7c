"""The port's examples (``recom_tpu_torch/examples/``, ROADMAP item 18) on
the CPU at tiny sizes, each through its ``main(argv)`` with ``--device
cpu``: each prints its check against the oracle, and with no card and no
``--device`` each raises rather than fall back to the CPU."""

import numpy as np
import pytest
import torch

from recom_tpu_torch.examples import dlrm, microbenchmark, serving

torch.set_num_threads(1)

CASES = {
    "dlrm": (dlrm, ["--scale", "0.02", "--batch", "64", "--train-steps",
                    "2"], dlrm.BIT_EXACT),
    "microbenchmark": (microbenchmark, ["--columns", "20", "--runs", "3"],
                       "bit-exact vs oracle: 20 columns OK"),
    "serving": (serving, ["--columns", "10", "--batch", "32", "--requests",
                          "6"], serving.BIT_EXACT),
}


@pytest.mark.parametrize("name", list(CASES))
def test_example_prints_its_check_on_cpu(name, capsys):
    mod, argv, check = CASES[name]
    res = mod.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert check in lines, lines
    if name == "dlrm":
        assert res["output"].shape == (64, 1)
        assert len(res["losses"]) == 2
        assert np.isfinite(res["losses"]).all()
    elif name == "microbenchmark":
        assert res["stats"]["latency_ms"] > 0
        assert res["device"] == "cpu"
    else:
        assert len(res["outputs"]) == 6
        assert res["compiles"][0] == res["compiles"][1]


def test_examples_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples run on it")
    for name, (mod, argv, _) in CASES.items():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            mod.main(argv)
