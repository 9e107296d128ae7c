"""What ``correct`` catches: each fault a cell can have, planted in the
program under a whole run of the harness (the look for a card skipped),
comes out not correct; and the control, the reference in TF32 in the
program's place, fails the cells' limits."""

import pytest

from recbench import control
from recbench.tests import tiny
from recbench.tests.test_recbench_reference import run_tiny

SERVE = ["e_serve_c4_b2048"]
TRAIN = ["e_train_b2048", "criteo_train_b2048"]


def _not_correct(cell):
    result = run_tiny(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", SERVE)
def test_answer_altered(cell, monkeypatch):
    from recom_tpu_torch.runtime.executor import InFlight

    result = InFlight.result

    def altered(self):
        out = result(self)
        out["output"] = out["output"].copy()
        out["output"][0] += 1e-3
        return out

    monkeypatch.setattr(InFlight, "result", altered)
    _not_correct(cell)


@pytest.mark.parametrize("cell", TRAIN)
def test_state_unchanged(cell, monkeypatch):
    from recom_tpu_torch.train import OptaxOptimizer

    monkeypatch.setattr(OptaxOptimizer, "apply",
                        lambda self, grads, scalars=None: None)
    _not_correct(cell)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_left_out(cell, monkeypatch):
    from recom_tpu_torch.train import Trainer

    masked = Trainer._masked_loss

    def half(self, arrays, signature, lab_t, mask_t):
        mask_t = mask_t.clone()
        mask_t[mask_t.shape[0] // 2:] = 0.0
        return masked(self, arrays, signature, lab_t, mask_t)

    monkeypatch.setattr(Trainer, "_masked_loss", half)
    _not_correct(cell)


@pytest.mark.parametrize("cell", TRAIN)
def test_loss_altered(cell, monkeypatch):
    from recom_tpu_torch.train import Trainer

    step = Trainer.step
    monkeypatch.setattr(Trainer, "step",
                        lambda self, b, y: step(self, b, y) * (1 + 1e-3))
    _not_correct(cell)


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_control_fails_the_limits(cell):
    work, cfg, mix = tiny.cell(cell)
    for seed in (5, 6, 7):
        got = control.readings(cfg, mix, seed, "cpu")
        for name, numbers in got.items():
            limits = {k: v for k, v in work["limits"].items() if k in numbers}
            assert any(numbers[k] > v for k, v in limits.items()), (
                name, numbers)
