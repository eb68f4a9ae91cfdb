"""The controls and the planted faults, at sizes a test holds: each reads above the program on the CPU, and on
the card (the cells' own sizes) each is refused by its cell's checks while the program passes them."""

import pytest
import torch

from asrbench.checks import control
from asrbench.tests import tiny
from asrbench.traffic import serve_batch, train


def test_fp8_rounds_and_passes_the_gradient():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = control.fp8(x)
    assert 0 < (y - x).abs().max() <= 0.125  # e4m3: 3 mantissa bits, a spacing of 0.25 in [2, 4)
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_fp8_gradient_rounds_only_the_backward():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = control.fp8_gradient(x)
    assert torch.equal(y, x)
    g = torch.linspace(0.5, 1.5, 101)
    y.backward(g)
    assert 0 < (x.grad - g).abs().max() <= 0.125 and x.grad.unique().numel() < 20  # e5m2: 2 mantissa bits


def test_the_serving_control_reads_above_the_program(monkeypatch):
    tiny.small_calibration(monkeypatch)
    ctx = tiny.ctx("wav2vec2-base-960h.serve", seconds=3)
    serve_batch.run(ctx)
    low = control.serve_control(tiny.ctx("wav2vec2-base-960h.serve", seconds=3))
    assert low["logit_rms_error"] > ctx.record["gaps"]["logit_rms_error"]


@pytest.mark.parametrize("cell", ["wav2vec2-base-960h.finetune", "quartznet15x5.train"])
def test_the_training_control_and_the_half_batch_read_above_the_program(monkeypatch, cell):
    tiny.small_calibration(monkeypatch)
    ctx = tiny.ctx(cell)
    train.run(ctx)
    program = ctx.record["gaps"]
    for low in (control.train_control(tiny.ctx(cell)), control.train_fault_half(tiny.ctx(cell))):
        assert low["loss1_gap"] > program["loss1_gap"] and low["grad_diff_median"] > program["grad_diff_median"]


CELLS = ["quartznet15x5.serve", "wav2vec2-base-960h.serve", "wav2vec2-base-960h.finetune", "quartznet15x5.train"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_program_passes_and_the_control_and_faults_are_refused(cell):
    """At the cell's own size: the program passes its cell's checks; the fp8 control and, where the program has one,
    its own int8 serving path each fail one of them, and so does the planted fault, except fine-tuning's half batch,
    which its numbers catch on some seeds only (its readings are printed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cells run at their own sizes")
    from asrbench.checks.limits import readings

    program = readings(cell, 2**31 + 101, 6)
    print(cell, program["gaps"])
    assert all(program["passed"].values()), program
    kinds = ["control", "fault", "int8"] if cell.endswith(".serve") else ["control", "fault"]
    for i, kind in enumerate(kinds):
        low = readings(cell, 2**31 + 102 + i, 6, kind)
        print(cell, kind, low["gaps"], low["passed"])
        if (cell, kind) != ("wav2vec2-base-960h.finetune", "fault"):
            assert not all(low["passed"].values()), low
