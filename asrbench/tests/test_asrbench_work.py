"""The frozen copies of the work and FLOP arithmetic, pinned at the cells' shapes, and equal to the program's
counters they were copied from."""

import json

import pytest

from asrbench.core import BENCH
from asrbench.work import bounds, flops

QN = json.loads((BENCH / "configs" / "quartznet15x5.json").read_text())
W2V = json.loads((BENCH / "configs" / "wav2vec2-base-960h.json").read_text())


def test_flops_pinned():
    assert flops.quartznet_forward_flops(1501, batch=64) == 1811728261120
    assert flops.quartznet_train_flops(240000, batch=16) == 1372226711552
    assert flops.wav2vec2_forward_flops(240000, batch=16) == 3667655294976
    assert flops.wav2vec2_train_flops(240000, batch=8, frozen_extractor=True) == 4323542188032


def test_flops_equal_the_programs_counters():
    from thunder_tpu_torch import flops as program

    assert flops.quartznet_forward_flops(751, batch=3) == program.quartznet_forward_flops(751, batch=3)
    assert flops.quartznet_train_flops(160000, batch=2) == program.quartznet_train_flops(160000, batch=2)
    assert flops.wav2vec2_forward_flops(123457, batch=3) == program.wav2vec2_forward_flops(123457, batch=3)
    assert flops.wav2vec2_train_flops(99999, batch=2, frozen_extractor=True) == \
        program.wav2vec2_train_flops(99999, batch=2, frozen_extractor=True)


def test_peak_is_fixed_by_the_card():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(KeyError):
        flops.peak_flops("cpu")


def test_bounds_pinned():
    assert bounds.separable_repeat_bound_s(QN, [{"batch": 64, "samples": 240000}]) == pytest.approx(2.5842623274e-3, rel=1e-9)
    assert bounds.mha_from_qkv_bound_s(W2V, [{"batch": 16, "samples": 240000}]) == pytest.approx(3.34572147446e-4, rel=1e-9)
    assert bounds.mha_train_bound_s(W2V, [{"batch": 8, "samples": 240000}]) == pytest.approx(5.855012580e-4, rel=1e-9)
    assert len(bounds.quartznet_separable_shapes(QN, 1501)) == 77  # the engine's 77 separable launches a forward


def test_family_flops_follow_the_config():
    from asrbench.families import quartznet, wav2vec2

    assert quartznet.forward_flops(QN, 64, 240000) == 1811728261120
    assert wav2vec2.train_flops(W2V, 8, 240000) == 4323542188032
