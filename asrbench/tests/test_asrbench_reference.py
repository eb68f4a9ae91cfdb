"""The plain reference against the port, at sizes a CPU test holds: eval logits in float32, and three training
steps of the bf16 program (its kernels' plain versions, the same dropout draws) against the float32 reference."""

import numpy as np
import pytest
import torch

from asrbench.families import quartznet, wav2vec2
from asrbench.tests import tiny
from asrbench.traffic import train


@pytest.mark.parametrize("family, sizes", [(quartznet, tiny.QUARTZNET), (wav2vec2, tiny.WAV2VEC2)])
def test_eval_logits_match_the_port(monkeypatch, family, sizes):
    tiny.small_calibration(monkeypatch)
    cell = "quartznet15x5.serve" if family is quartznet else "wav2vec2-base-960h.serve"
    config = tiny.ctx(cell).config
    state = family.make_state(config, 123, "cpu")
    module = family.port_module(config, state, "cpu")
    audio = torch.randn(3, 32000) * 0.1
    lengths = torch.tensor([32000, 20000, 9000])
    logits, frames = module.forward(audio, lengths)
    with torch.no_grad():
        ref, ref_frames = family.reference(config, state).forward(audio, lengths)
    assert torch.equal(frames.long(), ref_frames.long())
    valid = torch.arange(logits.shape[1])[None, :] < frames[:, None]
    err = ((logits - ref).abs() * valid[..., None]).max()
    assert err <= 1e-4 * ref.abs().max()  # float32 on both sides: rounding order only
    engine_logits, _, _ = family.engine(module).infer(audio.numpy(), lengths.numpy())
    assert ((engine_logits - ref).abs() * valid[..., None]).max() <= 1e-4 * ref.abs().max()  # batch norm folded


@pytest.mark.parametrize("cell", ["wav2vec2-base-960h.finetune", "quartznet15x5.train"])
def test_three_training_steps_match_the_port(monkeypatch, cell):
    """The bf16 program's losses, first gradients and three-step changes within the gaps its rounding gives at
    this size (bf16 against float32 read 0.0013, 0.0037 and 0.0099 for wav2vec2; 0.0007, 0.0036 and 0.0099 for
    QuartzNet): the reference draws the program's dropout masks, dither and kernel seeds again."""
    tiny.small_calibration(monkeypatch)
    ctx = tiny.ctx(cell)
    train.run(ctx)
    g = ctx.record["gaps"]
    assert g["loss_gap"] < 0.01 and g["grad_gap"] < 0.03 and g["change_gap"] < 0.05, g
    assert np.isfinite(g["losses"]["program"]).all()
