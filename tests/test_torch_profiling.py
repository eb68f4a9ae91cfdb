"""The port's profiling module against the JAX package's (CPU).

- ``StepTimer``: ``summary()`` equal to the JAX ``StepTimer``'s on the same recorded step times and audio
  samples (with and without warm-up skipping, without audio), and the same error for ``stop`` before ``start``;
- ``trace``: a CPU trace of a forward of the port's module with an ``annotate`` span inside, written into
  ``tmp_path`` as one Chrome trace (JSON) that holds the span and the forward's operators.
"""

import json

import numpy as np
import pytest
import torch

from thunder_tpu.profiling import StepTimer as JaxStepTimer
from thunder_tpu_torch.profiling import StepTimer, annotate, trace


@pytest.mark.parametrize("times,samples,skip", [
    ([0.5, 0.25, 0.125, 0.25], [16000, 32000, 32000, 8000], 1),
    ([0.5, 0.25, 0.125], [16000, 32000, 32000], 0),
    ([0.3], [48000], 1),  # all steps skipped: the summary falls back to every step
    ([0.2, 0.4], [0, 0], 1),  # no audio: no rtf
    ([0.0, 0.0], [16000, 16000], 1),  # a zero total
])
def test_step_timer_summary_matches_jax(times, samples, skip):
    got, want = StepTimer(sample_rate=8000), JaxStepTimer(sample_rate=8000)
    for timer in (got, want):
        timer.times, timer.audio_samples = list(times), list(samples)
    assert got.summary(skip_warmup=skip) == want.summary(skip_warmup=skip)


def test_step_timer_records_steps_and_refuses_stop_without_start():
    timer = StepTimer()
    for _ in range(3):
        with timer.step(batch_audio_samples=16000):
            pass
    assert len(timer.times) == 3 and timer.audio_samples == [16000] * 3 and min(timer.times) >= 0.0
    with pytest.raises(RuntimeError, match=r"stop\(\) without start\(\)"):
        StepTimer().stop()
    with pytest.raises(RuntimeError, match=r"stop\(\) without start\(\)"):
        JaxStepTimer().stop()


def test_trace_writes_a_chrome_trace_with_the_annotated_span(tmp_path):
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(),
                              QuartznetEncoder(filters=(32,), kernel_sizes=(11,), repeat=1, repeat_blocks=1),
                              Conv1dDecoder(5), BatchTextTransformer(list("abc ")), device="cpu")
    audio = (np.random.default_rng(0).standard_normal((2, 8000)) * 0.2).astype(np.float32)
    with trace(str(tmp_path)) as prof:
        with annotate("serve"):
            module.infer(audio, [8000, 6000])
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "serve"]
    assert spans and all(e["dur"] > 0 for e in spans)
    assert any(e.get("name") == "aten::conv1d" for e in events)
    assert "serve" in {e.key for e in prof.key_averages()}
