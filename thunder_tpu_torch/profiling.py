"""Profiling and step timing.

Port of ``thunder_tpu/profiling.py``: ``trace`` records the enclosed block
with ``torch.profiler`` (host and CUDA activity; the host's alone where no
card is present) and writes a Chrome trace into ``log_dir``, viewable in
Perfetto, ``chrome://tracing`` or TensorBoard's PyTorch profiler plugin;
``annotate`` names a region on that timeline; ``StepTimer`` keeps wall-clock
step statistics and the real-time factor of audio workloads.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

__all__ = ["trace", "StepTimer", "annotate"]

#: small kernels a trace launches, and waits for, before its block (see ``trace``)
_WARMUP_LAUNCHES = 1024


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; on exit write its Chrome trace, ``<host>_<pid>.<ms>.pt.trace.json``,
    into ``log_dir``. Yields the ``torch.profiler.profile`` (``key_averages()`` and the like).

    With a card, the trace opens with ``_WARMUP_LAUNCHES`` small kernels in a ``trace_warmup`` range, waited
    for, before the block: late in a long process on an H100 a trace lacked the kernel records of its first
    33-39 launches while holding every later one; the warm-up's kernels take that loss."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))) as prof:
        if torch.cuda.is_available():
            with torch.profiler.record_function("trace_warmup"):
                x = torch.zeros((), device="cuda")
                for _ in range(_WARMUP_LAUNCHES):
                    x.add_(1)
                torch.cuda.synchronize()
        yield prof


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    return torch.profiler.record_function(name)


@dataclass
class StepTimer:
    """Wall-clock step statistics + real-time factor for audio workloads.

    The clock stops when ``stop`` is called: as the JAX package's caller
    blocks on its step's outputs, the caller here makes the step's device work
    finish first (``torch.cuda.synchronize()``), or a step measures only the
    time to queue it.
    """

    sample_rate: int = 16000
    times: List[float] = field(default_factory=list)
    audio_samples: List[int] = field(default_factory=list)
    _start: Optional[float] = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self, batch_audio_samples: int = 0):
        if self._start is None:
            raise RuntimeError("StepTimer.stop() without start()")
        self.times.append(time.perf_counter() - self._start)
        self.audio_samples.append(batch_audio_samples)
        self._start = None

    @contextlib.contextmanager
    def step(self, batch_audio_samples: int = 0):
        self.start()
        try:
            yield
        finally:
            self.stop(batch_audio_samples)

    def summary(self, skip_warmup: int = 1) -> Dict[str, float]:
        times = self.times[skip_warmup:] or self.times
        samples = self.audio_samples[skip_warmup:] or self.audio_samples
        total = sum(times)
        out = {
            "steps": float(len(times)),
            "mean_step_s": total / max(len(times), 1),
            "steps_per_sec": len(times) / total if total else 0.0,
        }
        if any(samples):
            audio_sec = sum(samples) / self.sample_rate
            out["rtf"] = audio_sec / total if total else 0.0
        return out
