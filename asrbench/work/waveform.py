"""Speech-like test audio made from a seed.

A rewrite of ``bench.py::bench_waveform`` at commit 6ca5cdbbf336fefac8336cbc2e6f4fc3b5b7d9f8, without its
mp3 path: a harmonic series (five harmonics, 1/k amplitudes) on a pitch contour, a syllable-rate amplitude
envelope and a little noise. Where the original varied only the noise, each clip here draws its own base
pitch, contour, envelope rate and level from the seed, so that the seed changes the audio and not the sizes.
Made on ``device`` in chunks of clips, each chunk in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000


def waveforms(lengths, seed: int, device, chunk: int = 64) -> list:
    """One float32 numpy clip of each length (samples), from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lengths = [int(n) for n in lengths]
    params = torch.rand((len(lengths), 6), generator=gen, device=device, dtype=torch.float64)
    out = []
    for start in range(0, len(lengths), chunk):
        part = lengths[start: start + chunk]
        p = params[start: start + len(part)]
        width = max(part)
        t = torch.arange(width, device=device, dtype=torch.float64)[None, :] / SAMPLE_RATE
        f0_base = 90.0 + 130.0 * p[:, 0:1]
        depth = 10.0 + 30.0 * p[:, 1:2]
        rate = 1.5 + 2.0 * p[:, 2:3]
        f0 = f0_base + depth * torch.sin(2 * math.pi * rate * t + 2 * math.pi * p[:, 3:4])
        phase = 2 * math.pi * torch.cumsum(f0, dim=1) / SAMPLE_RATE
        del f0
        voiced = sum(torch.sin(k * phase) / k for k in range(1, 6))
        envelope = 0.5 * (1 + torch.sin(2 * math.pi * (3.0 + 3.0 * p[:, 4:5]) * t))
        level = 0.08 + 0.12 * p[:, 5:6]
        noise = torch.randn((len(part), width), generator=gen, device=device, dtype=torch.float32)
        audio = (level * envelope * voiced).float() + 0.01 * noise
        host = audio.cpu().numpy()
        out.extend(np.ascontiguousarray(host[i, :n]) for i, n in enumerate(part))
    return out
