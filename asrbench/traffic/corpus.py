"""Clip lengths and batches, fixed by a traffic file's parameters: the same for every seed.

Serving draws its 1,024 clip lengths at the stratified quantiles ``(i + 0.5) / n`` of a lognormal fitted to
LibriSpeech test-clean (Panayotov et al., 2015: 2,620 utterances in 5.4 h, a mean of 7.4 s, none past 35 s;
assumed: median 6 s, sigma 0.65, clipped to 1-35 s), and packs them as a duration-bucketing sampler does
(Lhotse's ``max_duration``, fairseq's ``max_tokens``): sorted by length, each batch filled while its padded
size, rows times the longest clip rounded up to the engine's one-second bucket, stays within the budget.

Training draws its clip lengths at the stratified quantiles of U(10, 15) s, a mean of 12.5 s, after LibriSpeech
train-clean-100 (the same paper: 28,539 utterances in 100.6 h, a mean of 12.7 s). Of both sources only the means
and the longest clip are taken; the shapes of the distributions are assumed.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

SAMPLE_RATE = 16000


def bucket(samples: int, multiple: int = SAMPLE_RATE) -> int:
    """The engine's padding: up to a multiple of one second."""
    return max(multiple, -(-int(samples) // multiple) * multiple)


def stratified(n: int, quantile) -> np.ndarray:
    """``quantile((i + 0.5) / n)`` for ``i < n``, in ascending order."""
    return np.asarray([quantile((i + 0.5) / n) for i in range(n)])


def lognormal_lengths(p: dict) -> np.ndarray:
    """Clip lengths in samples from ``clips``, ``median_s``, ``sigma``, ``min_s`` and ``max_s``."""
    z = NormalDist()
    seconds = stratified(p["clips"], lambda q: p["median_s"] * float(np.exp(p["sigma"] * z.inv_cdf(q))))
    return np.round(np.clip(seconds, p["min_s"], p["max_s"]) * SAMPLE_RATE).astype(np.int64)


def uniform_lengths(n: int, lo_s: float, hi_s: float) -> np.ndarray:
    """``n`` lengths in samples at the stratified quantiles of U(lo, hi)."""
    return np.round(stratified(n, lambda q: lo_s + (hi_s - lo_s) * q) * SAMPLE_RATE).astype(np.int64)


def pack(lengths: np.ndarray, max_batch_s: float) -> list:
    """Clip indices in batches, shortest first, each within ``max_batch_s`` of padded audio."""
    order = np.argsort(lengths, kind="stable")
    budget = max_batch_s * SAMPLE_RATE
    batches, current = [], []
    for i in order:
        if current and (len(current) + 1) * bucket(lengths[i]) > budget:
            batches.append(current)
            current = []
        current.append(int(i))
    if current:
        batches.append(current)
    return batches
