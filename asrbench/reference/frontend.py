"""The log-mel frontend in plain float32 PyTorch: preemphasis, the centered Hann STFT, the power, the slaney mel
filterbank, ``log(x + 2**-24)`` and the per-feature normalization over each row's valid frames.

Written from the published conventions of NeMo's ``AudioToMelSpectrogramPreprocessor`` as the port states
them (20 ms Hann window, not periodic, 10 ms hop, n_fft 512, reflect-padded centered frames, preemphasis 0.97,
slaney scale and norm, ``frames = samples // hop + 1``, population statistics with the guard added to the
standard deviation), with ``torch.fft.rfft`` for the DFT.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LOG_GUARD = 2.0**-24


def _hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    logstep = math.log(6.4) / 27.0
    return np.where(freq >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
                    freq / f_sp)


def _mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    logstep = math.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), f_sp * mels)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """Triangular filters ``(n_freqs, n_mels)``, slaney scale and slaney area norm, 0 Hz to Nyquist."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0), n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / f_diff[:-1], slopes[:, 2:] / f_diff[1:]))
    return (fb * (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]).astype(np.float32)


def log_mel(audio: torch.Tensor, cfg: dict) -> torch.Tensor:
    """float32 ``(B, samples)`` -> ``(B, samples // hop + 1, n_mels)``."""
    n_fft, hop, win = cfg["n_fft"], cfg["hop_length"], cfg["win_length"]
    x = audio.float()
    x = torch.cat([x[:, :1], x[:, 1:] - cfg["preemph"] * x[:, :-1]], dim=1)
    x = F.pad(x[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0, :]
    frames = x.unfold(1, n_fft, hop)
    n = torch.arange(win, dtype=torch.float64)
    hann = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / (win - 1)))
    window = torch.zeros(n_fft, dtype=torch.float64)
    window[(n_fft - win) // 2: (n_fft - win) // 2 + win] = hann
    spec = torch.fft.rfft(frames * window.float().to(x.device), n=n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    fb = torch.as_tensor(mel_filterbank(n_fft // 2 + 1, cfg["n_mels"], cfg["sample_rate"]), device=x.device)
    return torch.log(torch.matmul(power, fb) + LOG_GUARD)


def frame_lengths(lengths: torch.Tensor, hop: int) -> torch.Tensor:
    lengths = lengths.long()
    return (lengths // hop + 1) * (lengths > 0)


def normalize(mel: torch.Tensor, frames: torch.Tensor, guard: float) -> torch.Tensor:
    """Per feature over each row's valid frames: ``(x - mean) / (std + guard)``, zero beyond them."""
    mask = (torch.arange(mel.shape[1], device=mel.device)[None, :] < frames[:, None]).float()[:, :, None]
    n = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    mean = (mel * mask).sum(dim=1, keepdim=True) / n
    centred = (mel - mean) * mask
    std = torch.sqrt(centred.square().sum(dim=1, keepdim=True) / n)
    return centred / (std + guard)


def features(audio: torch.Tensor, lengths: torch.Tensor, cfg: dict, noise: torch.Tensor | None = None):
    """The normalized log-mel of padded audio and its frame lengths; ``noise``, the dither's standard normal
    draw, is added at ``cfg["dither"]`` (training)."""
    x = audio.float()
    if noise is not None:
        x = x + cfg["dither"] * noise
    frames = frame_lengths(lengths, cfg["hop_length"]).to(audio.device)
    return normalize(log_mel(x, cfg), frames, cfg["norm_guard"]), frames
