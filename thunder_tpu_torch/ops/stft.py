"""Spectral ops: framing, STFT (a windowed-basis matmul or an FFT), power spectrum, slaney mel filterbank.

Port of ``thunder_tpu/ops/stft.py``. The numpy helpers (window, mel
filterbank, real-DFT basis) are copied as they are, because the JAX package
cannot be imported without JAX. The tensor functions compute in float32 and
follow the same conventions: hann window with ``periodic=False``, centered
frames with reflect padding, ``frames = time // hop + 1``, slaney-scale and
slaney-norm mel filters, ``log(x + 2**-24)``. Everything is channels-last:
``(batch, frames, freqs)`` and ``(batch, frames, n_mels)``.

On the card the float32 matmuls here run in full float32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "hann_window",
    "next_pow2",
    "mel_filterbank",
    "frame_signal",
    "stft",
    "convolution_stft",
    "power_spectrum",
    "power_spectrum_lengths",
    "mel_features",
    "preemphasis",
]


def next_pow2(n: int) -> int:
    return 2 ** math.ceil(math.log2(n))


def hann_window(win_length: int, periodic: bool = False, dtype=np.float32) -> np.ndarray:
    """Hann window; ``periodic=False`` matches ``torch.hann_window(periodic=False)``."""
    if win_length == 1:
        return np.ones((1,), dtype=dtype)
    n = np.arange(win_length, dtype=np.float64)
    denom = win_length if periodic else win_length - 1
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))
    return w.astype(dtype)


_F_SP = 200.0 / 3.0  # linear region: mels per Hz below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # = 15.0
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    return np.where(log_region, _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mels)


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)), freqs)


def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank ``(n_freqs, n_mels)``, slaney scale and norm."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max), n_mels + 2)
    f_pts = _mel_to_hz_slaney(mel_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = (-slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
    return (fb * enorm[None, :]).astype(dtype)


def _padded_window(window: np.ndarray, n_fft: int) -> np.ndarray:
    """Center-pad a window of length win_length to n_fft (torch.stft behavior)."""
    win_length = window.shape[0]
    lpad = (n_fft - win_length) // 2
    rpad = n_fft - win_length - lpad
    return np.pad(window, (lpad, rpad))


def _rdft_basis(n_fft: int, dtype=np.float32, rows: slice = slice(None)):
    """Real-DFT basis: cos/sin matrices of shape (n_fft, n_fft//2+1), or their ``rows``."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[rows, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    angle = -2.0 * np.pi * n * k / n_fft
    return np.cos(angle).astype(dtype), np.sin(angle).astype(dtype)


def windowed_basis(n_fft: int, win_length: int, rows: slice = slice(None)) -> np.ndarray:
    """``(n_fft, 2 * n_freqs)`` float32: the windowed cos basis, then the sin basis; or their ``rows``."""
    window = _padded_window(hann_window(win_length), n_fft)[rows]
    cos_b, sin_b = _rdft_basis(n_fft, rows=rows)
    return np.concatenate([cos_b * window[:, None], sin_b * window[:, None]], axis=1).astype(np.float32)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad ``(batch, time)`` by ``pad`` samples on both sides."""
    return F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int, center: bool = True) -> torch.Tensor:
    """``(batch, time)`` -> overlapping frames ``(batch, frames, n_fft)``.

    With ``center=True`` the signal is reflect-padded by ``n_fft // 2`` on both
    sides first, giving ``1 + time // hop`` frames.
    """
    if center:
        x = reflect_pad(x, n_fft // 2)
    return x.unfold(1, n_fft, hop_length)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int, center: bool = True,
         method: str = "matmul"):
    """Real and imaginary STFT ``(batch, frames, n_fft // 2 + 1)``.

    ``method="matmul"``: a windowed-basis matmul over the window's samples of each frame (the basis is zero
    outside them, so a large ``n_fft`` with a short window stays small). ``"fft"``: ``torch.fft.rfft`` of the
    windowed frames, the JAX package's numerical reference.
    """
    if method == "fft":
        window = torch.as_tensor(_padded_window(hann_window(win_length), n_fft), device=x.device)
        spec = torch.fft.rfft(frame_signal(x.float(), n_fft, hop_length, center=center) * window, n=n_fft, dim=-1)
        return spec.real, spec.imag
    if method != "matmul":
        raise ValueError(f"stft method is 'matmul' or 'fft', got {method!r}")
    n_freqs = n_fft // 2 + 1
    under = slice((n_fft - win_length) // 2, (n_fft - win_length) // 2 + win_length)
    basis = torch.as_tensor(windowed_basis(n_fft, win_length, under), device=x.device)
    spec = torch.matmul(frame_signal(x.float(), n_fft, hop_length, center=center)[..., under], basis)
    return spec[..., :n_freqs], spec[..., n_freqs:]


def convolution_stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int, center: bool = True):
    """The FFT-free STFT (a windowed DFT matmul): ``stft(..., method="matmul")``; returns ``(real, imag)``."""
    return stft(x, n_fft, hop_length, win_length, center=center, method="matmul")


def power_spectrum_lengths(lengths: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Frame count of the valid samples: ``len // hop + 1``, and 0 for a length of 0."""
    lengths = lengths.to(torch.int32)
    return (torch.div(lengths, hop_length, rounding_mode="floor") + 1) * (lengths > 0)


def power_spectrum(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                   method: str = "matmul") -> torch.Tensor:
    """``|STFT|^2`` of ``(batch, time)`` audio -> ``(batch, frames, n_freqs)``; ``method`` as :func:`stft`'s."""
    real, imag = stft(x, n_fft, hop_length, win_length, center=True, method=method)
    return real * real + imag * imag


def preemphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """``y[n] = x[n] - coeff * x[n-1]``, ``y[0] = x[0]``."""
    return torch.cat([x[:, :1], x[:, 1:] - coeff * x[:, :-1]], dim=1)


def mel_features(
    x: torch.Tensor,
    sample_rate: int,
    n_fft: int,
    hop_length: int,
    win_length: int,
    n_mels: int,
    log_scale: bool = True,
    method: str = "matmul",
) -> torch.Tensor:
    """Power spectrum -> mel -> log: ``(batch, time)`` -> ``(batch, frames, n_mels)``; ``method`` as
    :func:`stft`'s."""
    power = power_spectrum(x, n_fft, hop_length, win_length, method=method)
    fb = torch.as_tensor(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate), device=x.device)
    mel = torch.matmul(power, fb)
    if log_scale:
        mel = torch.log(mel + 2.0**-24)
    return mel
