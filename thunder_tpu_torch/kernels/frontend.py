"""The fused log-mel frontend: a CUDA kernel and its plain PyTorch version.

Port of ``thunder_tpu/kernels/frontend_pallas.py::fused_log_mel``. The kernel
``csrc/log_mel.cu`` reads the raw audio and computes the preemphasis and the
centered reflect pad on its load, then framing, the windowed real DFT, power,
the mel product and ``log(x + 2**-24)`` in one pass: nothing but the log-mel
reaches device memory. Its plan (:func:`log_mel_plan`, the kernel's own on
the card) names its path: ``"fft"`` (a real FFT a frame, for a power-of-two
``n_fft`` from 32 to 4096), ``"dense"`` (a windowed-DFT product, for any
other size) or ``"wide"`` (an ``n_fft`` whose dense tile does not fit in
shared memory, past about 16,000 with a long window: the dense product over
slices of bins into a float32 power workspace, then the mel and log in a
second launch), and the shared memory a block needs; the wrapper refuses only
a frame's span past 227 KB (a window of about 58,000 samples). Batches run
as launches over slices of at most 65,535 rows (on the wide path, of as many
rows as a 1 GiB power workspace holds).

The host tables, made once per configuration in :func:`_device_constants`
and packed into one array (:func:`packed_tables`): the twiddles ``e^{-2 pi i
k / n_fft}`` (:func:`fft_twiddles`, float64 cast to float32) and the window
on the fft path, each mel filter's non-zeros (:func:`mel_bands`); and the
windowed basis on the dense path, the window on the wide path (which makes
its basis in registers).

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`log_mel_reference`) only for a CPU tensor. Neither has a backward,
as the TPU kernel has none: audio that requires a gradient raises, so that a
gradient is never cut silently.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from thunder_tpu_torch.kernels import _build
from thunder_tpu_torch.ops.stft import hann_window, mel_features, mel_filterbank, preemphasis, windowed_basis

__all__ = ["fused_log_mel", "log_mel_reference", "log_mel_plan", "log_mel_frames", "fft_twiddles", "mel_bands",
           "packed_tables"]

#: ``csrc/log_mel.cu``'s FFT path's sizes: the tables it reads differ by path
FFT_MIN, FFT_MAX = 32, 4096
#: rows a launch (the grid's extent), and the wide path's power workspace (float32 values)
MAX_ROWS, WIDE_WORKSPACE = 65535, 1 << 28


def log_mel_reference(
    audio: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 512,
    hop_length: int = 160,
    win_length: int = 320,
    n_mels: int = 64,
    preemph: float = 0.97,
) -> torch.Tensor:
    """Plain PyTorch version: ``mel_features(preemphasis(audio))``."""
    return mel_features(preemphasis(audio.float(), preemph), sample_rate, n_fft, hop_length, win_length, n_mels)


def _fft_path(n_fft: int) -> bool:
    return n_fft > 0 and n_fft & (n_fft - 1) == 0 and FFT_MIN <= n_fft <= FFT_MAX


@functools.lru_cache(maxsize=None)
def log_mel_plan(n_fft: int, hop_length: int, win_length: int, n_mels: int) -> dict:
    """The kernel's plan for these sizes (``csrc/log_mel.cu::make_plan``): ``path`` (``"fft"`` or
    ``"dense"``), ``smem_bytes`` (0 when refused: the sizes are invalid or one frame's tile does not fit in
    227 KB), ``frames`` a block and ``threads`` a block. Builds the kernels on first use."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.load().thunder_log_mel_plan(n_fft, hop_length, win_length, n_mels, out),
                 "thunder_log_mel_plan")
    return {"path": {1: "fft", 2: "dense", 3: "wide"}[out[0]], "smem_bytes": out[1], "frames": out[2],
            "threads": out[3]}


def log_mel_frames(time: int, n_fft: int, hop_length: int) -> int:
    """Frames of a centered STFT over ``time`` samples: ``time // hop + 1`` for an even ``n_fft``."""
    return (time + 2 * (n_fft // 2) - n_fft) // hop_length + 1


def fft_twiddles(n_fft: int) -> np.ndarray:
    """``(n_fft, 2)`` float32: the real and imaginary parts of ``e^{-2 pi i k / n_fft}``, made in float64."""
    angle = -2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(angle), np.sin(angle)], axis=1).astype(np.float32)


def mel_bands(n_fft: int, n_mels: int, sample_rate: int) -> tuple[np.ndarray, np.ndarray]:
    """Each mel filter's non-zeros: ``(bands, weights)``, ``bands`` ``(3, n_mels)`` int32 (first bin, count,
    offset into ``weights``), ``weights`` float32, each filter's in ascending bin order."""
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate)
    bands, weights = np.zeros((3, n_mels), np.int32), []
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        first, stop = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        bands[:, m] = first, stop - first, len(weights)
        weights.extend(fb[first:stop, m])
    if len(weights) > 2 * fb.shape[0]:  # the kernel's shared memory holds two weights a bin
        raise ValueError(f"{len(weights)} mel weights for {fb.shape[0]} bins; slaney triangles give two a bin at most")
    return bands, np.asarray(weights, np.float32)


def packed_tables(sample_rate: int, n_fft: int, win_length: int, n_mels: int) -> np.ndarray:
    """The kernel's tables in one float32 array, as it copies them into shared memory, each part padded to a
    multiple of 4 floats: on the fft path the twiddles (:func:`fft_twiddles`, flattened) and the window, then
    the mel bands' int32 bits (:func:`mel_bands`) and their weights."""
    bands, weights = mel_bands(n_fft, n_mels, sample_rate)
    parts = [fft_twiddles(n_fft).ravel(), hann_window(win_length)] if _fft_path(n_fft) else []
    parts += [bands.ravel().view(np.float32), weights]
    return np.concatenate([np.pad(a, (0, -a.size % 4)) for a in parts]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_constants(device: torch.device, sample_rate: int, n_fft: int, win_length: int, n_mels: int, path: str):
    """``(tables, basis)`` on ``device``, made once per configuration: :func:`packed_tables`, and the windowed
    basis on the dense path, the window on the wide path (``None`` on the fft path)."""
    put = lambda a: torch.as_tensor(a, device=device).contiguous()  # noqa: E731
    basis = None
    if path == "dense":
        basis = put(windowed_basis(n_fft, win_length))
    elif path == "wide":
        basis = put(hann_window(win_length))
    return put(packed_tables(sample_rate, n_fft, win_length, n_mels)), basis


def fused_log_mel(
    audio: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 512,
    hop_length: int = 160,
    win_length: int = 320,
    n_mels: int = 64,
    preemph: float = 0.97,
) -> torch.Tensor:
    """``(batch, time)`` float32 audio -> ``(batch, time // hop + 1, n_mels)`` float32 log-mel."""
    if audio.ndim != 2 or audio.dtype != torch.float32:
        raise ValueError(f"fused_log_mel takes (batch, time) float32 audio, got {tuple(audio.shape)} {audio.dtype}")
    if audio.requires_grad:
        raise ValueError("fused_log_mel has no backward; pass audio that does not require a gradient")
    if audio.device.type == "cpu":
        return log_mel_reference(audio, sample_rate, n_fft, hop_length, win_length, n_mels, preemph)
    if audio.device.type != "cuda":
        raise ValueError(f"fused_log_mel runs on cuda or cpu tensors, got {audio.device}")
    batch, time = audio.shape
    plan = log_mel_plan(n_fft, hop_length, win_length, n_mels)
    if plan["smem_bytes"] == 0 or batch < 1:
        raise ValueError(f"the log-mel kernel takes 1 <= win <= n_fft, hop >= 1, n_mels >= 1, a row or more and "
                         f"a frame's span that fits in 227 KB of shared memory (got n_fft={n_fft}, "
                         f"hop={hop_length}, win={win_length}, n_mels={n_mels}, batch={batch})")
    if time <= n_fft // 2:  # as the plain version's reflect pad refuses it
        raise RuntimeError(f"the centered reflect pad of {n_fft // 2} samples needs more than that many samples, "
                           f"got {time}")
    if not audio.is_contiguous():
        raise ValueError("fused_log_mel takes contiguous audio")
    n_frames = log_mel_frames(time, n_fft, hop_length)
    tables, basis = _device_constants(audio.device, sample_rate, n_fft, win_length, n_mels, plan["path"])
    out = torch.empty((batch, n_frames, n_mels), dtype=torch.float32, device=audio.device)
    wide = plan["path"] == "wide"
    n_freqs = n_fft // 2 + 1
    slice_rows = min(batch, MAX_ROWS, max(1, WIDE_WORKSPACE // (n_frames * n_freqs)) if wide else MAX_ROWS)
    power = torch.empty((slice_rows, n_frames, n_freqs), dtype=torch.float32, device=audio.device) if wide else None
    status = _build.load().thunder_log_mel(
        audio.data_ptr(), tables.data_ptr(), 0 if basis is None else basis.data_ptr(),
        0 if power is None else power.data_ptr(), out.data_ptr(), batch, time, n_frames, n_fft, hop_length,
        win_length, n_mels, tables.numel(), slice_rows, float(preemph),
        torch.cuda.current_stream(audio.device).cuda_stream,
    )
    _build.check(status, "thunder_log_mel")
    fused_log_mel.launches += -(-batch // slice_rows) * (2 if wide else 1)
    return out


fused_log_mel.launches = 0
