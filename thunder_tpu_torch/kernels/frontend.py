"""The fused log-mel frontend: a CUDA kernel and its plain PyTorch version.

Port of ``thunder_tpu/kernels/frontend_pallas.py::fused_log_mel``. Preemphasis
and the centered reflect pad stay in PyTorch (cheap elementwise passes over
the raw audio, as they stay in XLA for the TPU kernel); the kernel
``csrc/log_mel.cu`` then computes framing, the windowed real DFT, power, the
mel projection and ``log(x + 2**-24)`` in one pass, so neither the frame
tensor nor the power spectrum is written to device memory.

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`log_mel_reference`) only for a CPU tensor. Neither has a backward,
as the TPU kernel has none: audio that requires a gradient raises, so that a
gradient is never cut silently.
"""

from __future__ import annotations

import functools

import torch

from thunder_tpu_torch.kernels import _build
from thunder_tpu_torch.ops.stft import mel_features, mel_filterbank, preemphasis, reflect_pad, windowed_basis

__all__ = ["fused_log_mel", "log_mel_reference"]


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


@functools.lru_cache(maxsize=None)
def _device_constants(device: torch.device, sample_rate: int, n_fft: int, win_length: int, n_mels: int):
    """The windowed DFT basis and the mel filterbank on ``device``, made once per configuration."""
    basis = torch.as_tensor(windowed_basis(n_fft, win_length), device=device).contiguous()
    mel = torch.as_tensor(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate), device=device).contiguous()
    return basis, mel


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
    n_freqs = n_fft // 2 + 1
    batch, time = audio.shape
    if n_freqs > 1024 or n_fft % 4 or hop_length % 4 or batch < 1:
        raise ValueError(f"the log-mel kernel takes n_fft <= 2046, n_fft and hop multiples of 4, batch >= 1 "
                         f"(got n_fft={n_fft}, hop={hop_length}, batch={batch})")
    if not audio.is_contiguous():
        raise ValueError("fused_log_mel takes contiguous audio")
    n_frames = time // hop_length + 1
    xp = reflect_pad(preemphasis(audio, preemph), n_fft // 2).contiguous()
    basis, mel = _device_constants(audio.device, sample_rate, n_fft, win_length, n_mels)
    out = torch.empty((batch, n_frames, n_mels), dtype=torch.float32, device=audio.device)
    lib = _build.load()
    status = lib.thunder_log_mel(
        xp.data_ptr(), basis.data_ptr(), mel.data_ptr(), out.data_ptr(),
        batch, xp.shape[1], n_frames, n_fft, hop_length, n_freqs, n_mels,
        torch.cuda.current_stream(audio.device).cuda_stream,
    )
    _build.check(status, "thunder_log_mel")
    fused_log_mel.launches += 1
    return out


fused_log_mel.launches = 0
