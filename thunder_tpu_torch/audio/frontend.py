"""The QuartzNet/Citrinet mel frontend as a parameter-free ``nn.Module``.

Port of the eval path of ``thunder_tpu/audio/frontend.py::FilterbankFeatures``:
preemphasis -> power spectrum -> mel -> log (one launch of the fused log-mel
kernel on the card) -> masked per-feature normalization over the valid
frames. Output is channels-last ``(batch, frames, nfilt)`` float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from thunder_tpu_torch.kernels.frontend import fused_log_mel
from thunder_tpu_torch.ops.masking import lengths_to_mask, normalize_tensor
from thunder_tpu_torch.ops.stft import next_pow2, power_spectrum_lengths

__all__ = ["FilterbankFeatures"]


class FilterbankFeatures(nn.Module):
    """Raw audio ``(batch, time)`` -> normalized log-mel ``(batch, frames, nfilt)``."""

    def __init__(
        self,
        sample_rate: int = 16000,
        n_window_size: int = 320,
        n_window_stride: int = 160,
        n_fft: Optional[int] = None,
        preemph: float = 0.97,
        nfilt: int = 64,
        div_guard: float = 1e-5,
    ):
        super().__init__()
        if n_window_size <= 0 or n_window_stride <= 0:
            raise ValueError(
                "FilterbankFeatures got an invalid value for either n_window_size "
                "or n_window_stride. Both must be positive ints."
            )
        self.sample_rate = sample_rate
        self.n_window_size = n_window_size
        self.n_window_stride = n_window_stride
        self.n_fft = n_fft
        self.preemph = preemph
        self.nfilt = nfilt
        self.div_guard = div_guard

    @property
    def fft_size(self) -> int:
        return self.n_fft or next_pow2(self.n_window_size)

    def output_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return power_spectrum_lengths(lengths, self.n_window_stride)

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor, train: bool = False):
        if train:
            raise NotImplementedError(
                "FilterbankFeatures(train=True): dither and SpecAugment wait for ROADMAP item A6 (module.py + specaugment)"
            )
        out_lengths = self.output_lengths(lengths)
        mel = fused_log_mel(
            audio.float().contiguous(),
            sample_rate=self.sample_rate,
            n_fft=self.fft_size,
            hop_length=self.n_window_stride,
            win_length=self.n_window_size,
            n_mels=self.nfilt,
            preemph=self.preemph,
        )
        mask = lengths_to_mask(out_lengths, mel.shape[1])[:, :, None]
        return normalize_tensor(mel, mask, div_guard=self.div_guard, axis=1), out_lengths
