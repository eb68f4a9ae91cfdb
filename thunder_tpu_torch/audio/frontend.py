"""The audio frontends as parameter-free ``nn.Module``s.

``Wav2Vec2Preprocess`` is the waveform normalization of the wav2vec2 family
(port of ``thunder_tpu/audio/frontend.py::Wav2Vec2Preprocess``).

``FilterbankFeatures``, the QuartzNet/Citrinet mel frontend, ports
``thunder_tpu/audio/frontend.py::FilterbankFeatures``: dither (train
only) -> preemphasis -> power spectrum -> mel -> log (one launch of the fused
log-mel kernel on the card) -> masked per-feature normalization over the
valid frames -> SpecCutout or SpecAugment (train only). Output is
channels-last ``(batch, frames, nfilt)`` float32.

Train mode draws the dither noise and the masks' uniforms from the
``generator`` it is given, on the audio's device. The log-mel kernel has no
backward, so nothing upstream of the features takes a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from thunder_tpu_torch.kernels.frontend import fused_log_mel
from thunder_tpu_torch.ops.masking import lengths_to_mask, normalize_tensor
from thunder_tpu_torch.ops.specaugment import spec_augment, spec_cutout
from thunder_tpu_torch.ops.stft import next_pow2, power_spectrum_lengths

__all__ = ["FilterbankFeatures", "Wav2Vec2Preprocess"]


def _required(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("FilterbankFeatures(train=True) draws from an explicit torch.Generator; pass generator=")
    return generator


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
        dither: float = 1e-5,
        num_cutout_masks: int = 0,
        num_time_masks: int = 0,
        num_freq_masks: int = 0,
        mask_time_width: int = 50,
        mask_freq_width: int = 20,
        div_guard: float = 1e-5,
    ):
        super().__init__()
        if num_cutout_masks > 0 and (num_freq_masks + num_time_masks > 0):
            raise ValueError("Cutout and SpecAugment can't be used at the same time.")
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
        self.dither = dither
        self.num_cutout_masks = num_cutout_masks
        self.num_time_masks = num_time_masks
        self.num_freq_masks = num_freq_masks
        self.mask_time_width = mask_time_width
        self.mask_freq_width = mask_freq_width
        self.div_guard = div_guard

    @property
    def fft_size(self) -> int:
        return self.n_fft or next_pow2(self.n_window_size)

    def output_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return power_spectrum_lengths(lengths, self.n_window_stride)

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = audio.float()
        if train and self.dither > 0:
            x = x + self.dither * torch.randn(x.shape, generator=_required(generator), device=x.device)
        out_lengths = self.output_lengths(lengths)
        mel = fused_log_mel(
            x.contiguous(),
            sample_rate=self.sample_rate,
            n_fft=self.fft_size,
            hop_length=self.n_window_stride,
            win_length=self.n_window_size,
            n_mels=self.nfilt,
            preemph=self.preemph,
        )
        mask = lengths_to_mask(out_lengths, mel.shape[1])[:, :, None]
        feats = normalize_tensor(mel, mask, div_guard=self.div_guard, axis=1)
        if train and self.num_cutout_masks > 0:
            draws = torch.rand(4 * self.num_cutout_masks, generator=_required(generator), device=feats.device)
            feats = spec_cutout(feats, draws, self.num_cutout_masks, self.mask_time_width, self.mask_freq_width)
        n_augment = self.num_time_masks + self.num_freq_masks
        if train and n_augment > 0:
            draws = torch.rand(2 * n_augment, generator=_required(generator), device=feats.device)
            feats = spec_augment(feats, draws, self.num_time_masks, self.num_freq_masks, self.mask_time_width,
                                 self.mask_freq_width)
        return feats, out_lengths


class Wav2Vec2Preprocess(nn.Module):
    """Zero-mean, unit-variance waveform over each row's valid samples (HF-compatible).

    - ``mask_input=True``: population std, ``(x - mean) / (std + div_guard)``;
    - ``mask_input=False``: sample std (ddof 1), ``(x - mean) / sqrt(var +
      div_guard)``. The N/(N-1) factor moves wav2vec2-base logits by about
      5e-3 at 1 s of audio, enough to flip near-tie argmaxes.

    Both take their statistics over the valid samples only and zero the rest,
    so a clip's output does not depend on its padding. ``train`` and
    ``generator`` are accepted for ``CTCModel`` and change nothing.
    """

    def __init__(self, div_guard: float = 1e-7, mask_input: bool = False):
        super().__init__()
        self.div_guard = div_guard
        self.mask_input = mask_input

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        mask = lengths_to_mask(lengths, audio.shape[-1])
        if self.mask_input:
            return normalize_tensor(audio, mask, div_guard=self.div_guard, axis=-1), lengths
        maskf = mask.to(audio.dtype)
        x = audio * maskf
        n = maskf.sum(dim=-1, keepdim=True)
        mean = x.sum(dim=-1, keepdim=True) / n
        var = ((x - mean) * maskf).square().sum(dim=-1, keepdim=True) / (n - 1.0).clamp_min(1.0)
        return (x - mean) / torch.sqrt(var + self.div_guard) * maskf, lengths
