"""The audio frontends as parameter-free ``nn.Module``s.

``Wav2Vec2Preprocess`` is the waveform normalization of the wav2vec2 family
(port of ``thunder_tpu/audio/frontend.py::Wav2Vec2Preprocess``).

``FilterbankFeatures``, the QuartzNet/Citrinet mel frontend, ports
``thunder_tpu/audio/frontend.py::FilterbankFeatures``: dither (train
only) -> preemphasis -> power spectrum -> mel -> log (one launch of the fused
log-mel kernel on the card) -> masked per-feature normalization over the
valid frames -> SpecCutout or SpecAugment (train only). Output is
channels-last ``(batch, frames, nfilt)`` in ``dtype`` (float32 by default).

Its fields are the JAX module's. ``use_fused_kernel``: ``None`` (the
default) or ``True`` runs the log-mel kernel's wrapper, the kernel for a CUDA
tensor (on a CPU tensor its plain version, as every wrapper of the port);
``False`` runs the plain ``preemphasis`` + ``mel_features`` path on whatever
device the audio is on, the caller's explicit choice, with ``stft_method``
(``"matmul"`` or ``"fft"``) for its DFT. ``dft_precision`` is validated as
the JAX module validates it (``auto|3x|highest``) and changes nothing here:
it picks the TPU kernel's bf16 passes, and the port's log-mel kernel
computes its DFT in float32.

Train mode draws the dither noise and the masks' uniforms from the
``generator`` it is given, on the audio's device (in a data-parallel step the
dither is this rank's rows of the global batch's draw). The log-mel kernel has no
backward, so nothing upstream of the features takes a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from thunder_tpu_torch.kernels.frontend import fused_log_mel
from thunder_tpu_torch.ops.masking import lengths_to_mask, normalize_tensor
from thunder_tpu_torch.ops.specaugment import spec_augment, spec_cutout
from thunder_tpu_torch.ops.stft import mel_features, next_pow2, power_spectrum_lengths, preemphasis
from thunder_tpu_torch.parallel import spmd

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
        stft_method: str = "matmul",
        use_fused_kernel: Optional[bool] = None,
        dft_precision: str = "auto",
        div_guard: float = 1e-5,
        dtype=torch.float32,
    ):
        super().__init__()
        if num_cutout_masks > 0 and (num_freq_masks + num_time_masks > 0):
            raise ValueError("Cutout and SpecAugment can't be used at the same time.")
        if dft_precision not in ("auto", "3x", "highest"):
            raise ValueError(f"dft_precision must be auto|3x|highest, got {dft_precision!r}")
        if stft_method not in ("matmul", "fft"):
            raise ValueError(f"stft_method is 'matmul' or 'fft', got {stft_method!r}")
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
        self.stft_method = stft_method
        self.use_fused_kernel = use_fused_kernel
        self.dft_precision = dft_precision
        self.div_guard = div_guard
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype  # a bundle's config.json names it

    @property
    def fft_size(self) -> int:
        return self.n_fft or next_pow2(self.n_window_size)

    def output_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return power_spectrum_lengths(lengths, self.n_window_stride)

    def log_mel(self, x: torch.Tensor) -> torch.Tensor:
        """float32 ``(batch, time)`` audio -> ``(batch, frames, nfilt)`` log-mel: one launch of the fused kernel,
        or the plain path where ``use_fused_kernel`` is ``False``."""
        if self.use_fused_kernel is False:
            return mel_features(preemphasis(x, self.preemph), self.sample_rate, self.fft_size, self.n_window_stride,
                                self.n_window_size, self.nfilt, method=self.stft_method)
        # the log-mel kernel goes first: the card starts on it while the host queues the lengths' small ops
        return fused_log_mel(x.contiguous(), sample_rate=self.sample_rate, n_fft=self.fft_size,
                             hop_length=self.n_window_stride, win_length=self.n_window_size, n_mels=self.nfilt,
                             preemph=self.preemph)

    def normalize(self, mel: torch.Tensor, lengths: torch.Tensor, sum_dtype: Optional[torch.dtype] = None):
        """The log-mel's valid frame counts from the audio ``lengths``, and its per-feature normalization over
        them -> ``(features, frame lengths)``."""
        out_lengths = self.output_lengths(lengths)
        mask = lengths_to_mask(out_lengths, mel.shape[1])[:, :, None]
        return normalize_tensor(mel, mask, div_guard=self.div_guard, axis=1, sum_dtype=sum_dtype), out_lengths

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, sum_dtype: Optional[torch.dtype] = None):
        """``sum_dtype``: the normalization's sums, as in :func:`~thunder_tpu_torch.ops.masking.masked_mean_std`."""
        x = audio.float()
        if train and self.dither > 0:
            noise = spmd.draw_rows(lambda shape: torch.randn(shape, generator=_required(generator), device=x.device),
                                   x.shape)
            x = x + self.dither * noise
        feats, out_lengths = self.normalize(self.log_mel(x), lengths, sum_dtype)
        if train and self.num_cutout_masks > 0:
            draws = torch.rand(4 * self.num_cutout_masks, generator=_required(generator), device=feats.device)
            feats = spec_cutout(feats, draws, self.num_cutout_masks, self.mask_time_width, self.mask_freq_width)
        n_augment = self.num_time_masks + self.num_freq_masks
        if train and n_augment > 0:
            draws = torch.rand(2 * n_augment, generator=_required(generator), device=feats.device)
            feats = spec_augment(feats, draws, self.num_time_masks, self.num_freq_masks, self.mask_time_width,
                                 self.mask_freq_width)
        return feats.to(self.dtype), out_lengths


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
