"""SpecAugment and SpecCutout on ``(batch, time, features)`` spectrograms.

Port of ``thunder_tpu/ops/specaugment.py``. As there (and as torchaudio's
``mask_along_axis``, which the reference uses), each mask is shared across
the batch and its width is uniform in ``[0, width)``. The functions take the
uniform draws in ``[0, 1)`` that decide the masks, two per mask; the caller
draws them from an explicit ``torch.Generator`` (``FilterbankFeatures`` in
train mode). The JAX package draws the same uniforms from ``jax.random``
keys, so given the same draws both packages zero the same bands.
"""

from __future__ import annotations

import torch

__all__ = ["axis_mask", "spec_augment", "spec_cutout"]


def axis_mask(u_width: torch.Tensor, u_start: torch.Tensor, size: int, mask_param: int) -> torch.Tensor:
    """Bool ``(size,)`` span ``[start, start + width)`` from two uniform draws."""
    value = u_width * mask_param
    min_value = u_start * (size - value)
    start = min_value.to(torch.int32)
    end = (min_value + value).to(torch.int32)
    pos = torch.arange(size, device=u_width.device)
    return (pos >= start) & (pos < end)


def spec_augment(
    x: torch.Tensor,
    draws: torch.Tensor,
    time_masks: int = 0,
    freq_masks: int = 0,
    time_width: int = 10,
    freq_width: int = 10,
) -> torch.Tensor:
    """Zero ``time_masks`` time bands, then ``freq_masks`` frequency bands.

    ``draws``: ``2 * (time_masks + freq_masks)`` uniforms, (width, start) per mask.
    """
    if draws.shape != (2 * (time_masks + freq_masks),):
        raise ValueError(f"spec_augment takes {2 * (time_masks + freq_masks)} draws, got {tuple(draws.shape)}")
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for i in range(time_masks):
        mask = axis_mask(draws[2 * i], draws[2 * i + 1], x.shape[1], time_width)
        x = torch.where(mask[None, :, None], zero, x)
    for i in range(time_masks, time_masks + freq_masks):
        mask = axis_mask(draws[2 * i], draws[2 * i + 1], x.shape[2], freq_width)
        x = torch.where(mask[None, None, :], zero, x)
    return x


def spec_cutout(
    x: torch.Tensor,
    draws: torch.Tensor,
    rect_masks: int = 0,
    time_width: int = 5,
    freq_width: int = 20,
) -> torch.Tensor:
    """Zero ``rect_masks`` time-by-frequency rectangles.

    ``draws``: ``4 * rect_masks`` uniforms, (time width, time start, frequency
    width, frequency start) per rectangle.
    """
    if draws.shape != (4 * rect_masks,):
        raise ValueError(f"spec_cutout takes {4 * rect_masks} draws, got {tuple(draws.shape)}")
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for i in range(rect_masks):
        t_mask = axis_mask(draws[4 * i], draws[4 * i + 1], x.shape[1], time_width)
        f_mask = axis_mask(draws[4 * i + 2], draws[4 * i + 3], x.shape[2], freq_width)
        x = torch.where(t_mask[None, :, None] & f_mask[None, None, :], zero, x)
    return x
