"""Length-mask utilities: ``(tensor, lengths)`` pairs, channels-last.

Port of ``thunder_tpu/ops/masking.py``: every batch function takes and returns
a padded tensor plus an int32 ``lengths`` vector of the valid extent along
time, and padding is kept at exactly zero.
"""

from __future__ import annotations

import torch

__all__ = ["lengths_to_mask", "apply_mask", "masked_mean_std", "normalize_tensor", "masked_feature_normalize"]


def lengths_to_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """``(batch,)`` lengths -> bool ``(batch, max_length)``, True where valid."""
    positions = torch.arange(max_length, device=lengths.device, dtype=torch.int32)
    return positions[None, :] < lengths.to(torch.int32)[:, None]


def apply_mask(x: torch.Tensor, lengths: torch.Tensor, *, time_axis: int = 1, fill_value=0.0) -> torch.Tensor:
    """Fill everything beyond ``lengths`` along ``time_axis`` with ``fill_value``."""
    mask = lengths_to_mask(lengths, x.shape[time_axis])
    shape = [1] * x.ndim
    shape[0] = x.shape[0]
    shape[time_axis] = x.shape[time_axis]
    return torch.where(mask.reshape(shape), x, torch.full((), fill_value, dtype=x.dtype, device=x.device))


def masked_mean_std(x: torch.Tensor, mask: torch.Tensor | None, axis, div_guard: float = 1e-7,
                    sum_dtype: torch.dtype | None = None):
    """Mean and population std over ``axis`` restricted to ``mask`` (keepdim).

    Without a mask: mean and ``sqrt(var_ddof1 + div_guard)``, as the JAX
    function does. Statistics are detached, like its ``stop_gradient``.

    ``sum_dtype`` (masked only): accumulate the sums in this dtype and round
    the statistics to ``x``'s. The serving engine's ``batch_invariant`` mode
    passes float64: on the card a float32 sum over the strided time axis
    changes its order with the number of rows reduced together, and the
    rounded float64 statistics of a row were measured not to.
    """
    if mask is None:
        mean = x.mean(dim=axis, keepdim=True).detach()
        var = x.var(dim=axis, correction=1, keepdim=True).detach()
        return mean, torch.sqrt(var + div_guard)
    if sum_dtype is not None and sum_dtype != x.dtype:
        mean, std = masked_mean_std(x.detach().to(sum_dtype), mask, axis)
        return mean.to(x.dtype), std.to(x.dtype)
    mask = mask.to(x.dtype)
    x = x * mask
    n = mask.sum(dim=axis, keepdim=True).detach().clamp_min(1.0)
    mean = x.sum(dim=axis, keepdim=True).detach() / n
    sq = ((x - mean) * mask).square().sum(dim=axis, keepdim=True).detach()
    return mean, torch.sqrt(sq / n)


def normalize_tensor(x: torch.Tensor, mask: torch.Tensor | None = None, div_guard: float = 1e-7, axis: int = -1,
                     sum_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Masked zero-mean/unit-std normalization.

    With a mask: population std over the valid region, ``(x - mean) / (std +
    div_guard)`` (the guard is added to the std, not the variance), invalid
    region zeroed; ``sum_dtype`` as in :func:`masked_mean_std`. Without:
    ``(x - mean) / sqrt(var_ddof1 + div_guard)``.
    """
    if mask is not None:
        maskf = mask.to(x.dtype)
        x = x * maskf
        if sum_dtype is not None and sum_dtype != x.dtype:
            mean, std = masked_mean_std(x, mask, axis=axis, div_guard=div_guard, sum_dtype=sum_dtype)
            return (x - mean) / (std + div_guard) * maskf
        # masked_mean_std's sums over the masked x, bit for bit, in fewer launches: ``centred`` is both the
        # variance's term and the output's numerator (zero beyond the mask, as ``* maskf`` leaves it)
        n = maskf.sum(dim=axis, keepdim=True).clamp_min(1.0)
        mean = x.detach().sum(dim=axis, keepdim=True) / n
        centred = (x - mean) * maskf
        std = torch.sqrt(centred.detach().square().sum(dim=axis, keepdim=True) / n)
        return centred / (std + div_guard)
    mean, std = masked_mean_std(x, None, axis=axis, div_guard=div_guard)
    return (x - mean) / std


def masked_feature_normalize(x: torch.Tensor, lengths: torch.Tensor, div_guard: float = 1e-5) -> torch.Tensor:
    """Per-(row, feature) normalization of ``(batch, time, features)`` over each row's valid frames:
    :func:`normalize_tensor` along time with the lengths' mask."""
    mask = lengths_to_mask(lengths, x.shape[1])[:, :, None]
    return normalize_tensor(x, mask, div_guard=div_guard, axis=1)
