"""1-D convolution primitives, channels-last, with length bookkeeping.

Port of ``thunder_tpu/ops/conv.py``. Activations are ``(batch, time,
channels)`` and kernels keep the JAX package's WIO layout ``(kernel_size,
in_channels // groups, out_channels)``, so weights move between the two
packages without reshaping.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["get_same_padding", "conv_output_length", "conv1d"]


def get_same_padding(kernel_size: int, stride: int = 1, dilation: int = 1) -> int:
    """Symmetric padding giving ``out_len == ceil(in_len / stride)``.

    Raises:
        ValueError: if both stride and dilation exceed 1.
    """
    if stride > 1 and dilation > 1:
        raise ValueError("Only stride OR dilation may be greater than 1")
    if dilation > 1:
        return (dilation * (kernel_size - 1) + 1) // 2
    return kernel_size // 2


def conv_output_length(lengths, kernel_size: int, stride: int = 1, padding: int = 0, dilation: int = 1):
    """``floor((L + 2p - d(k-1) - 1) / s) + 1`` for ints, numpy arrays or tensors."""
    numer = lengths + 2 * padding - dilation * (kernel_size - 1) - 1
    if isinstance(lengths, torch.Tensor):
        return (torch.div(numer, stride, rounding_mode="floor") + 1).to(torch.int32)
    return np.floor_divide(numer, stride) + 1


def conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Channels-last 1-D convolution with a WIO kernel.

    Args:
        x: ``(batch, time, in_channels)``.
        kernel: ``(kernel_size, in_channels // groups, out_channels)``.
        bias: optional ``(out_channels,)``.

    Returns:
        ``(batch, out_time, out_channels)``.
    """
    weight = kernel.permute(2, 1, 0)  # WIO -> torch's OIW
    out = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride, padding=padding, dilation=dilation, groups=groups)
    return out.transpose(1, 2)
