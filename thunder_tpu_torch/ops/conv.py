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

    A bfloat16 convolution on the CPU runs in float32 and rounds its output to bfloat16: PyTorch's CPU bfloat16
    convolution returns wrong values at some shapes (up to 8 input channels a group with a kernel of 16 or 32:
    off by about the output's own scale in torch 2.13), where the float32 product with one rounding is what a
    float32-accumulating convolution gives.
    """
    weight = kernel.permute(2, 1, 0)  # WIO -> torch's OIW
    conv = lambda a, w, b: F.conv1d(a.transpose(1, 2), w, b, stride=stride, padding=padding,  # noqa: E731
                                    dilation=dilation, groups=groups)
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        out = conv(x.float(), weight.float(), None if bias is None else bias.float()).to(x.dtype)
    else:
        out = conv(x, weight, bias)
    return out.transpose(1, 2)
