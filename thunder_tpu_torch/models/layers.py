"""Shared building blocks of the conv encoders, as ``nn.Module``s (eval path).

Port of ``thunder_tpu/models/layers.py``. The layout and the variable names
follow the flax modules so that weights map one to one (see ``bridge.py``):

- channels-last ``(batch, time, channels)`` activations and ``(tensor,
  lengths)`` pairs;
- conv kernels in WIO layout ``(kernel_size, in_channels // groups,
  out_channels)``, named ``kernel`` (and ``bias``);
- batch norm as ``scale``/``bias`` parameters and ``mean``/``var`` running
  statistics, eps 1e-3.

Parameters are allocated at construction and drawn by :func:`init_parameters`
from an explicit ``torch.Generator``. Training (batch statistics, dropout)
waits for a later slice: ``train=True`` raises.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from thunder_tpu_torch.ops.conv import conv1d, conv_output_length, get_same_padding
from thunder_tpu_torch.ops.masking import apply_mask

__all__ = ["BN_EPS", "TorchBatchNorm", "MaskedConv1d", "ConvBnAct", "EncoderBlock", "init_parameters"]

BN_EPS = 1e-3
_TRAIN_TODO = "training mode waits for ROADMAP item A7 (QuartzNet training)"


def _xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``variance_scaling(1.0, "fan_avg", "uniform")`` for a WIO kernel."""
    receptive = math.prod(w.shape[:-2])
    fan_in, fan_out = w.shape[-2] * receptive, w.shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=generator, dtype=torch.float32) * 2.0 - 1.0) * limit)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv kernel (xavier uniform) in registration order; zero biases,
    unit BN scales and identity running statistics."""
    for m in module.modules():
        if hasattr(m, "kernel"):
            _xavier_uniform_(m.kernel, generator)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, TorchBatchNorm):
            nn.init.ones_(m.scale)
            nn.init.zeros_(m.bias)
            m.mean.zero_()
            m.var.fill_(1.0)


class TorchBatchNorm(nn.Module):
    """Batch norm over the last axis with running statistics (eval only)."""

    def __init__(self, features: int, epsilon: float = BN_EPS):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(f"TorchBatchNorm: {_TRAIN_TODO}")
        y = (x.float() - self.mean) * torch.rsqrt(self.var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


class MaskedConv1d(nn.Module):
    """1-D conv with same padding that zero-fills beyond ``lengths`` before
    convolving and returns the post-conv lengths."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        dilation: int = 1,
        groups: int = 1,
        use_bias: bool = False,
    ):
        super().__init__()
        self.kernel_size, self.stride, self.dilation, self.groups = kernel_size, stride, dilation, groups
        self.padding = get_same_padding(kernel_size, stride, dilation)
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_features // groups, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        x = apply_mask(x, lengths)
        y = conv1d(
            x, self.kernel, self.bias, stride=self.stride, padding=self.padding, dilation=self.dilation, groups=self.groups
        )
        return y, conv_output_length(lengths, self.kernel_size, self.stride, self.padding, self.dilation)


class ConvBnAct(nn.Module):
    """(separable) conv -> batch norm -> optional ReLU, with lengths.

    ``separable=True`` is depthwise(k, groups=C_in) then pointwise(1x1), the
    time-channel-separable convolution of QuartzNet.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        dilation: int = 1,
        separable: bool = False,
        activation: bool = True,
    ):
        super().__init__()
        self.separable = separable
        self.activation = activation
        if separable:
            self.depthwise = MaskedConv1d(in_features, in_features, kernel_size, stride, dilation, groups=in_features)
            self.pointwise = MaskedConv1d(in_features, features, 1)
        else:
            self.conv = MaskedConv1d(in_features, features, kernel_size, stride, dilation)
        self.bn = TorchBatchNorm(features)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False):
        if self.separable:
            x, lengths = self.depthwise(x, lengths)
            x, lengths = self.pointwise(x, lengths)
        else:
            x, lengths = self.conv(x, lengths)
        x = self.bn(x, train=train)
        if self.activation:
            x = torch.relu(x)
        return x, lengths


class EncoderBlock(nn.Module):
    """The QuartzNet residual block: ``repeat`` x (conv -> bn -> relu), the last
    repeat without activation, an optional 1x1 conv-bn residual from the block
    input, then a final ReLU."""

    def __init__(
        self,
        in_features: int,
        features: int,
        repeat: int = 5,
        kernel_size: int = 11,
        stride: int = 1,
        dilation: int = 1,
        residual: bool = True,
        separable: bool = False,
    ):
        super().__init__()
        self.repeat = repeat
        for r in range(repeat):
            rep = ConvBnAct(
                in_features if r == 0 else features,
                features,
                kernel_size,
                stride=stride,
                dilation=dilation,
                separable=separable,
                activation=r != repeat - 1,
            )
            self.add_module(f"rep{r}", rep)
        self.res = None
        if residual:
            res_stride = 1 if stride == 1 else stride**repeat
            self.res = ConvBnAct(in_features, features, 1, stride=res_stride, activation=False)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False):
        out, out_lengths = x, lengths
        for r in range(self.repeat):
            out, out_lengths = getattr(self, f"rep{r}")(out, out_lengths, train=train)
        if self.res is not None:
            res, _ = self.res(x, lengths, train=train)
            out = out + res
        return torch.relu(out), out_lengths
