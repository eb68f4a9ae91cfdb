"""Shared building blocks of the conv encoders, as ``nn.Module``s.

Port of ``thunder_tpu/models/layers.py``. The layout and the variable names
follow the flax modules so that weights map one to one (see ``bridge.py``):

- channels-last ``(batch, time, channels)`` activations and ``(tensor,
  lengths)`` pairs;
- conv kernels in WIO layout ``(kernel_size, in_channels // groups,
  out_channels)``, named ``kernel`` (and ``bias``);
- batch norm as ``scale``/``bias`` parameters and ``mean``/``var`` running
  statistics, eps 1e-3.

Parameters are allocated at construction and drawn by :func:`init_parameters`
from an explicit ``torch.Generator``, with the initializer flax gives each
kernel: xavier uniform for the conv encoders' kernels, lecun normal for
``Dense`` and the wav2vec2 modules (a module says so with ``kernel_init``).
Parameters stay float32; each module's ``dtype`` is its compute type, cast
at flax's cast points (conv input and kernel, batch norm's folded fast path
in bfloat16), with no autocast.

``train=True`` takes masked batch statistics (updating the running
statistics in place) and applies dropout with masks drawn from the
``generator`` passed down the call, after each activated repeat and after
each block, with flax's semantics.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from thunder_tpu_torch.ops.conv import conv1d, conv_output_length, get_same_padding
from thunder_tpu_torch.ops.masking import apply_mask, lengths_to_mask

__all__ = [
    "BN_EPS", "TorchBatchNorm", "MaskedConv1d", "ConvBnAct", "EncoderBlock", "Dense", "init_parameters", "dropout",
    "apply_dropout",
]

BN_EPS = 1e-3
BN_MOMENTUM = 0.1  # torch's convention: new = (1 - m) * old + m * batch


def apply_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax's ``nn.Dropout`` given its mask: kept values scaled by ``1 / (1 - rate)``, the rest 0."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Keep each value with probability ``1 - rate`` (mask drawn from ``generator``
    on ``x``'s device; ``F.dropout`` takes no generator)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode draws from an explicit torch.Generator; pass generator=")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
    return apply_dropout(x, keep, rate)


def _fans(w: torch.Tensor) -> tuple[int, int]:
    """flax's fans of a kernel whose last two axes are (in, out)."""
    receptive = math.prod(w.shape[:-2])
    return w.shape[-2] * receptive, w.shape[-1] * receptive


def _xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``variance_scaling(1.0, "fan_avg", "uniform")`` for a WIO kernel."""
    fan_in, fan_out = _fans(w)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=generator, dtype=torch.float32) * 2.0 - 1.0) * limit)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: ``variance_scaling(1.0, "fan_in", "truncated_normal")``, a
    normal cut at 2 standard deviations and rescaled to variance ``1 / fan_in``."""
    fan_in, _ = _fans(w)
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)


_KERNEL_INITS = {"xavier_uniform": _xavier_uniform_, "lecun_normal": _lecun_normal_}


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every kernel in registration order (each with its module's
    ``kernel_init``, xavier uniform by default); zero biases, unit BN scales and
    identity running statistics. Norm layers keep the ones and zeros they are
    built with."""
    for m in module.modules():
        if hasattr(m, "kernel"):
            _KERNEL_INITS[getattr(m, "kernel_init", "xavier_uniform")](m.kernel, generator)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, TorchBatchNorm):
            nn.init.ones_(m.scale)
            nn.init.zeros_(m.bias)
            m.mean.zero_()
            m.var.fill_(1.0)


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``x @ kernel + bias`` over the last axis, kernel ``(in, out)``.

    Input, kernel and bias are cast to ``dtype`` (flax's ``promote_dtype``);
    the product runs over a flattened ``(rows, in)`` view with the bias in
    the GEMM's epilogue.
    """

    kernel_init = "lecun_normal"

    def __init__(self, in_features: int, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1]).to(self.dtype)
        y = torch.addmm(self.bias.to(self.dtype), x2, self.kernel.to(self.dtype))
        return y.reshape(*x.shape[:-1], y.shape[-1])


class TorchBatchNorm(nn.Module):
    """Batch norm over the last axis with torch's running-statistics semantics.

    Train mode normalises with the biased batch variance over the valid frames
    (``mask``, ``(batch, time)``) and moves the running statistics by momentum
    0.1 towards the batch mean and the unbiased variance (``n`` = valid
    frames). In bfloat16 both modes take the one-pass fast path of the JAX
    module: E[x] and E[x^2] in float32 from bf16 reads, the variance clipped
    at 0, and normalisation and affine folded into ``x * a + b``.
    """

    def __init__(self, features: int, epsilon: float = BN_EPS, dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def _batch_statistics(self, x: torch.Tensor, mask: torch.Tensor | None, fast: bool):
        """``(n, mean, var)`` over every axis but the last, restricted to ``mask`` (all of ``x`` without one)."""
        dims = tuple(range(x.ndim - 1))
        if mask is None:
            mask = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        n = mask.sum(dtype=torch.float32).clamp_min(1.0)
        if fast:
            x = torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
            mean = x.sum(dim=dims, dtype=torch.float32) / n
            return n, mean, (x.square().sum(dim=dims, dtype=torch.float32) / n - mean.square()).clamp_min(0.0)
        xf, m = x.float(), mask.float()[..., None]
        mean = (xf * m).sum(dim=dims) / n
        return n, mean, ((xf - mean).square() * m).sum(dim=dims) / n

    def forward(self, x: torch.Tensor, train: bool = False, mask: torch.Tensor | None = None) -> torch.Tensor:
        fast = self.dtype == torch.bfloat16
        if train:
            n, mean, var = self._batch_statistics(x, mask, fast)
            # in place, PyTorch's counterpart of flax's mutable=["batch_stats"]
            with torch.no_grad():
                unbiased = var * (n / (n - 1).clamp_min(1.0))
                self.mean.copy_((1 - BN_MOMENTUM) * self.mean + BN_MOMENTUM * mean)
                self.var.copy_((1 - BN_MOMENTUM) * self.var + BN_MOMENTUM * unbiased)
        else:
            mean, var = self.mean, self.var
        if fast:
            a = self.scale * torch.rsqrt(var + self.epsilon)
            b = self.bias - mean * a
            return x * a.to(self.dtype) + b.to(self.dtype)
        y = (x.float() - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(self.dtype)


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
        dtype=torch.float32,
    ):
        super().__init__()
        self.kernel_size, self.stride, self.dilation, self.groups = kernel_size, stride, dilation, groups
        self.dtype = dtype
        self.padding = get_same_padding(kernel_size, stride, dilation)
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_features // groups, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        x = apply_mask(x, lengths).to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = conv1d(x, self.kernel.to(self.dtype), bias, stride=self.stride, padding=self.padding,
                   dilation=self.dilation, groups=self.groups)
        return y, conv_output_length(lengths, self.kernel_size, self.stride, self.padding, self.dilation)


class ConvBnAct(nn.Module):
    """(separable) conv -> batch norm -> optional ReLU and dropout, with lengths.

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
        dropout: float = 0.0,
        dtype=torch.float32,
    ):
        super().__init__()
        self.separable = separable
        self.activation = activation
        self.dropout = dropout
        if separable:
            self.depthwise = MaskedConv1d(in_features, in_features, kernel_size, stride, dilation, groups=in_features,
                                          dtype=dtype)
            self.pointwise = MaskedConv1d(in_features, features, 1, dtype=dtype)
        else:
            self.conv = MaskedConv1d(in_features, features, kernel_size, stride, dilation, dtype=dtype)
        self.bn = TorchBatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False, generator=None):
        if self.separable:
            x, lengths = self.depthwise(x, lengths)
            x, lengths = self.pointwise(x, lengths)
        else:
            x, lengths = self.conv(x, lengths)
        x = self.bn(x, train=train, mask=lengths_to_mask(lengths, x.shape[1]) if train else None)
        if self.activation:
            x = torch.relu(x)
            if train:
                x = dropout(x, self.dropout, generator)
        return x, lengths


class EncoderBlock(nn.Module):
    """The QuartzNet residual block: ``repeat`` x (conv -> bn -> relu -> dropout),
    the last repeat without activation, an optional 1x1 conv-bn residual from
    the block input, then a final ReLU and dropout."""

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
        dropout: float = 0.0,
        dtype=torch.float32,
    ):
        super().__init__()
        self.repeat = repeat
        self.dropout = dropout
        for r in range(repeat):
            rep = ConvBnAct(
                in_features if r == 0 else features,
                features,
                kernel_size,
                stride=stride,
                dilation=dilation,
                separable=separable,
                activation=r != repeat - 1,
                dropout=dropout,
                dtype=dtype,
            )
            self.add_module(f"rep{r}", rep)
        self.res = None
        if residual:
            res_stride = 1 if stride == 1 else stride**repeat
            self.res = ConvBnAct(in_features, features, 1, stride=res_stride, activation=False, dtype=dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False, generator=None):
        out, out_lengths = x, lengths
        for r in range(self.repeat):
            out, out_lengths = getattr(self, f"rep{r}")(out, out_lengths, train=train, generator=generator)
        if self.res is not None:
            res, _ = self.res(x, lengths, train=train)
            out = out + res
        out = torch.relu(out)
        if train:
            out = dropout(out, self.dropout, generator)
        return out, out_lengths
