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
kernel: the encoder's :class:`InitMode` for the conv encoders' kernels
(xavier uniform by default), lecun normal for ``Dense`` and the wav2vec2
modules (a module says so with ``kernel_init``).
Parameters stay float32; each module's ``dtype`` is its compute type, cast
at flax's cast points (conv input and kernel, batch norm's folded fast path
in bfloat16), with no autocast.

``train=True`` takes masked batch statistics (updating the running
statistics in place) and applies dropout with masks drawn from the
``generator`` passed down the call, after each activated repeat and after
each block, with flax's semantics.

:func:`checkpointed` is flax's ``nn.remat`` for a block or layer: its
activations are recomputed in the backward, with the same dropout masks and
kernel seeds (the explicit generator is replayed) and without moving the
running statistics a second time, so it changes no loss, gradient or
statistic. It also runs inside a CUDA graph of the train step
(:class:`RematStates`).

``EncoderBlock`` is the QuartzNet and Citrinet block: Citrinet's options
(the stride on the last repeat only, :class:`SqueezeExcite` after the conv
stack, a residual strided by ``stride`` rather than ``stride**repeat``) are
flags, off by default.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.utils.checkpoint
from torch import nn

from thunder_tpu_torch.ops.conv import conv1d, conv_output_length, get_same_padding
from thunder_tpu_torch.ops.masking import apply_mask, lengths_to_mask
from thunder_tpu_torch.parallel import spmd

__all__ = [
    "BN_EPS", "InitMode", "weight_init", "TorchBatchNorm", "MaskedConv1d", "ConvBnAct", "SqueezeExcite",
    "EncoderBlock", "Dense", "dense", "init_parameters", "dropout", "apply_dropout", "checkpointed", "recomputing",
    "run_block", "RematStates", "remat_states",
]

BN_EPS = 1e-3
BN_MOMENTUM = 0.1  # torch's convention: new = (1 - m) * old + m * batch


def apply_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax's ``nn.Dropout`` given its mask: kept values scaled by ``1 / (1 - rate)``, the rest 0."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Keep each value with probability ``1 - rate`` (mask drawn from ``generator``
    on ``x``'s device; ``F.dropout`` takes no generator). In a data-parallel step the mask is
    this rank's rows of the global batch's (:func:`~thunder_tpu_torch.parallel.spmd.draw_rows`)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode draws from an explicit torch.Generator; pass generator=")
    uniform = spmd.draw_rows(lambda shape: torch.rand(shape, generator=generator, device=x.device), x.shape)
    keep = uniform < (1.0 - rate)
    return apply_dropout(x, keep, rate)


_RECOMPUTING = contextvars.ContextVar("thunder_tpu_torch_recomputing", default=False)
_REMAT_STATES = contextvars.ContextVar("thunder_tpu_torch_remat_states", default=None)


def recomputing() -> bool:
    """Whether the running code is a :func:`checkpointed` block's recompute in the backward."""
    return _RECOMPUTING.get()


class RematStates:
    """The generator states that the :func:`checkpointed` blocks of one train step rewind to, for a CUDA graph of
    the step.

    A generator's host state cannot be read or set while a graph is captured, and a replay moves it without the
    host. So the graph's owner runs the step once eagerly under :func:`remat_states` with an empty
    ``RematStates``, which records in ``offsets`` the step generator's offset at each block's entry; then it
    captures the step with ``RematStates(generators)``: one generator a block, in the blocks' order, registered
    with the graph, whose state it sets before each replay to the step generator's at that block's entry (the
    seed, and the offset at the replay's start plus the block's share of the eager step's). A block's recompute
    draws from its generator through ``graphsafe_set_state``, so the step generator's own state moves as in the
    eager step."""

    def __init__(self, generators=()):
        self.offsets: list = []
        self._generators = iter(generators)

    def next_generator(self) -> torch.Generator:
        generator = next(self._generators, None)
        if generator is None:
            raise RuntimeError("more checkpointed blocks under capture than the eager step recorded")
        return generator


@contextlib.contextmanager
def remat_states(states: RematStates | None):
    """``with remat_states(states):`` the :func:`checkpointed` blocks of the step in the block record into, or draw
    their generators from, ``states``."""
    token = _REMAT_STATES.set(states)
    try:
        yield states
    finally:
        _REMAT_STATES.reset(token)


def checkpointed(block: nn.Module, *args, generator: torch.Generator | None = None, **kwargs):
    """``block(*args, generator=generator, **kwargs)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    block keeps none of its activations for the backward, which runs it a second time to recompute them.

    The recompute is the forward again, bit for bit:

    - ``checkpoint``'s own RNG stash covers only the default generators, and the port draws every dropout mask
      and training-kernel seed from the explicit ``generator``: its state on entering the block is set again
      for the recompute, and the state the backward found is put back after it (also when ``checkpoint``
      stops the recompute early);
    - the recompute runs with :func:`recomputing` true, so that :class:`TorchBatchNorm` does not move its
      running statistics a second time (flax's ``nn.remat`` keeps the forward's ``batch_stats`` update only).

    A generator's ``get_state``/``set_state`` are host operations (a CUDA generator's state is its seed and
    offset), so this adds no device synchronisation. Under CUDA graph capture the entry state is the block's
    generator of :class:`RematStates` and the swaps are ``graphsafe_get_state``/``graphsafe_set_state``. The
    recompute also runs in the forward's data-parallel step (:func:`~thunder_tpu_torch.parallel.spmd.rows`),
    which the backward may run outside of.
    """
    states = _REMAT_STATES.get()
    captured = generator is not None and generator.device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if captured:
        if states is None:
            raise RuntimeError("a checkpointed block under CUDA graph capture needs remat_states(RematStates(...))")
        entry = states.next_generator()
    else:
        entry = generator.get_state() if generator is not None else None
        if states is not None and generator is not None:
            states.offsets.append(generator.get_offset())
    step_rows = spmd.current_rows()
    runs = 0

    def run(*inputs):
        nonlocal runs
        runs += 1
        if runs == 1:
            return block(*inputs, generator=generator, **kwargs)
        if captured:
            resume = generator.graphsafe_get_state()
            generator.graphsafe_set_state(entry)
        else:
            resume = generator.get_state() if generator is not None else None
            if generator is not None:
                generator.set_state(entry)
        token = _RECOMPUTING.set(True)
        try:
            with spmd.rows(step_rows):
                return block(*inputs, generator=generator, **kwargs)
        finally:
            _RECOMPUTING.reset(token)
            if captured:
                generator.graphsafe_set_state(resume)
            elif generator is not None:
                generator.set_state(resume)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def run_block(block: nn.Module, *args, remat: bool, train: bool, generator: torch.Generator | None):
    """``block(*args, train=train, generator=generator)``, :func:`checkpointed` when ``remat`` applies: in train
    mode with gradients on (an eval or no-grad forward keeps nothing for a backward)."""
    if remat and train and torch.is_grad_enabled():
        return checkpointed(block, *args, train=True, generator=generator)
    return block(*args, train=train, generator=generator)


def _fans(w: torch.Tensor) -> tuple[int, int]:
    """flax's fans of a kernel whose last two axes are (in, out)."""
    receptive = math.prod(w.shape[:-2])
    return w.shape[-2] * receptive, w.shape[-1] * receptive


def _variance_scaling_(w: torch.Tensor, generator: torch.Generator, scale: float, mode: str,
                       distribution: str) -> None:
    """flax's ``variance_scaling(scale, mode, distribution)`` for a WIO kernel: variance ``scale / n``
    with ``n`` the fan-in or the mean of the fans; "normal" is an untruncated normal, "truncated_normal"
    a normal cut at 2 standard deviations and rescaled to that variance."""
    fan_in, fan_out = _fans(w)
    denominator = fan_in if mode == "fan_in" else (fan_in + fan_out) / 2
    with torch.no_grad():
        if distribution == "uniform":
            limit = math.sqrt(3.0 * scale / denominator)
            w.copy_((torch.rand(w.shape, generator=generator, dtype=torch.float32) * 2.0 - 1.0) * limit)
        elif distribution == "normal":
            w.copy_(torch.randn(w.shape, generator=generator, dtype=torch.float32) * math.sqrt(scale / denominator))
        else:
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.mul_(math.sqrt(scale / denominator) / 0.87962566103423978)


class InitMode:
    """The conv encoders' weight init schemes (the JAX package's ``InitMode``)."""

    xavier_uniform = "xavier_uniform"
    xavier_normal = "xavier_normal"
    kaiming_uniform = "kaiming_uniform"
    kaiming_normal = "kaiming_normal"


#: ``InitMode`` name -> ``variance_scaling`` arguments (kaiming: the ReLU gain, fan_in)
_INIT_MODES = {
    InitMode.xavier_uniform: (1.0, "fan_avg", "uniform"),
    InitMode.xavier_normal: (1.0, "fan_avg", "normal"),
    InitMode.kaiming_uniform: (2.0, "fan_in", "uniform"),
    InitMode.kaiming_normal: (2.0, "fan_in", "normal"),
}


def _initializer(name: str):
    """``init(weight, generator)`` for an ``InitMode`` name or ``"lecun_normal"``, flax's ``nn.Dense`` default."""
    scale, fan, distribution = (1.0, "fan_in", "truncated_normal") if name == "lecun_normal" else _INIT_MODES[name]
    return lambda w, generator: _variance_scaling_(w, generator, scale, fan, distribution)


def weight_init(mode: str = InitMode.xavier_uniform):
    """The initializer of an ``InitMode`` name: ``init(weight, generator)`` fills a WIO kernel in place.

    Raises:
        ValueError: for a name that is not an ``InitMode``, as the JAX package does.
    """
    if mode not in _INIT_MODES:
        raise ValueError(f"Unknown Initialization mode: {mode}")
    return _initializer(mode)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every kernel in registration order (each with its module's
    ``kernel_init``, xavier uniform by default) and each parameter a module
    names in ``normal_parameters`` (from a standard normal); zero biases, unit
    BN scales and identity running statistics. Norm layers keep the ones and
    zeros they are built with."""
    for m in module.modules():
        for name in getattr(m, "normal_parameters", ()):
            if getattr(m, name, None) is not None:
                with torch.no_grad():
                    getattr(m, name).normal_(generator=generator)
        if hasattr(m, "kernel"):
            _initializer(getattr(m, "kernel_init", InitMode.xavier_uniform))(m.kernel, generator)
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
    the GEMM's epilogue. ``use_bias=False`` (flax's) leaves the module
    without a ``bias`` parameter, as flax's tree has none.
    """

    kernel_init = "lecun_normal"

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spmd.column_parallel(dense, x, self.kernel, self.bias, self.dtype)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """:class:`Dense`'s math: ``x @ kernel + bias`` in ``dtype`` over a flattened ``(rows, in)`` view."""
    x2 = x.reshape(-1, x.shape[-1]).to(dtype)
    kernel = kernel.to(dtype)
    y = torch.matmul(x2, kernel) if bias is None else torch.addmm(bias.to(dtype), x2, kernel)
    return y.reshape(*x.shape[:-1], y.shape[-1])


class TorchBatchNorm(nn.Module):
    """Batch norm over the last axis with torch's running-statistics semantics.

    Train mode normalises with the biased batch variance over the valid frames
    (``mask``, ``(batch, time)``) and moves the running statistics by momentum
    0.1 towards the batch mean and the unbiased variance (``n`` = valid
    frames). In bfloat16 both modes take the one-pass fast path of the JAX
    module: E[x] and E[x^2] in float32 from bf16 reads, the variance clipped
    at 0, and normalisation and affine folded into ``x * a + b``.

    In a data-parallel step (:func:`~thunder_tpu_torch.parallel.spmd.rows`)
    the batch statistics are the global batch's: the sums go through one
    autograd-aware sum over the data group a pass (float32: ``(n, sum x)``,
    then ``sum (x - mean)^2``; bfloat16: ``(n, sum x, sum x^2)`` at once), so
    the running statistics move alike on every rank. Channel-sharded
    parameters and statistics are gathered at their use, and each rank moves
    its own slice of the running statistics.
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
        """``(n, mean, var)`` over every axis but the last, restricted to ``mask`` (all of ``x`` without one), and
        over the global batch in a data-parallel step."""
        dims = tuple(range(x.ndim - 1))
        if mask is None:
            mask = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        count = mask.sum(dtype=torch.float32)
        if fast:
            x = torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
            sums = (x.sum(dim=dims, dtype=torch.float32), x.square().sum(dim=dims, dtype=torch.float32))
            if spmd.current_rows() is not None:
                count, *sums = spmd.data_sum(torch.cat([count[None], *sums])).split([1, x.shape[-1], x.shape[-1]])
                count = count[0]
            n = count.clamp_min(1.0)
            mean = sums[0] / n
            return n, mean, (sums[1] / n - mean.square()).clamp_min(0.0)
        xf, m = x.float(), mask.float()[..., None]
        total = (xf * m).sum(dim=dims)
        if spmd.current_rows() is not None:
            count, total = spmd.data_sum(torch.cat([count[None], total])).split([1, x.shape[-1]])
            count = count[0]
        n = count.clamp_min(1.0)
        mean = total / n
        return n, mean, spmd.data_sum(((xf - mean).square() * m).sum(dim=dims)) / n

    def forward(self, x: torch.Tensor, train: bool = False, mask: torch.Tensor | None = None) -> torch.Tensor:
        fast = self.dtype == torch.bfloat16
        scale, bias = spmd.gathered(self.scale), spmd.gathered(self.bias)
        if train:
            n, mean, var = self._batch_statistics(x, mask, fast)
            # in place, PyTorch's counterpart of flax's mutable=["batch_stats"]; once a step, not again in a
            # checkpointed block's recompute
            if not recomputing():
                with torch.no_grad():
                    unbiased = var * (n / (n - 1).clamp_min(1.0))
                    shard = spmd.shard_of(self.mean)
                    if shard is not None:
                        mean_l, unbiased = spmd.local_slice(mean, shard), spmd.local_slice(unbiased, shard)
                    else:
                        mean_l = mean
                    self.mean.copy_((1 - BN_MOMENTUM) * self.mean + BN_MOMENTUM * mean_l)
                    self.var.copy_((1 - BN_MOMENTUM) * self.var + BN_MOMENTUM * unbiased)
        else:
            mean, var = spmd.gathered(self.mean), spmd.gathered(self.var)
        if fast:
            a = scale * torch.rsqrt(var + self.epsilon)
            b = bias - mean * a
            return x * a.to(self.dtype) + b.to(self.dtype)
        y = (x.float() - mean) * torch.rsqrt(var + self.epsilon)
        return (y * scale + bias).to(self.dtype)


class MaskedConv1d(nn.Module):
    """1-D conv with same padding that zero-fills beyond ``lengths`` before
    convolving and returns the post-conv lengths; its kernel is drawn with
    ``init_mode`` (an :class:`InitMode`)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        dilation: int = 1,
        groups: int = 1,
        use_bias: bool = False,
        init_mode: str = InitMode.xavier_uniform,
        dtype=torch.float32,
    ):
        super().__init__()
        weight_init(init_mode)  # an unknown name raises here, at construction, as in flax
        self.kernel_size, self.stride, self.dilation, self.groups = kernel_size, stride, dilation, groups
        self.kernel_init = init_mode
        self.dtype = dtype
        self.padding = get_same_padding(kernel_size, stride, dilation)
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_features // groups, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _conv(self, x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        bias = None if bias is None else bias.to(self.dtype)
        return conv1d(x, kernel.to(self.dtype), bias, stride=self.stride, padding=self.padding,
                      dilation=self.dilation, groups=self.groups)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        x = apply_mask(x, lengths).to(self.dtype)
        if self.groups == 1:  # a dense conv: column-parallel over sharded output channels
            y = spmd.column_parallel(self._conv, x, self.kernel, self.bias)
        else:
            y = self._conv(x, spmd.gathered(self.kernel), spmd.gathered(self.bias))
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
        init_mode: str = InitMode.xavier_uniform,
        dtype=torch.float32,
    ):
        super().__init__()
        self.separable = separable
        self.activation = activation
        self.dropout = dropout
        kw = dict(init_mode=init_mode, dtype=dtype)
        if separable:
            self.depthwise = MaskedConv1d(in_features, in_features, kernel_size, stride, dilation, groups=in_features,
                                          **kw)
            self.pointwise = MaskedConv1d(in_features, features, 1, **kw)
        else:
            self.conv = MaskedConv1d(in_features, features, kernel_size, stride, dilation, **kw)
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


class SqueezeExcite(nn.Module):
    """Citrinet's channel gate from a global average pool masked by ``lengths``.

    The pool sums the valid frames (in float32) and divides by ``max(count,
    1)``, as the JAX module does where the PyTorch original pools the padded
    axis too; then ``fc1`` (C -> C / ``reduction_ratio``, no bias), ReLU,
    ``fc2`` (no bias) and a sigmoid gate ``x``, in ``dtype`` (the ``Dense``
    layers cast their input, flax's cast points).
    """

    def __init__(self, channels: int, reduction_ratio: int = 8, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(channels, channels // reduction_ratio, use_bias=False, dtype=dtype)
        self.fc2 = Dense(channels // reduction_ratio, channels, use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        mask = lengths_to_mask(lengths, x.shape[1])[:, :, None]
        count = mask.sum(dim=1, dtype=torch.float32).clamp_min(1.0)
        pooled = torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum(dim=1, dtype=torch.float32)
        gate = torch.sigmoid(self.fc2(torch.relu(self.fc1(pooled / count))))
        return x * gate[:, None, :].to(x.dtype)


class EncoderBlock(nn.Module):
    """The QuartzNet and Citrinet residual block: ``repeat`` x (conv -> bn ->
    relu -> dropout), the last repeat without activation, an optional
    squeeze-excite, an optional 1x1 conv-bn residual from the block input,
    then a final ReLU and dropout.

    Citrinet's options, off by default (QuartzNet):

    - ``stride_last_only``: only the last repeat strides (each repeat's same
      padding is that of its own stride);
    - ``squeeze_excite``: :class:`SqueezeExcite` (``se_reduction_ratio``)
      after the conv stack, before the residual add;
    - ``residual_stride_pow``: the residual strides by ``stride**repeat``
      when true (QuartzNet), by ``stride`` when false (Citrinet).

    The residual's stride must meet the repeats': with ``stride > 1`` and
    ``repeat > 1``, ``stride_last_only`` goes with ``residual_stride_pow=False``
    and the other way round; the two mismatched pairings raise ``ValueError``.
    """

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
        stride_last_only: bool = False,
        squeeze_excite: bool = False,
        se_reduction_ratio: int = 8,
        residual_stride_pow: bool = True,
        init_mode: str = InitMode.xavier_uniform,
        dtype=torch.float32,
    ):
        super().__init__()
        if residual and stride > 1 and repeat > 1 and stride_last_only == residual_stride_pow:
            raise ValueError(
                f"EncoderBlock: stride_last_only={stride_last_only} with residual_stride_pow={residual_stride_pow} "
                f"gives the residual a stride of {stride**repeat if residual_stride_pow else stride} and the repeats "
                f"one of {stride if stride_last_only else stride**repeat}"
            )
        self.repeat = repeat
        self.dropout = dropout
        for r in range(repeat):
            last = r == repeat - 1
            rep = ConvBnAct(
                in_features if r == 0 else features,
                features,
                kernel_size,
                stride=stride if last or not stride_last_only else 1,
                dilation=dilation,
                separable=separable,
                activation=not last,
                dropout=dropout,
                init_mode=init_mode,
                dtype=dtype,
            )
            self.add_module(f"rep{r}", rep)
        self.se = SqueezeExcite(features, se_reduction_ratio, dtype=dtype) if squeeze_excite else None
        self.res = None
        if residual:
            res_stride = 1 if stride == 1 else stride**repeat if residual_stride_pow else stride
            self.res = ConvBnAct(in_features, features, 1, stride=res_stride, activation=False, init_mode=init_mode,
                                 dtype=dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False, generator=None):
        out, out_lengths = x, lengths
        for r in range(self.repeat):
            out, out_lengths = getattr(self, f"rep{r}")(out, out_lengths, train=train, generator=generator)
        if self.se is not None:
            out = self.se(out, out_lengths)
        if self.res is not None:
            res, _ = self.res(x, lengths, train=train)
            out = out + res
        out = torch.relu(out)
        if train:
            out = dropout(out, self.dropout, generator)
        return out, out_lengths
