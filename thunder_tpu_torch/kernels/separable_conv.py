"""One separable conv repeat in one pass: a CUDA kernel and its plain version.

Port of ``thunder_tpu/kernels/separable_conv.py::fused_separable_conv`` and
``thunder_tpu/kernels/repeat_tm.py::fused_repeat_tm``; one kernel,
``csrc/separable_repeat.cu``, meets both contracts. For each output frame it
computes

    depthwise conv (k taps, stride, dilation, same padding, f32 sum)
      -> rounded to the activation dtype
      -> pointwise product with the (BN-folded) weights, f32 accumulation
      -> + folded-BN bias, optional ReLU, zero beyond ``out_lengths``

channels-last ``(batch, time, channels)``. The input must already be zero
beyond each row's valid length (the engine keeps that invariant), as for the
TPU kernels. The time-major layout and tile shapes of the TPU kernels are not
ported: they were TPU layout workarounds and do not change the result.

The kernel reads 16 bytes at a time, so the wrapper pads channel counts that
are not multiples of 8 with zeros (:func:`pad_channels`) and slices the
output; an input too wide for one block's A tile runs as a few launches over
slices of its channels (:func:`separable_plan`'s ``parts``), and a span too
long for even 64 channels beside their A tile (k past 560 at dilation 2) as
launches over slices of its taps (``tap_slices``), which carry the float32
depthwise sums from one to the next in a workspace, so that the result is the
one launch's.

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`separable_repeat_reference`) only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from thunder_tpu_torch.kernels import _build
from thunder_tpu_torch.ops.conv import conv_output_length, get_same_padding
from thunder_tpu_torch.ops.masking import lengths_to_mask

__all__ = ["fused_separable_repeat", "separable_repeat_reference", "output_length", "separable_plan",
           "pad_channels"]


def output_length(time: int, kernel_size: int, stride: int = 1, dilation: int = 1) -> int:
    """Frames out of a same-padded conv over ``time`` frames."""
    pad = get_same_padding(kernel_size, stride, dilation)
    return int(conv_output_length(time, kernel_size, stride, pad, dilation))


def separable_repeat_reference(
    x: torch.Tensor,
    out_lengths: torch.Tensor,
    dw: torch.Tensor,
    pw: torch.Tensor,
    bias: torch.Tensor,
    kernel_size: int,
    stride: int = 1,
    dilation: int = 1,
    relu: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version, with the kernel's rounding points.

    ``x`` ``(B, T, C_in)``, ``dw`` ``(k, C_in)``, ``pw`` ``(C_in, C_out)``,
    ``bias`` ``(C_out,)`` float32, ``out_lengths`` ``(B,)``. Returns ``(B,
    T_out, C_out)`` in ``x.dtype``. On the card, set
    ``torch.backends.cudnn.allow_tf32 = False`` first: the depthwise conv
    goes through cuDNN, whose float32 default is TF32.
    """
    pad = get_same_padding(kernel_size, stride, dilation)
    c_in = x.shape[-1]
    weight = dw.float().t().unsqueeze(1)  # (C_in, 1, k)
    y = F.conv1d(x.float().transpose(1, 2), weight, stride=stride, padding=pad, dilation=dilation, groups=c_in)
    y = y.transpose(1, 2).to(x.dtype).float()
    z = torch.matmul(y, pw.float()) + bias.float()
    if relu:
        z = torch.clamp_min(z, 0.0)
    mask = lengths_to_mask(out_lengths, z.shape[1])[:, :, None]
    return torch.where(mask, z, 0.0).to(x.dtype)


@functools.lru_cache(maxsize=None)
def separable_plan(c_in: int, kernel_size: int, stride: int = 1, dilation: int = 1) -> dict:
    """The kernel's launch plan on the current card for these widths: shared memory per block
    (``smem_bytes``, 0 when not even 64 channels' input span over 8 taps fits in 227 KB), weight-ring stages
    per warpgroup, whether the first weight boxes are requested before the depthwise (``prefetch``), the
    resident blocks per SM (``blocks_per_sm``), the launches over slices of ``c_in`` (``parts``, 1 unless
    the A tile of all of ``c_in`` does not fit) of ``part`` channels each, the launches over slices of the
    taps (``tap_slices``, 1 unless the span of all ``kernel_size`` taps does not fit beside 64 channels) of
    ``taps`` taps each, and ``launches`` in all. Builds the kernels on first use."""
    out = (ctypes.c_int * 8)()
    _build.check(_build.load().thunder_separable_repeat_plan(c_in, kernel_size, stride, dilation, out),
                 "thunder_separable_repeat_plan")
    return {"smem_bytes": out[0], "stages": out[1], "prefetch": bool(out[2]), "blocks_per_sm": out[3],
            "parts": out[4], "part": out[5], "taps": out[6], "tap_slices": out[7], "launches": out[4] * out[7]}


def pad_channels(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, bias: torch.Tensor):
    """``(x, dw, pw, bias)`` with C_in and C_out zero-padded to multiples of 8. A padded input channel has
    zero taps and zero weights and a padded output channel zero weights and bias, so the repeat's first
    C_out output channels are unchanged."""
    pad_in, pad_out = -x.shape[-1] % 8, -pw.shape[1] % 8
    return F.pad(x, (0, pad_in)), F.pad(dw, (0, pad_in)), F.pad(pw, (0, pad_out, 0, pad_in)), F.pad(bias, (0, pad_out))


def _check(x, out_lengths, dw, pw, bias, kernel_size):
    c_in = x.shape[-1]
    if x.ndim != 3 or dw.shape != (kernel_size, c_in) or pw.ndim != 2 or pw.shape[0] != c_in:
        raise ValueError(
            f"separable repeat shapes: x {tuple(x.shape)}, dw {tuple(dw.shape)}, pw {tuple(pw.shape)}, k={kernel_size}"
        )
    if bias.shape != (pw.shape[1],) or out_lengths.shape != (x.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} / out_lengths {tuple(out_lengths.shape)} do not fit")


def fused_separable_repeat(
    x: torch.Tensor,
    out_lengths: torch.Tensor,
    dw: torch.Tensor,
    pw: torch.Tensor,
    bias: torch.Tensor,
    kernel_size: int,
    stride: int = 1,
    dilation: int = 1,
    relu: bool = True,
) -> torch.Tensor:
    """One separable repeat, BN pre-folded into ``pw`` and ``bias``.

    Args:
        x: ``(batch, time, C_in)``, zero beyond each row's input length.
        out_lengths: ``(batch,)`` int32 valid output frames; the output is
            exactly zero beyond them.
        dw: ``(kernel_size, C_in)`` depthwise taps.
        pw: ``(C_in, C_out)`` pointwise weights with the BN scale folded in.
        bias: ``(C_out,)`` float32 folded-BN bias.

    On the card: bfloat16 ``x``/``dw``/``pw``. Channel counts that are not
    multiples of 8 are padded with zeros (:func:`pad_channels`), an input
    whose A tile of 64 frames does not fit in shared memory (about 1,500
    channels at k = 33) runs as ``separable_plan(...)["parts"]`` launches, and
    a span too long for 64 channels as ``tap_slices`` times as many; a span
    too long for even 8 taps (a dilation past about 240) raises.

    Returns:
        ``(batch, time_out, C_out)`` in ``x.dtype``.
    """
    _check(x, out_lengths, dw, pw, bias, kernel_size)
    if x.device.type == "cpu":
        return separable_repeat_reference(x, out_lengths, dw, pw, bias, kernel_size, stride, dilation, relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_separable_repeat runs on cuda or cpu tensors, got {x.device}")
    if x.dtype != torch.bfloat16 or dw.dtype != torch.bfloat16 or pw.dtype != torch.bfloat16:
        raise ValueError("the separable repeat kernel takes bfloat16 x, dw and pw")
    if bias.dtype != torch.float32 or out_lengths.dtype != torch.int32:
        raise ValueError("the separable repeat kernel takes float32 bias and int32 out_lengths")
    for name, t in (("x", x), ("dw", dw), ("pw", pw), ("bias", bias), ("out_lengths", out_lengths)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {x.device}")
        if name in ("x", "dw", "pw") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel loads it 16 bytes at a time)")
    batch, time, c_in = x.shape
    c_out = pw.shape[1]
    if c_in % 8 or c_out % 8:
        x, dw, pw, bias = pad_channels(x, dw, pw, bias)
        out = fused_separable_repeat(x, out_lengths, dw, pw, bias, kernel_size, stride, dilation, relu)
        return out[..., :c_out].contiguous()
    pad = get_same_padding(kernel_size, stride, dilation)
    t_out = output_length(time, kernel_size, stride, dilation)
    if batch < 1 or t_out < 1:
        raise ValueError(f"the separable repeat kernel takes a non-empty batch, got {tuple(x.shape)}")
    plan = separable_plan(c_in, kernel_size, stride, dilation)
    if plan["smem_bytes"] == 0:
        raise ValueError(
            f"the separable repeat kernel's input span (k={kernel_size}, stride {stride}, dilation {dilation}) does "
            "not fit in one block's 227 KB of shared memory beside even 64 channels' A tile over 8 taps"
        )
    out = torch.empty((batch, t_out, c_out), dtype=x.dtype, device=x.device)
    workspace = lambda needed, c: (torch.empty((batch, t_out, c), dtype=torch.float32, device=x.device)  # noqa: E731
                                   if needed else None)
    partial, dw_sum = workspace(plan["parts"] > 1, c_out), workspace(plan["tap_slices"] > 1, c_in)
    lib = _build.load()
    status = lib.thunder_separable_repeat(
        x.data_ptr(), dw.data_ptr(), pw.data_ptr(), bias.data_ptr(), out_lengths.data_ptr(), out.data_ptr(),
        0 if partial is None else partial.data_ptr(), 0 if dw_sum is None else dw_sum.data_ptr(), batch, time, t_out,
        c_in, c_out, kernel_size, stride, dilation, pad, int(relu), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "thunder_separable_repeat")
    fused_separable_repeat.launches += plan["launches"]
    return out


fused_separable_repeat.launches = 0
