"""Residual add + LayerNorm in one pass: a CUDA kernel and its plain version.

Port of ``thunder_tpu/kernels/add_ln.py::add_layer_norm``; the kernel is
``csrc/add_ln.cu``. Over the last axis it computes

    s = x + y                                  (in float32)
    out = ((s - mean(s)) * rsqrt(var(s) + eps)) * scale + bias

with the fast variance ``E[s^2] - mean^2`` clipped at 0, float32 ``scale``
and ``bias``, and the output in ``x``'s dtype. The add in float32 is the TPU
kernel's documented deviation from the unfused path, which adds in the
activation dtype before promoting. The kernel takes any width: a multiple of 8
up to ``MAX_FEATURES`` keeps the row in registers, any other width re-reads it.

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`add_layer_norm_reference`) only for a CPU tensor.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch.kernels import _build

__all__ = ["add_layer_norm", "add_layer_norm_reference", "MAX_FEATURES"]

#: the widest row the kernel keeps in one warp's registers (8 vectors of 8 values a lane); wider rows, and
#: widths that are not a multiple of 8, take its second kernel, which reads the row twice
MAX_FEATURES = 2048


def add_layer_norm_reference(
    x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Plain PyTorch version, with the kernel's rounding points."""
    s = x.float() + y.float()
    mean = s.mean(dim=-1, keepdim=True)
    var = ((s * s).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return ((s - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()).to(x.dtype)


def add_layer_norm(
    x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """``LayerNorm(x + y) * scale + bias`` over the last axis.

    Args:
        x, y: ``(..., D)`` of one shape; on the card bfloat16 and contiguous.
        scale, bias: ``(D,)``; float32 on the card.

    Returns:
        ``(..., D)`` in ``x.dtype``.
    """
    d = x.shape[-1]
    if y.shape != x.shape or scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"add_layer_norm shapes: x {tuple(x.shape)}, y {tuple(y.shape)}, "
                         f"scale {tuple(scale.shape)}, bias {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, y, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_layer_norm runs on cuda or cpu tensors, got {x.device}")
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
        raise ValueError("the add + LayerNorm kernel takes bfloat16 x and y")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("the add + LayerNorm kernel takes float32 scale and bias")
    for name, t in (("x", x), ("y", y), ("scale", scale), ("bias", bias)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {x.device}")
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    status = _build.load().thunder_add_layer_norm(
        x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, d, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "thunder_add_layer_norm")
    add_layer_norm.launches += 1
    return out


add_layer_norm.launches = 0
