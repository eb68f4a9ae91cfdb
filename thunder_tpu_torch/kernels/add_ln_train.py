"""Residual add + dropout + LayerNorm for training: CUDA kernels (forward, backward) and their plain versions.

Port of ``thunder_tpu/kernels/add_ln_train.py`` (``add_ln_dropout_train`` and
``dropout_keep_mask``); the kernels are ``csrc/add_ln_train.cu``. Over the last
axis:

    yd  = keep ? float32(y) / (1 - rate) : 0
    s   = float32(x) + yd
    out = (s - mean(s)) * (rsqrt(max(E[s^2] - mean^2, 0) + eps) * scale) + bias

with float32 ``scale`` and ``bias`` and the output rounded once to ``x``'s
dtype. The forward saves no statistics: the backward re-reads ``x`` and ``y``,
regenerates the mask and recomputes mean and rstd; with ``shat = (s - mean) *
rstd`` and ``g = do * scale``

    ds = rstd * (g - mean(g) - shat * mean(g * shat))
    dx = ds,  dy = keep ? ds / (1 - rate) : 0          (rounded once to x's dtype)
    dscale = sum_rows do * shat,  dbias = sum_rows do   (float32)

``keep`` is the stateless mask of ``kernels/dropout_hash.py`` (stream 0, the
row and column of the flattened ``(rows, D)`` input) under an int32 ``seed``
tensor of one element that stays on the device; it is not the TPU kernel's
Mosaic-PRNG mask, whose bits are the TPU's own. ``row_offset`` (default 0) is
added to each row's index in the hash: the flattened index of the input's first
row in a larger one, so that the slices of an input (a data-parallel rank's
rows), each with its offset, drop what the whole input drops. The TPU kernel's ``rows % 256``
and ``D % 128`` requirements were Mosaic's blocks: here any row count and any
``D`` go (a multiple of 8 up to ``MAX_FEATURES`` keeps the row in registers,
any other width re-reads it). The kernels'
``dscale`` and ``dbias`` are summed without atomics, so one seed gives the same
bits from run to run.

:func:`add_ln_dropout_train` is differentiable in ``x``, ``y``, ``scale`` and
``bias`` through :class:`AddLnDropoutTrain`. Each wrapper runs its kernel for
CUDA tensors and its plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from thunder_tpu_torch.kernels import _build, dropout_hash

__all__ = [
    "add_ln_dropout_train",
    "AddLnDropoutTrain",
    "add_ln_train_forward",
    "add_ln_train_backward",
    "add_ln_train_forward_reference",
    "add_ln_train_backward_reference",
    "backward_plan",
    "backward_rows",
    "dropout_keep_mask",
    "dropout_keep_mask_reference",
]


#: the backward kernels' warps a block and blocks an SM (``csrc/add_ln_train.cu``: ``WARPS``, ``BWD_BLOCKS_PER_SM``)
BWD_WARPS, BWD_BLOCKS_PER_SM = 8, 2


def backward_plan(rows: int, d: int, sms: int) -> dict:
    """The backward's plan on a card of ``sms`` SMs, as ``csrc/add_ln_train.cu`` computes it
    (``thunder_add_ln_train_plan``): ``blocks`` (two an SM, no more than ``BWD_WARPS`` rows a block
    need), which is also the partial rows of ``dscale``/``dbias`` (one a block), ``warps`` a block, the
    rows a warp takes at most, the float32 workspace's bytes (both partials), and the register-row
    kernel's shared bytes a block: the scale and a ring of two rows of x, y and dout a warp (0 for a
    width it does not take)."""
    blocks = min(-(-rows // BWD_WARPS), BWD_BLOCKS_PER_SM * sms)
    per_block = -(-rows // blocks)
    return {"blocks": blocks, "warps": BWD_WARPS, "partial_rows": blocks, "rows_a_warp": -(-per_block // BWD_WARPS),
            "workspace_bytes": 2 * blocks * d * 4,
            "smem_bytes": (d // 8) * 16 * (2 + BWD_WARPS * 6) if d % 8 == 0 and d <= 2048 else 0}


def backward_rows(rows: int, blocks: int, block: int, warp: int) -> range:
    """The rows warp ``warp`` of block ``block`` takes in the register-row backward: the block's balanced
    range ``[block * rows // blocks, (block + 1) * rows // blocks)``, every ``BWD_WARPS``-th from the warp's."""
    lo, hi = block * rows // blocks, (block + 1) * rows // blocks
    return range(lo + warp, hi, BWD_WARPS)


def dropout_keep_mask_reference(shape, seed: torch.Tensor, rate: float, row_offset: int = 0) -> torch.Tensor:
    """Plain version of :func:`dropout_keep_mask`: float32 0/1 of ``shape``, on ``seed``'s device."""
    d = shape[-1]
    rows = int(torch.Size(shape[:-1]).numel())
    dev = seed.device
    keep = dropout_hash.keep_mask(seed, torch.zeros((), dtype=torch.long, device=dev),
                                  torch.arange(rows, device=dev)[:, None] + row_offset,
                                  torch.arange(d, device=dev)[None, :], rate)
    return keep.to(torch.float32).reshape(shape)


def _dropped(y: torch.Tensor, seed: torch.Tensor, rate: float, row_offset: int = 0):
    """``(float32 dropout(y), keep or None, 1 / (1 - rate))`` with the kernels' float32 arithmetic."""
    yf = y.float()
    if rate == 0.0:
        return yf, None, None
    keep = dropout_keep_mask_reference(y.shape, seed, rate, row_offset) > 0
    inv_keep = 1.0 / (1.0 - torch.tensor(rate, dtype=torch.float32, device=y.device))
    return torch.where(keep, yf * inv_keep, 0.0), keep, inv_keep


def _statistics(s: torch.Tensor, eps: float):
    mean = s.mean(dim=-1, keepdim=True)
    var = ((s * s).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def add_ln_train_forward_reference(x, y, scale, bias, seed, rate: float = 0.0, eps: float = 1e-5,
                                   row_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, with its rounding points."""
    yd, _, _ = _dropped(y, seed, rate, row_offset)
    s = x.float() + yd
    mean, rstd = _statistics(s, eps)
    return ((s - mean) * (rstd * scale.float()) + bias.float()).to(x.dtype)


def add_ln_train_backward_reference(x, y, scale, seed, dout, rate: float = 0.0, eps: float = 1e-5,
                                    row_offset: int = 0):
    """Plain PyTorch version of the backward kernel: ``(dx, dy, dscale, dbias)``."""
    yd, keep, inv_keep = _dropped(y, seed, rate, row_offset)
    s = x.float() + yd
    mean, rstd = _statistics(s, eps)
    shat = (s - mean) * rstd
    do = dout.float()
    g = do * scale.float()
    ds = rstd * (g - g.mean(dim=-1, keepdim=True) - shat * (g * shat).mean(dim=-1, keepdim=True))
    dy = ds if keep is None else torch.where(keep, ds * inv_keep, 0.0)
    d = x.shape[-1]
    return ds.to(x.dtype), dy.to(x.dtype), (do * shat).reshape(-1, d).sum(dim=0), do.reshape(-1, d).sum(dim=0)


def _check(x, y, scale, seed, rate, row_offset=0):
    d = x.shape[-1]
    if row_offset < 0:
        raise ValueError(f"row_offset must be >= 0, got {row_offset}")
    if y.shape != x.shape or scale.shape != (d,):
        raise ValueError(f"add_ln_dropout_train shapes: x {tuple(x.shape)}, y {tuple(y.shape)}, scale {tuple(scale.shape)}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if seed.shape != (1,) or seed.dtype != torch.int32:
        raise ValueError(f"seed must be an int32 tensor of shape (1,), got {tuple(seed.shape)} {seed.dtype}")


def _device_args(x, bf16_tensors, f32_tensors, seed):
    """Check a CUDA launch's tensors: bfloat16 activations, float32 parameters, all contiguous, on one device."""
    if x.device.type != "cuda":
        raise ValueError(f"add_ln_dropout_train runs on cuda or cpu tensors, got {x.device}")
    for name, t in bf16_tensors.items():
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the add + dropout + LayerNorm kernels take bfloat16 {name}, got {t.dtype}")
    for name, t in f32_tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"the add + dropout + LayerNorm kernels take float32 {name}, got {t.dtype}")
    for name, t in {**bf16_tensors, **f32_tensors, "seed": seed}.items():
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {x.device}")


def add_ln_train_forward(x, y, scale, bias, seed, rate: float = 0.0, eps: float = 1e-5,
                         row_offset: int = 0) -> torch.Tensor:
    """``LayerNorm(x + dropout(y))``: the forward kernel on the card, its plain version on the CPU."""
    _check(x, y, scale, seed, rate, row_offset)
    if bias.shape != scale.shape:
        raise ValueError(f"bias {tuple(bias.shape)} does not fit scale {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return add_ln_train_forward_reference(x, y, scale, bias, seed, rate, eps, row_offset)
    _device_args(x, {"x": x, "y": y}, {"scale": scale, "bias": bias}, seed)
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    status = _build.load().thunder_add_ln_train_fwd(
        x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), seed.data_ptr(), out.data_ptr(), rows, d,
        float(rate), float(eps), row_offset & 0xFFFFFFFF, _build.stream(x),
    )
    _build.check(status, "thunder_add_ln_train_fwd")
    add_ln_train_forward.launches += 1
    return out


def add_ln_train_backward(x, y, scale, seed, dout, rate: float = 0.0, eps: float = 1e-5, row_offset: int = 0):
    """``(dx, dy, dscale, dbias)``: the backward kernel (one partial ``dscale``/``dbias`` row a block,
    :func:`backward_plan`) and the fixed-order sum of the partial rows on the card (two launches), the
    plain version on the CPU."""
    _check(x, y, scale, seed, rate, row_offset)
    if dout.shape != x.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not fit x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return add_ln_train_backward_reference(x, y, scale, seed, dout, rate, eps, row_offset)
    _device_args(x, {"x": x, "y": y, "dout": dout}, {"scale": scale}, seed)
    d = x.shape[-1]
    rows = x.numel() // d
    dx, dy = torch.empty_like(x), torch.empty_like(x)
    if rows == 0:
        dscale = torch.zeros((2, d), dtype=torch.float32, device=x.device)
        return dx, dy, dscale[0], dscale[1]
    dscale = torch.empty((2, d), dtype=torch.float32, device=x.device)  # the sum kernel writes every column
    lib = _build.load()
    plan = (ctypes.c_int * 4)()
    _build.check(lib.thunder_add_ln_train_plan(rows, d, ctypes.addressof(plan)), "thunder_add_ln_train_plan")
    partials = torch.empty((2, plan[0], d), dtype=torch.float32, device=x.device)
    status = lib.thunder_add_ln_train_bwd(
        x.data_ptr(), y.data_ptr(), scale.data_ptr(), seed.data_ptr(), dout.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        partials[0].data_ptr(), partials[1].data_ptr(), dscale[0].data_ptr(), dscale[1].data_ptr(), rows, d,
        float(rate), float(eps), row_offset & 0xFFFFFFFF, _build.stream(x),
    )
    _build.check(status, "thunder_add_ln_train_bwd")
    add_ln_train_backward.launches += 2
    return dx, dy, dscale[0], dscale[1]


def dropout_keep_mask(shape, seed: torch.Tensor, rate: float, row_offset: int = 0) -> torch.Tensor:
    """The keep mask :func:`add_ln_dropout_train` applies to a ``y`` of ``shape`` under ``seed`` (and
    ``row_offset``), as float32 0/1 on ``seed``'s device: a small kernel on the card, the plain version on
    the CPU."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if row_offset < 0:
        raise ValueError(f"row_offset must be >= 0, got {row_offset}")
    if seed.shape != (1,) or seed.dtype != torch.int32:
        raise ValueError(f"seed must be an int32 tensor of shape (1,), got {tuple(seed.shape)} {seed.dtype}")
    if seed.device.type == "cpu":
        return dropout_keep_mask_reference(shape, seed, rate, row_offset)
    if seed.device.type != "cuda":
        raise ValueError(f"dropout_keep_mask runs on cuda or cpu tensors, got {seed.device}")
    mask = torch.empty(tuple(shape), dtype=torch.float32, device=seed.device)
    if mask.numel() == 0:
        return mask
    d = shape[-1]
    status = _build.load().thunder_dropout_keep_mask(
        seed.data_ptr(), mask.data_ptr(), mask.numel() // d, d, float(rate), row_offset & 0xFFFFFFFF,
        _build.stream(seed),
    )
    _build.check(status, "thunder_dropout_keep_mask")
    dropout_keep_mask.launches += 1
    return mask


add_ln_train_forward.launches = 0
add_ln_train_backward.launches = 0
dropout_keep_mask.launches = 0


class AddLnDropoutTrain(torch.autograd.Function):
    """``(x, y, scale, bias) -> LayerNorm(x + dropout(y))``; the backward is a kernel too."""

    @staticmethod
    def forward(ctx, x, y, scale, bias, seed, rate, eps, row_offset=0):
        x, y = x.contiguous(), y.contiguous()
        ctx.save_for_backward(x, y, scale, seed)
        ctx.rate, ctx.eps, ctx.row_offset = rate, eps, row_offset
        return add_ln_train_forward(x, y, scale, bias, seed, rate, eps, row_offset)

    @staticmethod
    def backward(ctx, dout):
        x, y, scale, seed = ctx.saved_tensors
        dx, dy, dscale, dbias = add_ln_train_backward(x, y, scale, seed, dout.contiguous(), ctx.rate, ctx.eps,
                                                      ctx.row_offset)
        return dx, dy, dscale, dbias, None, None, None, None


def add_ln_dropout_train(x, y, scale, bias, seed, dropout_rate: float = 0.0, eps: float = 1e-5,
                         row_offset: int = 0) -> torch.Tensor:
    """``LayerNorm(x + dropout(y))`` in one pass, differentiable in ``x``, ``y``, ``scale`` and ``bias``.

    Args:
        x, y: ``(..., D)`` of one shape; on the card bfloat16.
        scale, bias: ``(D,)`` float32.
        seed: int32 ``(1,)`` on ``x``'s device; not read at ``dropout_rate == 0``.
        row_offset: the flattened index of the input's first row in the global input when ``x`` and ``y`` are
            a slice of it (a data-parallel rank's rows: first batch row x T).
    """
    return AddLnDropoutTrain.apply(x, y, scale, bias, seed, float(dropout_rate), float(eps), int(row_offset))
