"""Training multi-head attention from the packed QKV projection, with dropout on the
probabilities inside the kernels: CUDA kernels (forward, backward) and their plain versions.

Port of ``thunder_tpu/kernels/attn_train.py::mha_train``; the kernels are
``csrc/mha_train.cu`` (the forward shares ``csrc/mha_forward.cuh`` with the
serving kernel). Semantics kept from the TPU kernels, per head of ``dh = 64``:

- forward: the serving kernel's math (``kernels/attention.py``: q scaled by
  ``bf16(dh**-0.5)``, float32 scores, the additive ``finfo(float32).min`` key
  mask, a softmax over every key streamed with a running max, probabilities
  rounded to the activation dtype before P·V); the rounded probabilities that the dropout mask drops are zeroed and
  the output is divided by ``z * (1 - rate)``, with ``z`` the row sum of the
  *undropped* exponentials. Padded query rows attend the valid keys like any
  row, and a row of length 0 averages every key and stays finite;
- backward: ``e = exp(s - m)`` recomputed from q and k; ``delta = rowsum(f32(dO)
  * f32(O))`` from the saved rounded output (valid under dropout); ``dP = dO·Vᵀ``
  masked and scaled by ``1 / (1 - rate)``; ``dS = bf16(e * (dP - delta) / z)``;
  ``dq = (dS·K) * dh**-0.5``; ``dk = dSᵀ·q̂`` with ``q̂`` the scaled q;
  ``dv = P_dᵀ·dO′`` with ``P_d`` the kept unnormalised ``bf16(e)`` and ``dO′ =
  bf16(f32(dO) / (z * (1 - rate)))``. The result is one packed ``(B, T, 3H)``
  tensor ``[dq | dk | dv]``, which the qkv GEMM's backward consumes as it is.
  The kernels feed q to the products unscaled and multiply ``q·kᵀ`` and
  ``dSᵀ·q`` by ``dh**-0.5 = 0.125`` in float32: a power of two, so the same
  numbers as from ``q̂``.

The mask is the stateless hash of ``kernels/dropout_hash.py`` (stream ``b *
heads + head``, row = query, column = key) under an int32 ``seed`` tensor of
one element that stays on the device; it is not the TPU kernel's Mosaic-PRNG
mask, whose bits are the TPU's own, and it is never stored: the backward
regenerates it. Unlike the TPU kernel, the forward saves each row's ``m`` and
``z`` (``stats``, ``(2, B, heads, T)`` float32), so that the backward streams
the keys with no second softmax pass and holds no key panel. The TPU kernel's
head-pair lane packing, ``T % 128`` and 1536-frame cap were Mosaic's: here the
head count is free and T is any length, forward and backward (no kernel's
shared memory depends on it), within the launch's limits
(``kernels.attention.check_launch_shape``).

:func:`mha_train` is differentiable in ``qkv`` through :class:`MHATrain`. Each
wrapper runs its kernels for CUDA tensors and its plain version only for CPU
tensors.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch.kernels import _build, dropout_hash
from thunder_tpu_torch.kernels.attention import HEAD_DIM, check_launch_shape

__all__ = [
    "mha_train",
    "MHATrain",
    "mha_train_forward",
    "mha_train_backward",
    "mha_train_forward_reference",
    "mha_train_backward_reference",
    "attention_keep_mask",
]


def attention_keep_mask(seed: torch.Tensor, batch: int, heads: int, t: int, rate: float, rows=None) -> torch.Tensor:
    """The keep mask of the attention probabilities, ``(B, heads, rows, T)`` bool on ``seed``'s device;
    ``rows`` (default all ``T`` queries) is any 1-D tensor of query indices."""
    dev = seed.device
    rows = torch.arange(t, device=dev) if rows is None else rows.to(dev)
    streams = torch.arange(batch * heads, device=dev).reshape(batch, heads, 1, 1)
    return dropout_hash.keep_mask(seed, streams, rows[None, None, :, None], torch.arange(t, device=dev), rate)


def _per_head(a: torch.Tensor, heads: int) -> torch.Tensor:
    """``(B, T, heads * dh)`` -> float32 ``(B, heads, T, dh)``."""
    b, t, h = a.shape
    return a.reshape(b, t, heads, h // heads).transpose(1, 2).float()


def _merge(a: torch.Tensor) -> torch.Tensor:
    """``(B, heads, T, dh)`` -> ``(B, T, heads * dh)``."""
    b, heads, t, dh = a.shape
    return a.transpose(1, 2).reshape(b, t, heads * dh)


def _scores(qkv: torch.Tensor, lengths: torch.Tensor, heads: int):
    """``(q̂, k, v, s)`` per head in float32: the scaled and rounded q, and the masked scores."""
    b, t, h3 = qkv.shape
    h = h3 // 3
    q, k, v = qkv.split(h, dim=-1)
    q = q * torch.tensor((h // heads) ** -0.5, dtype=qkv.dtype)
    q, k, v = _per_head(q, heads), _per_head(k, heads), _per_head(v, heads)
    valid = torch.arange(t, device=qkv.device)[None, :] < lengths.to(qkv.device)[:, None]
    s = torch.matmul(q, k.transpose(-1, -2)) + torch.where(valid, 0.0, torch.finfo(torch.float32).min)[:, None, None, :]
    return q, k, v, s


def mha_train_forward_reference(qkv, lengths, seed, heads: int, rate: float = 0.0):
    """Plain PyTorch version of the forward kernel, with its rounding points: ``(out, stats)``."""
    _, _, v, s = _scores(qkv, lengths, heads)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    z = e.sum(dim=-1, keepdim=True)
    p = e.to(qkv.dtype).float()
    denom = z
    if rate > 0.0:
        p = torch.where(attention_keep_mask(seed, qkv.shape[0], heads, qkv.shape[1], rate), p, 0.0)
        denom = z * (1.0 - torch.tensor(rate, dtype=torch.float32, device=qkv.device))
    out = _merge(torch.matmul(p, v) / denom).to(qkv.dtype)
    return out, torch.stack([m[..., 0], z[..., 0]])


def mha_train_backward_reference(qkv, out, stats, dout, lengths, seed, heads: int, rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the backward kernels, step by step with their rounding points:
    the packed ``[dq | dk | dv]`` in ``qkv``'s dtype."""
    dt = qkv.dtype
    dh = qkv.shape[-1] // 3 // heads
    q, k, v, s = _scores(qkv, lengths, heads)
    m, z = stats[0][..., None], stats[1][..., None]
    e = torch.exp(s - m)
    inv_z = 1.0 / z
    do = _per_head(dout, heads)
    delta = (do * _per_head(out, heads)).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do, v.transpose(-1, -2))
    pd = e.to(dt).float()
    inv_keep = torch.ones((), dtype=torch.float32, device=qkv.device)
    if rate > 0.0:
        keep = attention_keep_mask(seed, qkv.shape[0], heads, qkv.shape[1], rate)
        inv_keep = 1.0 / (1.0 - torch.tensor(rate, dtype=torch.float32, device=qkv.device))
        dp = torch.where(keep, dp * inv_keep, 0.0)
        pd = torch.where(keep, pd, 0.0)
    ds = (e * (dp - delta) * inv_z).to(dt).float()
    dq = torch.matmul(ds, k) * dh**-0.5
    dk = torch.matmul(ds.transpose(-1, -2), q)
    doz = (do * (inv_z * inv_keep)).to(dt).float()
    dv = torch.matmul(pd.transpose(-1, -2), doz)
    return torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1).to(dt)


def _check(qkv, lengths, seed, heads, rate):
    if qkv.ndim != 3 or qkv.shape[-1] % 3 or heads < 1 or (qkv.shape[-1] // 3) % heads:
        raise ValueError(f"mha_train takes a packed (B, T, 3 * heads * dh) qkv, got {tuple(qkv.shape)}, heads={heads}")
    if lengths.shape != (qkv.shape[0],):
        raise ValueError(f"lengths {tuple(lengths.shape)} do not fit a batch of {qkv.shape[0]}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if seed.shape != (1,) or seed.dtype != torch.int32:
        raise ValueError(f"seed must be an int32 tensor of shape (1,), got {tuple(seed.shape)} {seed.dtype}")


def _device_args(qkv, heads, bf16_tensors, other_tensors):
    """Check a CUDA launch's tensors: shapes the kernels take, all contiguous, aligned, on one device."""
    if qkv.device.type != "cuda":
        raise ValueError(f"mha_train runs on cuda or cpu tensors, got {qkv.device}")
    batch, t, h3 = qkv.shape
    if h3 // 3 // heads != HEAD_DIM:
        raise ValueError(f"the training attention kernels take dh = {HEAD_DIM}, got {h3 // 3 // heads}")
    check_launch_shape("the training attention kernels", batch, t, heads)
    if other_tensors["lengths"].dtype != torch.int32:
        raise ValueError("the training attention kernels take int32 lengths")
    for name, x in bf16_tensors.items():
        if x.dtype != torch.bfloat16:
            raise ValueError(f"the training attention kernels take a bfloat16 {name}, got {x.dtype}")
    for name, x in {**bf16_tensors, **other_tensors}.items():
        if x.device != qkv.device or not x.is_contiguous() or x.data_ptr() % (16 if name in bf16_tensors else 4):
            raise ValueError(f"{name} must be a contiguous, aligned tensor on {qkv.device}")


def mha_train_forward(qkv, lengths, seed, heads: int, rate: float = 0.0):
    """``(out (B, T, H), stats (2, B, heads, T) float32)``: the forward kernel on the card, its
    plain version on the CPU."""
    _check(qkv, lengths, seed, heads, rate)
    if qkv.device.type == "cpu":
        return mha_train_forward_reference(qkv, lengths, seed, heads, rate)
    _device_args(qkv, heads, {"qkv": qkv}, {"lengths": lengths, "seed": seed})
    batch, t, h3 = qkv.shape
    out = torch.empty((batch, t, h3 // 3), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((2, batch, heads, t), dtype=torch.float32, device=qkv.device)
    status = _build.load().thunder_mha_train_fwd(
        qkv.data_ptr(), lengths.data_ptr(), seed.data_ptr(), out.data_ptr(), stats.data_ptr(), batch, t, heads,
        float(rate), torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _build.check(status, "thunder_mha_train_fwd")
    mha_train_forward.launches += 1
    return out, stats


def mha_train_backward(qkv, out, stats, dout, lengths, seed, heads: int, rate: float = 0.0) -> torch.Tensor:
    """The packed ``[dq | dk | dv]`` ``(B, T, 3H)``: the dq kernel and the dk/dv kernel on the card
    (two launches), the plain version on the CPU."""
    _check(qkv, lengths, seed, heads, rate)
    batch, t, h3 = qkv.shape
    if out.shape != (batch, t, h3 // 3) or dout.shape != out.shape or stats.shape != (2, batch, heads, t):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)}, stats {tuple(stats.shape)} do not fit qkv "
                         f"{tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return mha_train_backward_reference(qkv, out, stats, dout, lengths, seed, heads, rate)
    if stats.dtype != torch.float32:
        raise ValueError(f"stats must be float32, got {stats.dtype}")
    _device_args(qkv, heads, {"qkv": qkv, "out": out, "dout": dout}, {"lengths": lengths, "seed": seed, "stats": stats})
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((batch, heads, t), dtype=torch.float32, device=qkv.device)
    status = _build.load().thunder_mha_train_bwd(
        qkv.data_ptr(), lengths.data_ptr(), seed.data_ptr(), out.data_ptr(), dout.data_ptr(), stats.data_ptr(),
        delta.data_ptr(), dqkv.data_ptr(), batch, t, heads, float(rate),
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _build.check(status, "thunder_mha_train_bwd")
    mha_train_backward.launches += 2
    return dqkv


mha_train_forward.launches = 0
mha_train_backward.launches = 0


class MHATrain(torch.autograd.Function):
    """``qkv (B, T, 3H) -> out (B, T, H)``; the backward is the kernel pair."""

    @staticmethod
    def forward(ctx, qkv, lengths, seed, heads, rate):
        qkv = qkv.contiguous()
        out, stats = mha_train_forward(qkv, lengths, seed, heads, rate)
        ctx.save_for_backward(qkv, out, stats, lengths, seed)
        ctx.heads, ctx.rate = heads, rate
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, stats, lengths, seed = ctx.saved_tensors
        return mha_train_backward(qkv, out, stats, dout.contiguous(), lengths, seed, ctx.heads, ctx.rate), None, None, None, None


def mha_train(qkv: torch.Tensor, lengths: torch.Tensor, seed: torch.Tensor, heads: int,
              dropout_rate: float = 0.0) -> torch.Tensor:
    """Differentiable multi-head attention over a packed ``[q | k | v]`` tensor.

    Args:
        qkv: ``(B, T, 3H)``, the fused projection's output; on the card
            bfloat16 with ``dh = H / heads = 64``; any ``T`` the launch takes.
        lengths: ``(B,)`` valid keys of each row (a prefix); int32 on the card.
        seed: int32 ``(1,)`` on ``qkv``'s device, fresh for each layer and step;
            not read at ``dropout_rate == 0``.
        heads: number of heads.

    Returns:
        ``(B, T, H)`` in ``qkv.dtype``; its cotangent is the packed ``[dq | dk | dv]``.
    """
    return MHATrain.apply(qkv, lengths, seed, heads, float(dropout_rate))
