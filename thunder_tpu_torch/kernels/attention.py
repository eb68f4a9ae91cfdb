"""Serving multi-head attention from the packed QKV projection: a CUDA kernel and its plain version.

Port of ``thunder_tpu/kernels/attn_onepanel.py::mha_from_qkv`` (heads of 64)
and, at heads of 80, of the forward of ``thunder_tpu/models/wav2vec2.py::
_flash_mha`` (jax's Pallas TPU flash attention, which the JAX module runs at
any head width); the kernel is ``csrc/mha_from_qkv.cu``, one source for both
widths (:data:`HEAD_DIMS`). It reads q, k and v straight out of the ``(B, T,
3H)`` output of the fused ``qkv_proj`` GEMM (q of head ``h`` at columns
``h*dh``, k at ``H + h*dh``, v at ``2H + h*dh``) and writes ``(B, T, H)``,
with no split, pad or transpose. Semantics, kept from the TPU kernel:

- q is multiplied by ``bf16(dh**-0.5)`` in the activation dtype and rounded
  once (exact for dh = 64; at dh = 80 the JAX module's ``q * dh**-0.5`` before
  ``_flash_mha``);
- scores are q·kᵀ with float32 accumulation; the key-length mask ADDS
  ``finfo(float32).min`` (not −inf), so a row of length 0 averages every key
  uniformly and stays finite, and padded query rows attend the valid keys
  like any other row;
- the softmax is over every key: row max, ``exp(s - m)``, float32 row sum;
  the probabilities are rounded to the activation dtype before P·V, which
  accumulates in float32; the division by the row sum is applied to the
  output. The kernel streams the keys in tiles with a running max, so each
  probability is rounded against the max so far and rescaled in float32
  (within the checks' bf16 ULPs of this plain version).

``_flash_mha`` masks by segment ids instead: its padded query rows attend only
the padded keys, where here they attend the valid keys. Valid rows agree, and
both packages mask the padded frames downstream, so compare valid rows only.
Head widths other than 64 and 80 have no kernel yet.

The TPU kernel's head-pair lane packing and its ``T % 128`` requirement were
Mosaic's 128-lane blocks; here the head count is free and T is any length:
the kernel's shared memory does not depend on it. The limits are the
launch's: ``T < 2**31`` (the tensor map's coordinates), batch and heads at
most 65535 (the grid).

The wrapper's implementation runs the kernel for a CUDA tensor and the plain
version (:func:`mha_from_qkv_reference`) only for a CPU tensor. A traced call
(``torch.export``, ``torch.compile``) reaches it through the custom op
``thunder_tpu::mha_from_qkv``, whose fake implementation gives the output's
shape and dtype, so that the trace holds the call as one node; an eager call
runs it directly, without the op's dispatch.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch.kernels import _build

__all__ = ["mha_from_qkv", "mha_from_qkv_reference", "HEAD_DIMS", "check_launch_shape"]

#: the head widths the attention kernels take
HEAD_DIMS = (64, 80)


def mha_from_qkv_reference(qkv: torch.Tensor, lengths: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version, with the kernel's rounding points (any float dtype)."""
    b, t, h3 = qkv.shape
    h = h3 // 3
    dh = h // heads
    q, k, v = qkv.split(h, dim=-1)
    q = q * torch.tensor(dh**-0.5, dtype=qkv.dtype)
    per_head = lambda a: a.reshape(b, t, heads, dh).transpose(1, 2).float()  # noqa: E731
    s = torch.matmul(per_head(q), per_head(k).transpose(-1, -2))  # (B, heads, T, T) f32
    valid = torch.arange(t, device=qkv.device)[None, :] < lengths.to(qkv.device)[:, None]
    s = s + torch.where(valid, 0.0, torch.finfo(torch.float32).min)[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    z = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(qkv.dtype).float(), per_head(v)) / z
    return out.transpose(1, 2).reshape(b, t, h).to(qkv.dtype)


def _check(qkv: torch.Tensor, lengths: torch.Tensor, heads: int) -> None:
    if qkv.ndim != 3 or qkv.shape[-1] % 3 or heads < 1 or (qkv.shape[-1] // 3) % heads:
        raise ValueError(f"mha_from_qkv takes a packed (B, T, 3 * heads * dh) qkv, got {tuple(qkv.shape)}, "
                         f"heads={heads}")
    if lengths.shape != (qkv.shape[0],):
        raise ValueError(f"lengths {tuple(lengths.shape)} do not fit a batch of {qkv.shape[0]}")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mha_from_qkv runs on cuda or cpu tensors, got {qkv.device}")


def check_launch_shape(name: str, batch: int, t: int, heads: int) -> None:
    """Raise unless the attention kernels' launch takes the shape: ``T < 2**31``, batch and heads <= 65535."""
    if not (1 <= t < 2**31 and 1 <= batch <= 65535 and 1 <= heads <= 65535):
        raise ValueError(f"{name} takes 1 <= T < 2**31 frames and batch and heads of at most 65535, got "
                         f"batch={batch}, T={t}, heads={heads}")


def mha_from_qkv(qkv: torch.Tensor, lengths: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head attention over a packed ``[q | k | v]`` tensor.

    Args:
        qkv: ``(B, T, 3H)``, the fused projection's output; on the card
            bfloat16, contiguous, with ``dh = H / heads`` in :data:`HEAD_DIMS`;
            any ``T`` the launch takes (:func:`check_launch_shape`).
        lengths: ``(B,)`` valid keys of each row (a prefix); int32 on the card.
        heads: number of heads.

    Returns:
        ``(B, T, H)`` in ``qkv.dtype``.
    """
    run = _mha_from_qkv_op if torch.compiler.is_compiling() else _mha_from_qkv
    return run(qkv, lengths, heads)


mha_from_qkv.launches = 0


def _mha_from_qkv(qkv: torch.Tensor, lengths: torch.Tensor, heads: int) -> torch.Tensor:
    _check(qkv, lengths, heads)
    if qkv.device.type == "cpu":
        return mha_from_qkv_reference(qkv, lengths, heads)
    batch, t, h3 = qkv.shape
    if qkv.dtype != torch.bfloat16 or lengths.dtype != torch.int32:
        raise ValueError("the attention kernel takes a bfloat16 qkv and int32 lengths")
    dh = h3 // 3 // heads
    if dh not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes dh = 64 or 80, got {dh}")
    check_launch_shape("the attention kernel", batch, t, heads)
    for name, x in (("qkv", qkv), ("lengths", lengths)):
        if x.device != qkv.device or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {qkv.device}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    out = torch.empty((batch, t, h3 // 3), dtype=qkv.dtype, device=qkv.device)
    status = _build.load().thunder_mha_from_qkv(
        qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(), batch, t, heads, dh,
        _build.stream(qkv),
    )
    _build.check(status, "thunder_mha_from_qkv")
    mha_from_qkv.launches += 1
    return out


_mha_from_qkv_op = torch.library.custom_op("thunder_tpu::mha_from_qkv", _mha_from_qkv, mutates_args=())


@_mha_from_qkv_op.register_fake
def _(qkv, lengths, heads):
    _check(qkv, lengths, heads)
    batch, t, h3 = qkv.shape
    return qkv.new_empty((batch, t, h3 // 3))
