"""The training kernels' stateless dropout keep mask, in PyTorch integer arithmetic.

Frozen copy of ``thunder_tpu_torch/kernels/dropout_hash.py`` (and of ``kernels/beam.py::_mul_mod32``) at
commit 6ca5cdbbf336fefac8336cbc2e6f4fc3b5b7d9f8, the function that ``csrc/dropout_hash.cuh`` computes on the
card, so that the plain reference works the masks out again from the kernels' seeds:

    key  = mix32(mix32(seed ^ stream * 0x9E3779B1) ^ row)
    bits = mix32(key ^ col * 0x85EBCA6B)
    keep = (bits >> 9) * 2**-23 >= rate

``stream`` is ``batch row * heads + head`` for the attention probabilities (``row`` the query, ``col`` the
key) and 0 for the add + LayerNorm branch (``row`` and ``col`` of the flattened ``(rows, D)`` input). uint32
values are held in int64 tensors; a product with a 32-bit constant is split into 16-bit halves.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """``h * m mod 2**32`` for int64 ``h`` in ``[0, 2**32)``, with no int64 product above 2**48."""
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask(seed: torch.Tensor, streams: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
              rate: float) -> torch.Tensor:
    """The keep mask over the broadcast of ``streams``, ``rows`` and ``cols`` under the int32 ``seed``."""
    seed = seed.reshape(()).long() & _MASK
    keys = mix32(mix32(seed ^ _mul32(streams.long() & _MASK, 0x9E3779B1)) ^ (rows.long() & _MASK))
    top = mix32(keys ^ _mul32(cols.long() & _MASK, 0x85EBCA6B)) >> 9
    return top.to(torch.float32) * 2.0**-23 >= torch.tensor(rate, dtype=torch.float32, device=top.device)


def attention_keep(seed: torch.Tensor, batch: int, heads: int, t: int, rate: float, rows: torch.Tensor) -> torch.Tensor:
    """``(batch, heads, len(rows), t)``: the attention probabilities' mask for the query ``rows``."""
    dev = seed.device
    streams = torch.arange(batch * heads, device=dev).reshape(batch, heads, 1, 1)
    return keep_mask(seed, streams, rows.to(dev)[None, None, :, None], torch.arange(t, device=dev), rate)


def rows_keep(seed: torch.Tensor, shape, rate: float) -> torch.Tensor:
    """The add + LayerNorm branch's mask of a ``y`` of ``shape``, over its flattened ``(rows, D)``."""
    d = shape[-1]
    rows = int(torch.Size(shape[:-1]).numel())
    dev = seed.device
    keep = keep_mask(seed, torch.zeros((), dtype=torch.long, device=dev), torch.arange(rows, device=dev)[:, None],
                     torch.arange(d, device=dev)[None, :], rate)
    return keep.reshape(shape)
