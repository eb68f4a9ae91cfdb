"""The stateless dropout keep mask of the training kernels, in PyTorch integer arithmetic.

The TPU kernels (``thunder_tpu/kernels/attn_train.py``,
``thunder_tpu/kernels/add_ln_train.py``) draw their masks from the Mosaic
PRNG, seeded per slab of rows. Its bits are the TPU's own; what the port keeps
is the contract: the mask is a pure function of the seed and of where the
element lies, it is never stored, and the backward regenerates the forward's
bits whatever its tiling. Here the keep bit is a counter-based hash of the
element's absolute coordinates:

    key  = mix32(mix32(seed ^ stream * 0x9E3779B1) ^ row)
    bits = mix32(key ^ col * 0x85EBCA6B)
    u    = (bits >> 9) * 2**-23                   (23 bits, exact in float32)
    keep = u >= rate

with ``mix32`` a 32-bit finalizer (two multiply-xorshift rounds) and every
product taken modulo 2**32. ``stream`` is ``batch row * heads + head`` for the
attention probabilities (``row`` the query, ``col`` the key) and 0 for the add
+ LayerNorm branch (``row`` and ``col`` of the flattened ``(rows, D)`` input).
Batch rows and flattened rows are the global batch's: a slice of a batch (a
data-parallel rank's rows) passes its first row's index as the wrappers'
``row_offset``. Stream, row and column sit in separate words, so no flat index can wrap.

The kernels test ``keep`` as an integer compare: ``u >= rate``, both sides
exact in float32, is ``bits >> 9 >= threshold(rate) = ceil(rate * 2**23)``
(:func:`threshold`, :func:`keep_at`).

``csrc/dropout_hash.cuh`` holds the same functions as ``__device__`` code; the
plain versions of the kernels call this module, so both sides make the same
mask bit for bit, on the CPU and on the card. uint32 values are held in int64
tensors in ``[0, 2**32)``, and a product with a 32-bit constant is split into
16-bit halves so that it never passes 2**63.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from thunder_tpu_torch.kernels.beam import _mul_mod32 as _mul32  # h * m mod 2**32 in int64, split into 16-bit halves

__all__ = ["mix32", "row_keys", "keep_from_bits", "keep_from_keys", "threshold", "keep_at", "keep_mask", "new_seed"]

_MASK = 0xFFFFFFFF
_STREAM_MUL = 0x9E3779B1
_COL_MUL = 0x85EBCA6B


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def row_keys(seed: torch.Tensor, stream: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The 32-bit key of each ``(stream, row)`` pair (broadcast) under ``seed`` (an int32 tensor of one element)."""
    seed = seed.reshape(()).long() & _MASK
    return mix32(mix32(seed ^ _mul32(stream.long() & _MASK, _STREAM_MUL)) ^ (rows.long() & _MASK))


def _bits(keys: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    return mix32(keys ^ _mul32(cols.long() & _MASK, _COL_MUL))


def keep_from_bits(top: torch.Tensor, rate: float) -> torch.Tensor:
    """The float compare of the keep test on ``top = bits >> 9``: ``top * 2**-23 >= rate`` in float32."""
    u = top.to(torch.float32) * 2.0**-23
    return u >= torch.tensor(rate, dtype=torch.float32, device=u.device)


def keep_from_keys(keys: torch.Tensor, cols: torch.Tensor, rate: float) -> torch.Tensor:
    """``keep`` (bool) of the columns ``cols`` under the row keys ``keys`` (broadcast)."""
    return keep_from_bits(_bits(keys, cols) >> 9, rate)


def threshold(rate: float) -> int:
    """``dropout_hash.cuh::threshold``: ``ceil(rate * 2**23)`` of the float32 rate, the least ``bits >> 9`` kept
    (the product is exact in float32 and in float64 alike)."""
    return math.ceil(float(np.float32(rate)) * 2.0**23)


def keep_at(keys: torch.Tensor, cols: torch.Tensor, threshold: int) -> torch.Tensor:
    """``dropout_hash.cuh::keep_at``: the keep test as the integer compare ``bits >> 9 >= threshold``."""
    return (_bits(keys, cols) >> 9) >= threshold


def keep_mask(seed: torch.Tensor, streams: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, rate: float) -> torch.Tensor:
    """The keep mask over the broadcast of ``streams``, ``rows`` and ``cols`` (integer tensors on ``seed``'s device)."""
    return keep_from_keys(row_keys(seed, streams, rows), cols, rate)


def new_seed(generator: torch.Generator | None, device, rate: float) -> torch.Tensor:
    """A fresh int32 ``(1,)`` seed on ``device`` from the explicit generator; it stays on the
    device (a kernel reads it through its pointer), so drawing it costs no host sync. At
    ``rate`` 0 no kernel reads the seed: nothing is drawn and the seed is 0."""
    if rate == 0.0:
        return torch.zeros(1, dtype=torch.int32, device=device)
    if generator is None:
        raise ValueError("dropout in train mode draws from an explicit torch.Generator; pass generator=")
    return torch.randint(0, 2**31 - 1, (1,), generator=generator, device=device, dtype=torch.int32)
