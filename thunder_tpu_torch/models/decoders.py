"""CTC decoder heads: encoder features to per-frame logits.

Port of ``thunder_tpu/models/decoders.py``: ``Conv1dDecoder`` (a 1x1 conv,
xavier uniform) and ``LinearDecoder`` (dropout in train mode, then a dense
layer named ``dense``, the wav2vec2 head). Their input width is taken from
the encoder when the model is assembled (``CTCModel``), as flax infers it on
first call. ``dtype`` is the compute type: input, kernel and bias are cast to
it, as flax casts them. Output: ``(batch, time, num_classes)`` in ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from thunder_tpu_torch.models.layers import Dense, dropout

__all__ = ["Conv1dDecoder", "LinearDecoder"]


class Conv1dDecoder(nn.Module):
    def __init__(self, num_classes: int, in_features: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.in_features = None
        if in_features is not None:
            self.build(in_features)

    def build(self, in_features: int) -> None:
        """Allocate the ``(1, in_features, num_classes)`` kernel and the bias."""
        self.in_features = in_features
        self.kernel = nn.Parameter(torch.empty(1, in_features, self.num_classes))
        self.bias = nn.Parameter(torch.zeros(self.num_classes))

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        return torch.matmul(x.to(self.dtype), self.kernel[0].to(self.dtype)) + self.bias.to(self.dtype)


class LinearDecoder(nn.Module):
    """Dropout (train mode, drawn from ``generator``) + dense head, the flax path ``decoder/dense``."""

    def __init__(self, num_classes: int, dropout: float = 0.0, in_features: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dropout = dropout
        self.dtype = dtype
        self.in_features = None
        if in_features is not None:
            self.build(in_features)

    def build(self, in_features: int) -> None:
        """Allocate the ``dense`` layer: kernel ``(in_features, num_classes)`` and bias."""
        self.in_features = in_features
        self.dense = Dense(in_features, self.num_classes, dtype=self.dtype)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        if train:
            x = dropout(x, self.dropout, generator)
        return self.dense(x)
