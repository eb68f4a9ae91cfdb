"""CTC decoder head: a 1x1 conv from encoder features to per-frame logits.

Port of ``thunder_tpu/models/decoders.py::Conv1dDecoder``. Its input width is
taken from the encoder when the model is assembled (``CTCModel``), as flax
infers it on first call. Output: ``(batch, time, num_classes)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Conv1dDecoder"]


class Conv1dDecoder(nn.Module):
    def __init__(self, num_classes: int, in_features: Optional[int] = None):
        super().__init__()
        self.num_classes = num_classes
        self.in_features = None
        if in_features is not None:
            self.build(in_features)

    def build(self, in_features: int) -> None:
        """Allocate the ``(1, in_features, num_classes)`` kernel and the bias."""
        self.in_features = in_features
        self.kernel = nn.Parameter(torch.empty(1, in_features, self.num_classes))
        self.bias = nn.Parameter(torch.zeros(self.num_classes))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.matmul(x, self.kernel[0]) + self.bias
