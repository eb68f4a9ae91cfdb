"""Citrinet encoder as an ``nn.Module``.

Port of ``thunder_tpu/models/citrinet.py``, the same block list:

- stem: feat_in -> 256, k=5, separable, squeeze-excite, no residual;
- body: one separable residual squeeze-excite block per (filters, kernel,
  stride), ``repeat`` repeats, the stride on the last repeat only and the
  residual 1x1 conv strided by ``stride``;
- tail: 640 channels, k=41, squeeze-excite, no residual;
- ``remat``: each block rematerialized in the backward, as QuartzNet's.

``CITRINET_256_*`` are the published Citrinet-256 widths (the JAX package's
``flops.py`` constants): 21 blocks of 256 channels in three megablocks of 6,
7 and 8, stride 2 on the first of each, so 8x fewer frames than features.

Layout ``(batch, frames, channels)``; returns ``(encoded, lengths)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from thunder_tpu_torch.models.layers import EncoderBlock, InitMode, run_block

__all__ = ["CitrinetEncoder", "CITRINET_256_FILTERS", "CITRINET_256_KERNELS", "CITRINET_256_STRIDES"]

CITRINET_256_FILTERS = (256,) * 21
CITRINET_256_KERNELS = (
    11, 13, 15, 17, 19, 21,
    13, 15, 17, 19, 21, 23, 25,
    25, 27, 29, 31, 33, 35, 37, 39,
)
CITRINET_256_STRIDES = tuple(2 if i in (0, 6, 13) else 1 for i in range(21))


class CitrinetEncoder(nn.Module):
    #: encoder output channels, the decoder's input dimension
    final_dimension = 640

    def __init__(
        self,
        filters: Sequence[int],
        kernel_sizes: Sequence[int],
        strides: Sequence[int],
        feat_in: int = 80,
        repeat: int = 5,
        dropout: float = 0.0,
        init_mode: str = InitMode.xavier_uniform,
        dtype=torch.float32,
        remat: bool = False,
    ):
        super().__init__()
        self.feat_in = feat_in
        self.filters, self.kernel_sizes, self.strides = tuple(filters), tuple(kernel_sizes), tuple(strides)
        self.repeat = repeat
        self.dropout = dropout
        self.init_mode = init_mode
        self.dtype = dtype
        self.remat = remat
        blocks = [dict(features=256, repeat=1, kernel_size=5, residual=False)]
        for f, k, s in zip(self.filters, self.kernel_sizes, self.strides):
            blocks.append(dict(features=f, repeat=repeat, kernel_size=k, stride=s))
        blocks.append(dict(features=640, repeat=1, kernel_size=41, residual=False))
        common = dict(separable=True, squeeze_excite=True, stride_last_only=True, residual_stride_pow=False,
                      dropout=dropout, init_mode=init_mode, dtype=dtype)
        in_features = feat_in
        self.num_blocks = len(blocks)
        for i, cfg in enumerate(blocks):
            self.add_module(f"block{i}", EncoderBlock(in_features, **cfg, **common))
            in_features = cfg["features"]

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False, generator=None):
        for i in range(self.num_blocks):
            x, lengths = run_block(getattr(self, f"block{i}"), x, lengths, remat=self.remat, train=train,
                                   generator=generator)
        return x, lengths
