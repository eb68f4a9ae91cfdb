"""QuartzNet encoder (5x5 / 15x5) as an ``nn.Module``.

Port of ``thunder_tpu/models/quartznet.py``:

- stem: feat_in -> 256, k=33, stride 2, separable, no residual;
- body: per-(filters, kernel) residual separable blocks x repeat_blocks,
  then a k=87 dilation-2 512-channel block and a 1x1 1024-channel block;
- QuartzNet5x5 = repeat_blocks=1, QuartzNet15x5 = repeat_blocks=3;
- ``dropout`` after each activated repeat and each block in train mode,
  ``init_mode`` the conv kernels' :class:`~thunder_tpu_torch.models.layers.InitMode`,
  ``dtype`` the compute type (parameters stay float32);
- ``remat``: each block is rematerialized in the backward (its activations
  recomputed instead of kept, :func:`~thunder_tpu_torch.models.layers.checkpointed`)
  in train mode with gradients on: the same loss, gradients and running
  statistics for one more forward of compute.

Layout ``(batch, frames, channels)``; returns ``(encoded, lengths)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from thunder_tpu_torch.models.layers import EncoderBlock, InitMode, run_block

__all__ = ["QuartznetEncoder"]


class QuartznetEncoder(nn.Module):
    #: encoder output channels, the decoder's input dimension
    final_dimension = 1024

    def __init__(
        self,
        feat_in: int = 64,
        filters: Sequence[int] = (256, 256, 512, 512, 512),
        kernel_sizes: Sequence[int] = (33, 39, 51, 63, 75),
        repeat_blocks: int = 1,
        repeat: int = 5,
        dropout: float = 0.0,
        init_mode: str = InitMode.xavier_uniform,
        dtype=torch.float32,
        remat: bool = False,
    ):
        super().__init__()
        self.feat_in = feat_in
        self.filters = tuple(filters)
        self.kernel_sizes = tuple(kernel_sizes)
        self.repeat_blocks = repeat_blocks
        self.repeat = repeat
        self.dropout = dropout
        self.init_mode = init_mode
        self.dtype = dtype
        self.remat = remat
        blocks = [dict(features=256, repeat=1, kernel_size=33, stride=2, residual=False, separable=True)]
        for f, k in zip(self.filters, self.kernel_sizes):
            blocks += [dict(features=f, repeat=repeat, kernel_size=k, separable=True)] * repeat_blocks
        blocks.append(dict(features=512, repeat=1, kernel_size=87, dilation=2, residual=False, separable=True))
        blocks.append(dict(features=1024, repeat=1, kernel_size=1, residual=False, separable=False))
        in_features = feat_in
        self.num_blocks = len(blocks)
        for i, cfg in enumerate(blocks):
            self.add_module(f"block{i}", EncoderBlock(in_features, **cfg, dropout=dropout, init_mode=init_mode,
                                                        dtype=dtype))
            in_features = cfg["features"]

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False, generator=None):
        for i in range(self.num_blocks):
            x, lengths = run_block(getattr(self, f"block{i}"), x, lengths, remat=self.remat, train=train,
                                   generator=generator)
        return x, lengths
