"""Greedy CTC decoding: the device argmax and the host collapse.

Port of ``greedy_decode`` and ``collapse_ctc`` from ``thunder_tpu/ops/ctc.py``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["greedy_decode", "collapse_ctc"]


def greedy_decode(logits: torch.Tensor) -> torch.Tensor:
    """Argmax token ids per frame: ``(batch, time, vocab)`` -> int32 ``(batch, time)``."""
    return logits.argmax(dim=-1).to(torch.int32)


def collapse_ctc(ids: np.ndarray, lengths: np.ndarray | None = None, remove_repeated: bool = True):
    """Drop consecutive repeats per row and keep blanks for the text transform
    to strip; rows are cut to ``lengths`` first. Returns a list of 1-D arrays."""
    ids = np.asarray(ids)
    out = []
    for b in range(ids.shape[0]):
        row = ids[b, : int(lengths[b])] if lengths is not None else ids[b]
        if remove_repeated and row.size:
            keep = np.ones(row.shape, dtype=bool)
            keep[1:] = row[1:] != row[:-1]
            row = row[keep]
        out.append(row)
    return out
