"""Batch collation with padding buckets, shared by loading and serving.

Port of ``thunder_tpu/data/collate.py``: batches pad up to multiples of
``pad_multiple``, so the set of batch shapes stays small while the lengths
keep the math exact.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["asr_collate", "bucket_length"]


def bucket_length(n: int, pad_multiple: int) -> int:
    """Round ``n`` up to a multiple of ``pad_multiple`` (at least one bucket)."""
    return max(pad_multiple, -(-n // pad_multiple) * pad_multiple)


def asr_collate(
    samples: Sequence[Tuple[np.ndarray, str]], pad_multiple: int = 16000
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Collate (audio, text) samples -> (padded float32 audio, int32 lengths, texts).

    Samples are sorted by descending length and padded to the bucket width.
    """
    samples = sorted(samples, key=lambda s: s[0].shape[-1], reverse=True)
    audios = [np.asarray(s[0]).reshape(-1) for s in samples]
    lengths = np.asarray([a.shape[-1] for a in audios], dtype=np.int32)
    width = bucket_length(int(lengths.max(initial=1)), pad_multiple)
    batch = np.zeros((len(audios), width), dtype=np.float32)
    for i, a in enumerate(audios):
        batch[i, : a.shape[-1]] = a
    texts = [s[1] for s in samples]
    return batch, lengths, texts
