"""Padding buckets shared by loading and serving.

Port of ``thunder_tpu/data/collate.py::bucket_length``.
"""

from __future__ import annotations

__all__ = ["bucket_length"]


def bucket_length(n: int, pad_multiple: int) -> int:
    """Round ``n`` up to a multiple of ``pad_multiple`` (at least one bucket)."""
    return max(pad_multiple, -(-n // pad_multiple) * pad_multiple)
