"""WER / CER accumulators (host side).

Port of ``thunder_tpu/training/metrics.py``: the edit distance runs in the
port's C++ runtime (:func:`thunder_tpu_torch.native.native_edit_distance`)
where it builds, else in Python (the same distance). Both rates are
edit-distance ratios accumulated as (total edits, total reference length).
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["edit_distance", "ErrorRate", "CharErrorRate", "WordErrorRate", "wer", "cer"]


def _edit_distance_py(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance, O(len(a)*len(b)) with two rows."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two sequences (the native kernel where it builds)."""
    from thunder_tpu_torch.native import native_available, native_edit_distance

    if not native_available():
        return _edit_distance_py(a, b)
    if isinstance(a, str) and isinstance(b, str):
        return native_edit_distance(a, b)
    # map arbitrary hashable tokens (e.g. words) onto ints for the C kernel
    ids: dict = {}
    enc = lambda seq: [ids.setdefault(t, len(ids)) for t in seq]  # noqa: E731
    return native_edit_distance(enc(a), enc(b))


class ErrorRate:
    """Accumulating edit-distance error rate: sum(edits) / sum(ref tokens)."""

    def __init__(self, tokenize):
        self._tokenize = tokenize
        self.errors = 0
        self.total = 0

    def update(self, predictions: List[str], references: List[str]):
        for pred, ref in zip(predictions, references):
            p, r = self._tokenize(pred), self._tokenize(ref)
            self.errors += edit_distance(p, r)
            self.total += len(r)

    def compute(self) -> float:
        return self.errors / max(self.total, 1)

    def __call__(self, predictions: List[str], references: List[str]) -> float:
        self.update(predictions, references)
        return self.compute()


class CharErrorRate(ErrorRate):
    def __init__(self):
        super().__init__(list)


class WordErrorRate(ErrorRate):
    def __init__(self):
        super().__init__(str.split)


def wer(predictions: List[str], references: List[str]) -> float:
    """One-shot word error rate."""
    return WordErrorRate()(predictions, references)


def cer(predictions: List[str], references: List[str]) -> float:
    """One-shot character error rate."""
    return CharErrorRate()(predictions, references)
