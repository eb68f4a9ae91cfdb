"""Text preprocessing: lowercase, accent strip, number expansion.

Port of ``thunder_tpu/text/preprocess.py``, using the in-repo
:mod:`thunder_tpu_torch.text.numbers` instead of the num2words package.
"""

from __future__ import annotations

import re
import unicodedata

from thunder_tpu_torch.text.numbers import num2words

__all__ = ["lower_text", "normalize_text", "expand_numbers"]

_NUMBER_RE = re.compile(r"\d+º*")


def lower_text(text: str) -> str:
    """Lowercase the text."""
    return text.lower()


def normalize_text(text: str) -> str:
    """NFKD-normalize and strip everything non-ASCII (accent removal)."""
    nfkd = unicodedata.normalize("NFKD", text)
    return nfkd.encode("ASCII", "ignore").decode()


def expand_numbers(text: str, language: str = "en") -> str:
    """Replace digit runs with their spelled-out form; ``42º`` -> ordinal."""
    for num in _NUMBER_RE.findall(text):
        if "º" in num:
            expanded = num2words(int(num.replace("º", "").strip()), lang=language, to="ordinal")
        else:
            expanded = num2words(int(num), lang=language)
        text = text.replace(num, expanded)
    return text
