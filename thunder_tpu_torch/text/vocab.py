"""Vocabulary: token <-> id mapping with CTC-special-token handling.

Port of ``thunder_tpu/text/vocab.py`` (host-side, numpy):

- special tokens are appended to the base token list only when absent;
- ``pad_token`` defaults to the blank token;
- ``numericalize`` drops OOV tokens when there is no unknown token, else maps
  them to unk.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["Vocabulary"]


class Vocabulary:
    def __init__(
        self,
        tokens: Sequence[str],
        blank_token: str = "<blank>",
        pad_token: Optional[str] = None,
        unknown_token: Optional[str] = None,
        start_token: Optional[str] = None,
        end_token: Optional[str] = None,
    ):
        self.blank_token = blank_token
        self.pad_token = pad_token or blank_token
        self.unknown_token = unknown_token
        self.start_token = start_token
        self.end_token = end_token

        itos = list(tokens)
        for tok in (blank_token, pad_token, unknown_token, start_token, end_token):
            if tok and tok not in itos:
                itos.append(tok)
        self.itos: List[str] = itos
        self.stoi = {token: i for i, token in enumerate(itos)}

        self.blank_idx = self.stoi[self.blank_token]
        self.pad_idx = self.stoi[self.pad_token]
        self._unk_idx = self.stoi[unknown_token] if unknown_token is not None else -1

    def __len__(self) -> int:
        return len(self.itos)

    def numericalize(self, tokens: Sequence[str]) -> np.ndarray:
        """Tokens -> int32 id array; OOV filtered (no unk) or mapped to unk."""
        if self.unknown_token is None:
            ids = [self.stoi[t] for t in tokens if t in self.stoi]
        else:
            ids = [self.stoi.get(t, self._unk_idx) for t in tokens]
        return np.asarray(ids, dtype=np.int32)

    def decode_into_text(self, indices) -> List[str]:
        """Id sequence -> token strings."""
        return [self.itos[int(i)] for i in indices]

    def add_special_tokens(self, tokens: List[str]) -> List[str]:
        if self.start_token is not None:
            tokens = [self.start_token] + tokens
        if self.end_token is not None:
            tokens = tokens + [self.end_token]
        return tokens

    def remove_special_tokens(self, text: str) -> str:
        text = text.replace(self.blank_token, "")
        text = text.replace(self.pad_token, "")
        if self.start_token is not None:
            text = text.replace(self.start_token, "")
        if self.end_token is not None:
            text = text.replace(self.end_token, "")
        return text
