"""Batched text encode/decode glue (character tokenizer).

Port of the character-tokenizer path of
``thunder_tpu/text/transform.py::BatchTextTransformer``: tokenize -> add
specials -> numericalize -> pad, and the inverse CTC decode (consecutive
duplicate collapse -> tokens -> string -> marker cleanup -> special-token
strip). Sentencepiece (BPE) tokenizers wait for a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from thunder_tpu_torch.text.vocab import Vocabulary

__all__ = ["BatchTextTransformer", "char_tokenizer"]


def char_tokenizer(text: str) -> List[str]:
    """Character split."""
    return list(text)


class BatchTextTransformer:
    def __init__(
        self,
        tokens: Sequence[str],
        blank_token: str = "<blank>",
        pad_token: Optional[str] = None,
        unknown_token: Optional[str] = None,
        start_token: Optional[str] = None,
        end_token: Optional[str] = None,
    ):
        self.vocab = Vocabulary(
            tokens,
            blank_token=blank_token,
            pad_token=pad_token,
            unknown_token=unknown_token,
            start_token=start_token,
            end_token=end_token,
        )
        self.tokenizer = char_tokenizer

    def encode(
        self, items: Sequence[str], return_length: bool = True, pad_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray] | np.ndarray:
        """Texts -> padded int32 array (+ lengths); ``pad_to`` fixes the width."""
        encoded = [self.vocab.numericalize(self.vocab.add_special_tokens(list(self.tokenizer(t)))) for t in items]
        lengths = np.asarray([len(e) for e in encoded], dtype=np.int32)
        width = pad_to if pad_to is not None else max(1, int(lengths.max(initial=1)))
        if int(lengths.max(initial=0)) > width:
            raise ValueError(
                f"pad_to={width} is smaller than the longest encoded text "
                f"({int(lengths.max())} tokens); truncating would corrupt CTC targets"
            )
        batch = np.full((len(encoded), width), self.vocab.pad_idx, dtype=np.int32)
        for i, e in enumerate(encoded):
            batch[i, : len(e)] = e
        if return_length:
            return batch, lengths
        return batch

    def decode_prediction(self, predictions, remove_repeated: bool = True) -> List[str]:
        """``(batch, time)`` argmax ids -> list of strings."""
        out: List[str] = []
        for row in np.asarray(predictions):
            if remove_repeated and row.size:
                keep = np.ones(row.shape, dtype=bool)
                keep[1:] = row[1:] != row[:-1]
                row = row[keep]
            text = "".join(self.vocab.decode_into_text(row))
            text = text.replace("▁", " ").replace("|", " ")
            out.append(self.vocab.remove_special_tokens(text))
        return out

    @property
    def num_tokens(self) -> int:
        return len(self.vocab)
