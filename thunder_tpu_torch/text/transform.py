"""Batched text encode/decode glue.

Port of ``thunder_tpu/text/transform.py::BatchTextTransformer``: tokenize ->
add specials -> numericalize -> pad, and the inverse CTC decode (consecutive
duplicate collapse -> tokens -> string -> marker cleanup -> special-token
strip). The tokenizer is, in this order of precedence, a custom function, a
sentencepiece model (:class:`~thunder_tpu_torch.text.tokenizer.BPETokenizer`)
or the character tokenizer.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from thunder_tpu_torch.text.tokenizer import BPETokenizer, char_tokenizer
from thunder_tpu_torch.text.vocab import Vocabulary

__all__ = ["BatchTextTransformer", "char_tokenizer"]


class BatchTextTransformer:
    def __init__(
        self,
        tokens: Sequence[str],
        blank_token: str = "<blank>",
        pad_token: Optional[str] = None,
        unknown_token: Optional[str] = None,
        start_token: Optional[str] = None,
        end_token: Optional[str] = None,
        sentencepiece_model: Optional[str] = None,
        custom_tokenizer_function: Optional[Callable[[str], List[str]]] = None,
    ):
        self.vocab = Vocabulary(
            tokens,
            blank_token=blank_token,
            pad_token=pad_token,
            unknown_token=unknown_token,
            start_token=start_token,
            end_token=end_token,
        )
        if custom_tokenizer_function is not None:
            self.tokenizer = custom_tokenizer_function
        elif sentencepiece_model is not None:
            self.tokenizer = BPETokenizer(sentencepiece_model)
        else:
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

    @classmethod
    def from_sentencepiece(cls, output_dir: str) -> "BatchTextTransformer":
        """Build from a sentencepiece training output folder (``tokenizer.vocab`` and ``tokenizer.model``)."""
        special_tokens = {"<s>", "</s>", "<pad>", "<unk>"}
        vocab: List[str] = []
        with open(f"{output_dir}/tokenizer.vocab", "r", encoding="utf-8") as f:
            for line in f:
                piece = line.split("\t")[0]
                if piece not in special_tokens:
                    vocab.append(piece)
        return cls(tokens=vocab, sentencepiece_model=f"{output_dir}/tokenizer.model")

    @property
    def num_tokens(self) -> int:
        return len(self.vocab)
