"""Speech datasets: template-method base + NeMo manifest reader.

Port of ``thunder_tpu/data/dataset.py``: subclass hooks ``get_item /
open_audio / preprocess_audio / open_text / preprocess_text``,
``all_outputs()`` for vocab building, and a JSON-lines NeMo-manifest
dataset. Pure host-side numpy.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, List, Sequence, Tuple, Union

import numpy as np

from thunder_tpu_torch.data.audio_io import AudioFileLoader

__all__ = ["BaseSpeechDataset", "ManifestSpeechDataset"]


class BaseSpeechDataset:
    def __init__(self, items: Sequence, force_mono: bool = True, sample_rate: int = 16000):
        """Minimal speech dataset over an arbitrary item source.

        Args:
            items: sequence describing each example (paths, dataframe rows...).
            force_mono / sample_rate: see ``AudioFileLoader``.
        """
        self.items = items
        self.loader = AudioFileLoader(force_mono=force_mono, sample_rate=sample_rate)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, str]:
        item = self.get_item(index)
        audio, sr = self.open_audio(item)
        audio = self.preprocess_audio(audio, sr)
        text = self.preprocess_text(self.open_text(item))
        return audio, text

    def all_outputs(self) -> List[str]:
        """All (preprocessed) transcripts — for vocab building / LM training."""
        out = []
        for index in range(len(self)):
            item = self.get_item(index)
            out.append(self.preprocess_text(self.open_text(item)))
        return out

    # -- hooks -------------------------------------------------------------

    def get_item(self, index: int) -> Any:
        return self.items[index]

    def open_audio(self, item: Any) -> Tuple[np.ndarray, int]:
        return self.loader.open_audio(item)

    def preprocess_audio(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        return self.loader.preprocess_audio(audio, sample_rate)

    def open_text(self, item: Any) -> str:
        raise NotImplementedError()

    def preprocess_text(self, text: str) -> str:
        return text


class ManifestSpeechDataset(BaseSpeechDataset):
    """NeMo JSON-lines manifest: {"audio_filepath": ..., "text": ..., "duration": ...}."""

    def __init__(self, file: Union[str, Path], force_mono: bool = True, sample_rate: int = 16000):
        file = Path(file)
        items = [json.loads(line) for line in file.read_text().strip().splitlines()]
        super().__init__(items, force_mono=force_mono, sample_rate=sample_rate)

    def open_audio(self, item: dict) -> Tuple[np.ndarray, int]:
        return self.loader.open_audio(item["audio_filepath"])

    def open_text(self, item: dict) -> str:
        return item["text"]
