"""Data modules: bucketed, prefetching batch iterators over speech datasets.

Port of ``thunder_tpu/data/datamodule.py``: ``train_dataloader()``-style
methods return iterators of ``(padded_audio, lengths, texts)`` numpy batches.
Item loading runs in a thread pool, two batches ahead of the one being
consumed, overlapping host IO with the card's steps; length-sorted batching
keeps padding waste low, and batches are shuffled by ``seed + epoch``.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from thunder_tpu_torch.data.collate import asr_collate
from thunder_tpu_torch.data.dataset import BaseSpeechDataset, ManifestSpeechDataset

__all__ = ["DataLoader", "BaseDataModule", "ManifestDatamodule"]

Batch = Tuple[np.ndarray, np.ndarray, List[str]]


class DataLoader:
    """Threaded map-style loader with length-aware batching."""

    def __init__(
        self,
        dataset: BaseSpeechDataset,
        batch_size: int = 10,
        shuffle: bool = False,
        num_workers: int = 8,
        pad_multiple: int = 16000,
        sort_by_duration: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.pad_multiple = pad_multiple
        self.sort_by_duration = sort_by_duration
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _durations(self) -> Optional[List[float]]:
        items = getattr(self.dataset, "items", None)
        if not items:
            return None
        if isinstance(items[0], dict) and "duration" in items[0]:
            return [it["duration"] for it in items]
        # fall back to header-only reads for manifest entries without a duration field or plain path items;
        # a file the reader refuses leaves the batches unsorted
        from thunder_tpu_torch.utils import audio_len

        try:
            if isinstance(items[0], dict) and "audio_filepath" in items[0]:
                return [audio_len(it["audio_filepath"]) for it in items]
            if isinstance(items[0], (str,)) or hasattr(items[0], "__fspath__"):
                return [audio_len(it) for it in items]
        except (OSError, ValueError, NotImplementedError):
            pass
        return None

    def _batch_indices(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        durations = self._durations() if self.sort_by_duration else None
        if durations is not None:
            # length-sorted batching: similar-length samples batch together,
            # minimizing padding waste; batch order is shuffled
            idx.sort(key=lambda i: durations[i])
        elif self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        batches = [idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(batches)
        return batches

    def __iter__(self) -> Iterator[Batch]:
        batches = self._batch_indices()
        self.epoch += 1
        prefetch = 2  # batches in flight beyond the one being consumed
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window: list = []
            nxt = 0
            while nxt < len(batches) and len(window) <= prefetch:
                window.append([pool.submit(self.dataset.__getitem__, i) for i in batches[nxt]])
                nxt += 1
            while window:
                batch_futures = window.pop(0)
                if nxt < len(batches):
                    window.append([pool.submit(self.dataset.__getitem__, i) for i in batches[nxt]])
                    nxt += 1
                samples = [f.result() for f in batch_futures]
                yield asr_collate(samples, pad_multiple=self.pad_multiple)


class BaseDataModule:
    def __init__(self, batch_size: int = 10, num_workers: int = 8, pad_multiple: int = 16000):
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.pad_multiple = pad_multiple
        self.train_dataset: Optional[BaseSpeechDataset] = None
        self.val_dataset: Optional[BaseSpeechDataset] = None
        self.test_dataset: Optional[BaseSpeechDataset] = None

    def get_dataset(self, split: str) -> BaseSpeechDataset:
        raise NotImplementedError()

    def setup(self, stage: Optional[str] = None):
        if stage in (None, "fit"):
            self.train_dataset = self.get_dataset("train")
            self.val_dataset = self.get_dataset("valid")
        if stage in (None, "test"):
            self.test_dataset = self.get_dataset("test")

    def _loader(self, dataset, shuffle) -> DataLoader:
        return DataLoader(
            dataset,
            batch_size=self.batch_size,
            shuffle=shuffle,
            num_workers=self.num_workers,
            pad_multiple=self.pad_multiple,
        )

    def train_dataloader(self) -> DataLoader:
        return self._loader(self.train_dataset, shuffle=True)

    def val_dataloader(self) -> DataLoader:
        return self._loader(self.val_dataset, shuffle=False)

    def test_dataloader(self) -> DataLoader:
        return self._loader(self.test_dataset, shuffle=False)

    @property
    def steps_per_epoch(self) -> int:
        return len(self.train_dataset) // self.batch_size


class ManifestDatamodule(BaseDataModule):
    """Three NeMo manifests (train/val/test) -> datamodule."""

    def __init__(
        self,
        train_manifest: str,
        val_manifest: str,
        test_manifest: str,
        force_mono: bool = True,
        sample_rate: int = 16000,
        batch_size: int = 10,
        num_workers: int = 8,
        pad_multiple: int = 16000,
    ):
        super().__init__(batch_size=batch_size, num_workers=num_workers, pad_multiple=pad_multiple)
        self.manifest_mapping = {"train": train_manifest, "valid": val_manifest, "test": test_manifest}
        self.force_mono = force_mono
        self.sample_rate = sample_rate

    def get_dataset(self, split: str) -> ManifestSpeechDataset:
        return ManifestSpeechDataset(
            self.manifest_mapping[split], force_mono=self.force_mono, sample_rate=self.sample_rate
        )
