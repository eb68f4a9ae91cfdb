"""Utility helpers: cache folder, file walking, checkpoint download, checkpoint enums.

Port of ``thunder_tpu/utils.py`` (urllib, no extra package), with the port's
own cache folder, ``~/.thunder_tpu_torch``; ``audio_len`` reads WAV headers
(``data/audio_io.py``).
"""

from __future__ import annotations

import functools
import os
import urllib.request
from enum import Enum
from pathlib import Path
from typing import Callable, List, Union

__all__ = [
    "audio_len",
    "get_default_cache_folder",
    "get_files",
    "chain_calls",
    "BaseCheckpoint",
    "download_checkpoint",
]


def audio_len(item: Union[Path, str]) -> float:
    """Duration in seconds of an audio file (header read only)."""
    from thunder_tpu_torch.data.audio_io import audio_info

    info = audio_info(str(item))
    return info.num_frames / info.sample_rate


def get_default_cache_folder() -> Path:
    """``~/.thunder_tpu_torch`` (created on first use)."""
    folder = Path.home() / ".thunder_tpu_torch"
    folder.mkdir(exist_ok=True)
    return folder


def get_files(directory: Union[str, Path], extension: str) -> List[Path]:
    """Recursively list files under ``directory`` ending in ``extension``."""
    found: List[Path] = []
    for root, _, files in os.walk(directory, followlinks=True):
        found += [Path(root) / f for f in files if f.endswith(extension)]
    return found


def chain_calls(*funcs: Callable) -> Callable:
    """Compose single-argument functions left to right."""

    def _inner(arg):
        return functools.reduce(lambda x, f: f(x), funcs, arg)

    return _inner


class BaseCheckpoint(str, Enum):
    """Base class of the pretrained checkpoint enums (name -> URL)."""

    @classmethod
    def from_string(cls, name: str) -> "BaseCheckpoint":
        try:
            return cls[name]
        except KeyError as err:
            raise ValueError("Name provided is not a valid checkpoint") from err


def download_checkpoint(name: BaseCheckpoint, checkpoint_folder: str | None = None) -> Path:
    """The checkpoint file of an enum member: the cached copy in ``checkpoint_folder``, else downloaded there."""
    if checkpoint_folder is None:
        checkpoint_folder = get_default_cache_folder()
    url = name.value
    path = Path(checkpoint_folder) / url.split("/")[-1]
    if not path.exists():
        urllib.request.urlretrieve(url, str(path))
    return path
