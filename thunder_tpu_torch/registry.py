"""The checkpoint registry and ``load_pretrained``.

Port of ``thunder_tpu/registry.py``:

- every member of a checkpoint enum registers a loader partial;
- ``load_pretrained(name)`` dispatches: a local ``.nemo`` file goes to the
  Citrinet loader when the archive holds a ``.model`` (sentencepiece) file
  and to the QuartzNet loader otherwise; other names with "/" go to the
  HuggingFace loader; everything else through the registry.

``load_kwargs`` go to the loader: ``device`` (the card unless the caller asks
for the CPU), ``save_folder`` and ``augment_params`` for NeMo, model keywords
for HuggingFace.
"""

from __future__ import annotations

import tarfile
from functools import partial
from pathlib import Path
from typing import Callable, Dict, Type, Union

from thunder_tpu_torch.compat.nemo import (
    CitrinetCheckpoint,
    QuartznetCheckpoint,
    load_citrinet_checkpoint,
    load_quartznet_checkpoint,
)
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.utils import BaseCheckpoint

__all__ = ["CHECKPOINT_REGISTRY", "register_checkpoint_enum", "load_pretrained"]

CHECKPOINT_LOAD_FUNC_TYPE = Callable[..., CTCModule]

CHECKPOINT_REGISTRY: Dict[str, CHECKPOINT_LOAD_FUNC_TYPE] = {}


def register_checkpoint_enum(checkpoints: Type[BaseCheckpoint], load_function: CHECKPOINT_LOAD_FUNC_TYPE):
    """Register every member of a checkpoint enum with its loading function."""
    for checkpoint in checkpoints:
        CHECKPOINT_REGISTRY[checkpoint.name] = partial(load_function, checkpoint)


register_checkpoint_enum(QuartznetCheckpoint, load_quartznet_checkpoint)
register_checkpoint_enum(CitrinetCheckpoint, load_citrinet_checkpoint)


def load_pretrained(checkpoint_name: Union[str, BaseCheckpoint], **load_kwargs) -> CTCModule:
    """Load any checkpoint: a registry name, a local ``.nemo`` path or a HuggingFace id or folder."""
    if isinstance(checkpoint_name, BaseCheckpoint):
        checkpoint_name = checkpoint_name.name
    name = str(checkpoint_name)
    if name.endswith(".nemo"):
        if not Path(name).exists():
            raise FileNotFoundError(f"checkpoint file not found: {name}")
        with tarfile.open(name) as tar:
            has_tokenizer = any(member.endswith(".model") for member in tar.getnames())
        if has_tokenizer:
            return load_citrinet_checkpoint(name, **load_kwargs)
        return load_quartznet_checkpoint(name, **load_kwargs)
    if "/" in name:
        from thunder_tpu_torch.compat.hf import load_huggingface_checkpoint

        return load_huggingface_checkpoint(name, **load_kwargs)
    return CHECKPOINT_REGISTRY[name](**load_kwargs)
