"""Finetuning: load any registered checkpoint, optionally with a new head and vocabulary.

Port of ``thunder_tpu/finetune.py::finetune_ctc_module``:

- the base checkpoint loads through :func:`~thunder_tpu_torch.registry.load_pretrained`;
- ``tokens`` and ``decoder_builder`` go together (the same two ValueErrors);
- with new tokens, a fresh text transform is built and a new head
  ``decoder_builder(num_classes=...)`` over the encoder's final dimension,
  drawn from ``seed``, while the frontend and the encoder's weights (running
  statistics included) are kept; the base's ``frozen_paths`` carry over;
- the arguments are recorded as ``module.hparams``.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional

import torch

from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.registry import load_pretrained
from thunder_tpu_torch.text.transform import BatchTextTransformer

__all__ = ["finetune_ctc_module"]


def finetune_ctc_module(
    checkpoint_name: str,
    checkpoint_kwargs: Optional[Dict[str, Any]] = None,
    decoder_builder: Optional[Callable] = None,
    decoder_kwargs: Optional[Dict[str, Any]] = None,
    tokens: Optional[List[str]] = None,
    text_kwargs: Optional[Dict[str, Any]] = None,
    seed: int = 0,
) -> CTCModule:
    """Build a CTCModule ready for finetuning from a pretrained checkpoint (``checkpoint_kwargs["device"]``
    places it, the card by default)."""
    checkpoint_kwargs = checkpoint_kwargs or {}
    decoder_kwargs = decoder_kwargs or {}
    text_kwargs = text_kwargs or {}

    if tokens is not None and decoder_builder is None:
        raise ValueError(
            "New tokens were specified, but the module also needs to know the "
            "decoder class to initialize properly."
        )
    if tokens is None and decoder_builder is not None:
        raise ValueError(
            "A new decoder was specified, but the module also needs to know the "
            "tokens to initialize properly."
        )

    base = load_pretrained(checkpoint_name, **checkpoint_kwargs)
    if tokens is None:
        module = base
    else:
        text_transform = BatchTextTransformer(tokens, **text_kwargs)
        decoder = decoder_builder(num_classes=text_transform.num_tokens, **decoder_kwargs)
        # copies: create draws every parameter of the model it assembles
        fresh = CTCModule.create(torch.Generator().manual_seed(seed), copy.deepcopy(base.model.audio_transform),
                                 copy.deepcopy(base.model.encoder), decoder, text_transform, device=base.device)
        state = fresh.model.state_dict()
        state.update({k: v for k, v in base.model.state_dict().items() if k.startswith("encoder.")})
        module = fresh.with_state(state)
        module.frozen_paths = base.frozen_paths
    module.hparams = {
        "checkpoint_name": checkpoint_name,
        "checkpoint_kwargs": checkpoint_kwargs,
        "tokens": tokens,
        "decoder_kwargs": decoder_kwargs,
        "text_kwargs": text_kwargs,
    }
    return module
