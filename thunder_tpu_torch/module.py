"""CTCModule: the user-facing model container (greedy serving path).

Port of ``CTCModel``, ``CTCModule.create``/``forward``/``predict`` and
``pad_to_bucket`` from ``thunder_tpu/module.py``. The compute graph is one
``nn.Module`` (``CTCModel`` = audio_transform -> encoder -> decoder) on an
explicit device; audio is padded to a bucket multiple on the host, and
variable lengths travel as ``(tensor, lengths)`` pairs.

A ``cuda`` device that is not available raises: nothing here moves work to
the CPU on its own.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from thunder_tpu_torch.data.collate import bucket_length
from thunder_tpu_torch.models.layers import init_parameters
from thunder_tpu_torch.ops.ctc import collapse_ctc, greedy_decode
from thunder_tpu_torch.text.transform import BatchTextTransformer

__all__ = ["CTCModel", "CTCModule", "pad_to_bucket", "require_device"]


def require_device(device) -> torch.device:
    """``torch.device(device)``, raising if it is a CUDA device and no GPU is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


def pad_to_bucket(n: int, multiple: int = 16000) -> int:
    """Round up to the padding bucket (the data pipeline's ``bucket_length``)."""
    return bucket_length(n, multiple)


def to_device(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a ``dtype`` tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def host_batch(audio, lengths, pad_multiple: int) -> Tuple[np.ndarray, np.ndarray]:
    """Audio (one clip or a batch) -> bucket-padded float32 ``(B, T)`` and int32 lengths."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    if lengths is None:
        lengths = np.full((audio.shape[0],), audio.shape[-1], dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    bucket = pad_to_bucket(audio.shape[-1], pad_multiple)
    if bucket != audio.shape[-1]:
        audio = np.pad(audio, ((0, 0), (0, bucket - audio.shape[-1])))
    return audio, lengths


def decode_greedy(text_transform: BatchTextTransformer, preds: torch.Tensor, out_lengths: torch.Tensor) -> List[str]:
    """Device argmax ids -> host CTC collapse -> strings."""
    collapsed = collapse_ctc(preds.cpu().numpy(), out_lengths.cpu().numpy())
    # repeats already collapsed on ids; decode must not re-collapse
    return [text_transform.decode_prediction(c[None], remove_repeated=False)[0] for c in collapsed]


class CTCModel(nn.Module):
    """audio ``(B, T)`` -> logits ``(B, frames, vocab)``."""

    def __init__(self, audio_transform: nn.Module, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.audio_transform = audio_transform
        self.encoder = encoder
        self.decoder = decoder
        if decoder.in_features is None:
            decoder.build(encoder.final_dimension)

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor, train: bool = False):
        feats, feat_lengths = self.audio_transform(audio, lengths, train=train)
        encoded, out_lengths = self.encoder(feats, feat_lengths, train=train)
        return self.decoder(encoded, train=train), out_lengths


@dataclass
class CTCModule:
    """Model + text transform on one device, with inference conveniences."""

    model: CTCModel
    text_transform: Optional[BatchTextTransformer]
    device: torch.device
    pad_multiple: int = 16000

    @classmethod
    def create(
        cls,
        generator: torch.Generator,
        audio_transform: nn.Module,
        encoder: nn.Module,
        decoder: nn.Module,
        text_transform: Optional[BatchTextTransformer] = None,
        device="cpu",
    ) -> "CTCModule":
        """Assemble the model, draw its parameters from ``generator`` (a CPU
        generator, so the draw does not depend on the device) and move it to
        ``device``."""
        device = require_device(device)
        model = CTCModel(audio_transform, encoder, decoder)
        init_parameters(model, generator)
        return cls(model=model.eval().to(device), text_transform=text_transform, device=device)

    def to(self, device) -> "CTCModule":
        """A copy of this module on another device."""
        device = require_device(device)
        return replace(self, model=copy.deepcopy(self.model).to(device), device=device)

    @property
    def blank_idx(self) -> int:
        return self.text_transform.vocab.blank_idx if self.text_transform else 0

    @torch.inference_mode()
    def forward(self, audio, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded audio batch -> ``(logits, logit_lengths)`` on the module's device."""
        return self.model(to_device(audio, torch.float32, self.device), to_device(lengths, torch.int32, self.device))

    __call__ = forward

    def predict(self, audio, lengths=None) -> List[str]:
        """Audio batch (or one clip) -> greedy CTC transcriptions."""
        if self.text_transform is None:
            raise ValueError("predict requires a text_transform")
        audio, lengths = host_batch(audio, lengths, self.pad_multiple)
        logits, out_lengths = self.forward(audio, lengths)
        return decode_greedy(self.text_transform, greedy_decode(logits), out_lengths)
