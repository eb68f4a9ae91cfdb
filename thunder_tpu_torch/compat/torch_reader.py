"""Read a ``torch.save`` checkpoint into numpy arrays.

Port of ``thunder_tpu/compat/torch_reader.py``. NeMo ``.nemo`` archives hold a
``model_weights.ckpt`` written by ``torch.save``; the JAX package reads it
with its own restricted unpickler, since it does not need torch. The port has
torch, so this is ``torch.load(weights_only=True)``: the same restricted
reading of tensors and containers, for the zip container and the legacy
sequential one. bfloat16 tensors come out as float32, as the JAX reader gives
them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["load_torch_checkpoint"]


def _numpy(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        value = value.detach()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return value


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a torch checkpoint into a flat ``{key: numpy array}`` dict."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not hasattr(obj, "items"):
        raise ValueError(f"checkpoint at {path} did not contain a state dict")
    return {key: _numpy(value) for key, value in obj.items()}
