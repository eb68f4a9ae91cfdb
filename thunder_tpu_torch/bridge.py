"""Weights between the JAX package's flax variables and the port's modules.

The port's modules mirror the flax module names and keep the WIO conv layout,
so a flax path maps onto a ``state_dict`` key by joining with ``.``, after
dropping the ``conv`` level that flax's ``nn.Conv`` adds inside each masked
conv and decoder:

    params/encoder/block1/rep0/depthwise/conv/kernel  <->  encoder.block1.rep0.depthwise.kernel
    params/encoder/block1/rep0/bn/scale               <->  encoder.block1.rep0.bn.scale
    batch_stats/encoder/block1/rep0/bn/var            <->  encoder.block1.rep0.bn.var
    params/decoder/conv/bias                          <->  decoder.bias

The flax tree comes in as numpy arrays (``params`` plus ``batch_stats``),
so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["from_flax_variables"]


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_flax_variables(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params": ..., "batch_stats": ...}`` of numpy arrays -> a ``state_dict``."""
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables_np.get(collection, {})):
            if collection == "params" and len(path) >= 2 and path[-2] == "conv" and path[-1] in ("kernel", "bias"):
                path = path[:-2] + path[-1:]
            state[".".join(path)] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state
