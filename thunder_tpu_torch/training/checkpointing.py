"""Module checkpoints and checkpoint tree migrations.

Port of ``save_module``, ``restore_module_variables`` and
``migrate_fused_qkv`` from ``thunder_tpu/training/checkpointing.py``:

- ``save_module`` / ``restore_module_variables`` keep a module's weights (its
  model's ``state_dict``: parameters and batch-norm running statistics) with
  ``torch.save`` / ``torch.load(weights_only=True)``, where the JAX package
  keeps its variables with Orbax;
- ``migrate_fused_qkv`` is pure numpy on nested dicts, lists, tuples and
  namedtuples, so a parameter or optimizer-moment tree saved by either
  package goes through it.

Saving and restoring train state is not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["migrate_fused_qkv", "save_module", "restore_module_variables"]

#: the weights' file name inside a checkpoint folder
MODULE_FILE = "module.pt"


def save_module(directory: str, module) -> str:
    """Save a CTCModule's weights (an inference checkpoint) as ``directory/module.pt``; returns its path."""
    path = Path(directory).absolute() / MODULE_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.model.state_dict().items()}, path)
    return str(path)


def restore_module_variables(path: str, module):
    """A copy of ``module`` holding the weights saved at ``path`` (strict: the same keys and shapes)."""
    return module.with_state(torch.load(path, map_location="cpu", weights_only=True))


def migrate_fused_qkv(tree):
    """Fuse wav2vec2 attention trees with separate q/k/v projections into the
    ``qkv_proj`` layout. Returns ``(tree, changed)``.

    Applies to any nested dict level holding all three ``{q,k,v}_proj``
    subtrees, params and optimizer-moment trees alike (Adam's moments mirror
    the parameter structure, so their kernels concatenate identically).
    """
    changed = False

    def walk(d):
        nonlocal changed
        if hasattr(d, "_fields"):  # namedtuple (optimizer states)
            return type(d)(*(walk(v) for v in d))
        if isinstance(d, (list, tuple)):
            seq = [walk(v) for v in d]
            return seq if isinstance(d, list) else tuple(seq)
        if not isinstance(d, dict):
            return d
        out = {k: walk(v) for k, v in d.items()}
        if {"q_proj", "k_proj", "v_proj"} <= set(out) and "qkv_proj" not in out:
            q, k, v = out.pop("q_proj"), out.pop("k_proj"), out.pop("v_proj")
            out["qkv_proj"] = {
                name: np.concatenate([np.asarray(q[name]), np.asarray(k[name]), np.asarray(v[name])], axis=-1)
                for name in q
                if name in k and name in v
            }
            changed = True
        return out

    return walk(tree), changed
