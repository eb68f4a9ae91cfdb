"""Checkpoint tree migrations.

Port of ``migrate_fused_qkv`` from ``thunder_tpu/training/checkpointing.py``:
pure numpy on nested dicts, lists, tuples and namedtuples, so a parameter or
optimizer-moment tree saved by either package goes through it. Saving and
restoring train state is not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["migrate_fused_qkv"]


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
