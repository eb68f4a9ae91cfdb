"""Optimizer factories.

Port of ``adamw`` and of the ``build_optimizer`` path without schedulers from
``thunder_tpu/training/optim.py``. A factory takes the parameters first and
returns a ``torch.optim.Optimizer``. ``optax.adamw`` (decoupled weight decay
on every parameter, bias-corrected moments, ``eps`` added outside the square
root) is ``torch.optim.AdamW`` with the same ``b1``, ``b2``, ``eps`` and
``weight_decay``. Learning-rate schedules (``onecycle``, plateau) and the
freeze and finetune transforms wait for a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional

import torch

__all__ = ["adamw", "build_optimizer"]


def adamw(params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-3, weight_decay: float = 1e-2,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay)


def build_optimizer(params: Iterable[torch.nn.Parameter], optimizer_builder: Callable[..., torch.optim.Optimizer] = adamw,
                    optimizer_kwargs: Optional[Dict[str, Any]] = None) -> torch.optim.Optimizer:
    """Factory + kwargs -> one optimizer over ``params`` (no learning-rate schedule)."""
    return optimizer_builder(params, **(optimizer_kwargs or {}))
