"""Optimizer factories.

Port of ``adamw`` and of the ``build_optimizer`` path without schedulers from
``thunder_tpu/training/optim.py``. A factory takes the parameters first and
returns a ``torch.optim.Optimizer``. ``optax.adamw`` (decoupled weight decay
on every parameter, bias-corrected moments, ``eps`` added outside the square
root) is ``torch.optim.AdamW`` with the same ``b1``, ``b2``, ``eps`` and
``weight_decay``.

:func:`trainable_parameters` is ``freeze_subtrees_transform``: a parameter
under a frozen path prefix gets no update at all (no weight decay, no
moments, no share in the gradient clip), because it is left out of the
optimizer and out of the clip. Learning-rate schedules (``onecycle``,
plateau) and the finetune transform wait for a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

__all__ = ["adamw", "build_optimizer", "trainable_parameters"]


def trainable_parameters(model: torch.nn.Module,
                         frozen_paths: Optional[Sequence[Tuple[str, ...]]]) -> List[torch.nn.Parameter]:
    """The parameters of ``model`` that training updates, in ``parameters()`` order.

    A parameter whose name, split at the dots, starts with one of
    ``frozen_paths`` is left out and set to ``requires_grad=False``, so the
    backward computes no gradient for it either.
    """
    frozen = [tuple(p) for p in frozen_paths or ()]
    trainable = []
    for name, param in model.named_parameters():
        parts = tuple(name.split("."))
        if any(parts[: len(prefix)] == prefix for prefix in frozen):
            param.requires_grad_(False)
        else:
            trainable.append(param)
    return trainable


def adamw(params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-3, weight_decay: float = 1e-2,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay)


def build_optimizer(params: Iterable[torch.nn.Parameter], optimizer_builder: Callable[..., torch.optim.Optimizer] = adamw,
                    optimizer_kwargs: Optional[Dict[str, Any]] = None) -> torch.optim.Optimizer:
    """Factory + kwargs -> one optimizer over ``params`` (no learning-rate schedule)."""
    return optimizer_builder(params, **(optimizer_kwargs or {}))
