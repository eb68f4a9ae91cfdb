"""Optimizer factories, learning-rate schedules, the plateau scale and the fine-tuning freeze.

Port of ``thunder_tpu/training/optim.py``. A factory takes the parameters (or
parameter groups) first and returns a ``torch.optim.Optimizer``:

- ``optax.adamw`` (decoupled weight decay on every parameter, bias-corrected
  moments, ``eps`` added outside the square root) is ``torch.optim.AdamW``
  with the same ``b1``, ``b2``, ``eps`` and ``weight_decay``;
- ``optax.sgd`` (a momentum trace started at zero) is ``torch.optim.SGD``.

Schedules follow optax, not ``torch.optim.lr_scheduler``: a schedule is a
function of the optimizer step (0 for the first update) that gives the
learning rate that step uses. A factory given a schedule for
``learning_rate`` keeps it as the optimizer's ``lr_schedule``, and
:func:`optimizer_step` sets every group's ``lr`` from it before each update.

optax's wrappers are attributes of the optimizer that :func:`optimizer_step`
applies in optax's order:

- :func:`finetune_schedule_transform` (``optimizer.finetune``): while the
  encoder is frozen its gradients are set to zero before the clip, so they
  do not count toward the global norm, and its updates are 0; afterwards its
  updates are ``1 / encoder_initial_lr_div`` of the rest's. The encoder's
  parameters sit in their own group (:func:`finetune_param_groups`), whose
  learning rate carries that factor (an AdamW update includes the decoupled
  weight decay, so scaling the update is scaling the learning rate). The
  gradients are zeros, not ``None``: ``torch.optim.AdamW`` counts steps per
  parameter where optax keeps one count, and with zeros the encoder's bias
  correction after the unfreeze equals optax's;
- :func:`plateau_schedule_transform` (``optimizer.plateau``,
  ``optimizer.plateau_state``): optax's ``reduce_on_plateau`` multiplies the
  final updates by its scale, which is every group's learning rate times the
  scale. The scale moves only when :func:`plateau_update` is fed a
  validation loss.

:func:`trainable_parameters` is ``freeze_subtrees_transform``: a parameter
under a frozen path prefix gets no update at all (no weight decay, no
moments, no share in the gradient clip), because it is left out of the
optimizer and out of the clip.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "adamw",
    "sgd",
    "onecycle",
    "reduce_on_plateau",
    "ReduceOnPlateau",
    "PlateauState",
    "plateau_schedule_transform",
    "get_plateau_state",
    "replace_plateau_state",
    "plateau_update",
    "build_optimizer",
    "FinetuneSchedule",
    "finetune_param_groups",
    "finetune_schedule_transform",
    "trainable_parameters",
    "clip_by_global_norm_",
    "optimizer_step",
]

Schedule = Callable[[int], float]


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


def _with_learning_rate(optimizer: torch.optim.Optimizer, learning_rate) -> torch.optim.Optimizer:
    optimizer.lr_schedule = learning_rate if callable(learning_rate) else None
    return optimizer


def _initial(learning_rate) -> float:
    return float(learning_rate(0)) if callable(learning_rate) else float(learning_rate)


def adamw(params: Iterable, learning_rate=1e-3, weight_decay: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> torch.optim.AdamW:
    """``optax.adamw``; ``learning_rate`` is a number or a schedule."""
    optimizer = torch.optim.AdamW(params, lr=_initial(learning_rate), betas=(b1, b2), eps=eps,
                                  weight_decay=weight_decay)
    return _with_learning_rate(optimizer, learning_rate)


def sgd(params: Iterable, learning_rate=1e-3, momentum: float = 0.0, nesterov: bool = False) -> torch.optim.SGD:
    """``optax.sgd``; ``learning_rate`` is a number or a schedule."""
    optimizer = torch.optim.SGD(params, lr=_initial(learning_rate), momentum=momentum, nesterov=nesterov)
    return _with_learning_rate(optimizer, learning_rate)


def onecycle(max_lr: float, total_steps: int, pct_start: float = 0.3, div_factor: float = 25.0,
             final_div_factor: float = 1e4) -> Schedule:
    """``optax.cosine_onecycle_schedule``: a cosine rise from ``max_lr / div_factor`` to ``max_lr`` over the
    first ``int(pct_start * total)`` steps, a cosine fall to ``max_lr / (div_factor * final_div_factor)`` at
    step ``total``, flat after it. (``torch.optim.lr_scheduler.OneCycleLR`` puts its phase boundaries and
    its end elsewhere.)

    optax divides by the two intervals' widths, which round to zero for ``total_steps <= 3``, and the
    schedule then gives NaN; as in the JAX package, the total is clamped to the smallest one with both
    intervals at least one step.
    """
    min_total = math.ceil(max(1.0 / pct_start, 1.0 / (1.0 - pct_start)))
    total = max(total_steps, min_total)
    bounds = np.array([0, int(pct_start * total), int(total)])
    values = np.cumprod([max_lr / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])

    def schedule(step: int) -> float:
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return float(end + (start - end) / 2.0 * (np.cos(np.pi * pct) + 1))
        return float(values[-1]) if step >= bounds[-1] else 0.0

    return schedule


class PlateauState(NamedTuple):
    """``optax.contrib.ReduceLROnPlateauState``, as float32 and int numbers on the host."""

    scale: np.float32
    best_value: np.float32
    plateau_count: int
    cooldown_count: int
    count: int
    avg_value: np.float32


@dataclass(frozen=True)
class ReduceOnPlateau:
    """``optax.contrib.reduce_on_plateau``'s rule, in its float32 arithmetic (not torch's
    ``ReduceLROnPlateau``): after ``accumulation_size`` values their mean improves on the best when it is
    below ``(1 - rtol) * best - atol``; ``patience`` values without improvement multiply the scale by
    ``factor`` (not below ``min_scale``) and start ``cooldown`` values in which the count rests."""

    factor: float = 0.1
    patience: int = 10
    rtol: float = 1e-4
    atol: float = 0.0
    cooldown: int = 0
    accumulation_size: int = 1
    min_scale: float = 0.0

    def __post_init__(self):
        if not 0.0 < self.factor < 1.0:
            raise ValueError(f"Factor must be in the range (0, 1), got factor = {self.factor}.")
        if self.rtol < 0.0 or self.atol < 0.0:
            raise ValueError(f"Both rtol and atol must be non-negative, got rtol = {self.rtol} and atol = {self.atol}.")
        if self.rtol == 0.0 and self.atol == 0.0:
            raise ValueError(f"At least one of rtol or atol must be positive, got rtol = {self.rtol} and atol = "
                             f"{self.atol}.")
        if self.rtol > 1.0:
            raise ValueError(f"rtol must be less than or equal to 1.0, got rtol = {self.rtol}.")

    def init(self) -> PlateauState:
        return PlateauState(np.float32(1.0), np.float32(np.inf), 0, 0, 0, np.float32(0.0))

    def update(self, state: PlateauState, value: float) -> PlateauState:
        """The state after one monitored value."""
        f32 = np.float32
        count = state.count + 1
        avg = (f32(state.count) * state.avg_value + f32(value)) / f32(count)
        if count != self.accumulation_size:
            return state._replace(count=count, avg_value=f32(avg))
        improved = avg < f32(1 - self.rtol) * state.best_value - f32(self.atol)
        best = f32(avg) if improved else state.best_value
        plateau_count = 0 if improved else state.plateau_count + 1
        if state.cooldown_count > 0:
            plateau_count, scale, cooldown = 0, state.scale, state.cooldown_count - 1
        elif plateau_count == self.patience:
            plateau_count, cooldown = 0, self.cooldown
            scale = max(f32(state.scale * f32(self.factor)), f32(self.min_scale))
        else:
            scale, cooldown = max(state.scale, f32(self.min_scale)), 0
        return PlateauState(f32(scale), best, plateau_count, cooldown, 0, f32(0.0))


def reduce_on_plateau(**kwargs) -> ReduceOnPlateau:
    """The plateau rule, as ``Trainer(lr_scheduler_builder=reduce_on_plateau, lr_scheduler_kwargs={"factor":
    0.5, "patience": 2, ...})`` takes it: the trainer scales every update by the rule's scale, which it
    advances once per epoch with the validation loss (Lightning's ``monitor="val_loss"`` cadence)."""
    return ReduceOnPlateau(**kwargs)


#: marker read by ``Trainer.fit``: a builder with this attribute is a validation-loss-driven update scale,
#: not a per-step learning-rate schedule
reduce_on_plateau._is_plateau = True  # type: ignore[attr-defined]


def plateau_schedule_transform(optimizer: torch.optim.Optimizer, **plateau_kwargs) -> torch.optim.Optimizer:
    """Scale ``optimizer``'s final updates by a plateau rule's scale (:func:`optimizer_step` multiplies every
    group's learning rate by it); the rule's state starts at scale 1 and moves only through
    :func:`plateau_update`."""
    optimizer.plateau = reduce_on_plateau(**plateau_kwargs)
    optimizer.plateau_state = optimizer.plateau.init()
    return optimizer


def get_plateau_state(optimizer: torch.optim.Optimizer) -> PlateauState:
    """The plateau state of an optimizer wrapped by :func:`plateau_schedule_transform`."""
    state = getattr(optimizer, "plateau_state", None)
    if state is None:
        raise KeyError("the optimizer carries no ReduceLROnPlateau state; wrap it with plateau_schedule_transform "
                       f"(got {type(optimizer).__name__})")
    return state


def replace_plateau_state(optimizer: torch.optim.Optimizer, new_plateau_state: PlateauState) -> torch.optim.Optimizer:
    """Swap the optimizer's plateau state (see :func:`get_plateau_state`); the rest is untouched."""
    get_plateau_state(optimizer)
    optimizer.plateau_state = new_plateau_state
    return optimizer


def plateau_update(plateau_state: PlateauState, value: float, **plateau_kwargs) -> PlateauState:
    """Advance the plateau bookkeeping with one validation-loss value."""
    return reduce_on_plateau(**plateau_kwargs).update(plateau_state, value)


def build_optimizer(
    params: Iterable,
    optimizer_builder: Callable[..., torch.optim.Optimizer] = adamw,
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    lr_scheduler_builder: Optional[Callable[..., Schedule]] = None,
    lr_scheduler_kwargs: Optional[Dict[str, Any]] = None,
    total_steps: Optional[int] = None,
    steps_per_epoch: Optional[int] = None,
) -> torch.optim.Optimizer:
    """Builders + kwargs -> one optimizer over ``params``.

    A kwarg named ``total_steps_arg`` names the kwarg that receives ``total_steps`` (in epochs under
    ``interval="epoch"``). A scheduler kwarg ``interval="epoch"`` makes the schedule advance once per
    epoch of ``steps_per_epoch`` optimizer steps; the default is every step.
    """
    optimizer_kwargs = dict(optimizer_kwargs or {})
    lr_scheduler_kwargs = dict(lr_scheduler_kwargs or {})
    interval = lr_scheduler_kwargs.pop("interval", "step")
    for kwargs in (optimizer_kwargs, lr_scheduler_kwargs):
        arg = kwargs.pop("total_steps_arg", None)
        if arg:
            if total_steps is None:
                raise ValueError("total_steps_arg requested but total_steps unknown")
            kwargs[arg] = total_steps if interval == "step" else max(total_steps // max(steps_per_epoch or 1, 1), 1)
    if lr_scheduler_builder is not None:
        schedule = lr_scheduler_builder(**lr_scheduler_kwargs)
        if interval == "epoch":
            if not steps_per_epoch:
                raise ValueError('interval="epoch" requires steps_per_epoch')
            base = schedule
            schedule = lambda step: base(step // steps_per_epoch)  # noqa: E731
        optimizer_kwargs["learning_rate"] = schedule
    return optimizer_builder(params, **optimizer_kwargs)


@dataclass(frozen=True)
class FinetuneSchedule:
    """The encoder's freeze: frozen before ``unfreeze_encoder_at_step`` optimizer steps, then trained at
    ``1 / encoder_initial_lr_div`` of the learning rate."""

    unfreeze_encoder_at_step: int
    encoder_initial_lr_div: float = 10.0

    def frozen(self, step: int) -> bool:
        return step < self.unfreeze_encoder_at_step

    def encoder_scale(self, step: int) -> float:
        return 0.0 if self.frozen(step) else 1.0 / self.encoder_initial_lr_div


def finetune_param_groups(named_parameters: Iterable[Tuple[str, torch.nn.Parameter]],
                          encoder_path: str = "encoder") -> List[Dict[str, Any]]:
    """``named_parameters`` as two groups for :func:`finetune_schedule_transform`: those whose name starts
    with ``encoder_path`` (marked ``"encoder": True``), then the rest."""
    encoder, rest = [], []
    for name, param in named_parameters:
        (encoder if name.split(".")[0] == encoder_path else rest).append(param)
    return [{"params": encoder, "encoder": True}, {"params": rest, "encoder": False}]


def finetune_schedule_transform(optimizer: torch.optim.Optimizer, unfreeze_encoder_at_step: int,
                                encoder_initial_lr_div: float = 10.0) -> torch.optim.Optimizer:
    """Freeze the optimizer's encoder group (``"encoder": True``, from :func:`finetune_param_groups`) until a
    step, then train it at ``lr / encoder_initial_lr_div``; the other groups train normally throughout."""
    if not any(group.get("encoder") for group in optimizer.param_groups):
        raise ValueError("finetune_schedule_transform needs an encoder parameter group (finetune_param_groups)")
    optimizer.finetune = FinetuneSchedule(unfreeze_encoder_at_step, encoder_initial_lr_div)
    return optimizer


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place: unchanged below ``max_norm``,
    else ``g / norm * max_norm``. Stays on the device (no host sync)."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def optimizer_step(optimizer: torch.optim.Optimizer, step: int, gradient_clip_value: Optional[float] = None,
                   gradient_clip_norm: Optional[float] = None) -> None:
    """Apply the optimizer to its parameters' gradients as the JAX trainer's optax chain does, as its
    ``step``-th update (0 for the first):

    1. a parameter without a gradient gets zeros (a frozen feature extractor, which JAX's stop_gradient
       gives zeros: optax's AdamW still decays its weights; and the frozen encoder, see below);
    2. the fine-tuning freeze sets the encoder group's gradients to zero;
    3. the element-wise clip by ``gradient_clip_value``, then the global-norm clip by
       ``gradient_clip_norm``;
    4. each group's learning rate: the schedule at ``step`` (else the group's own), times the plateau
       scale, times the fine-tuning factor for the encoder group;
    5. the optimizer's update.
    """
    groups = optimizer.param_groups
    params = [p for group in groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    finetune: Optional[FinetuneSchedule] = getattr(optimizer, "finetune", None)
    if finetune is not None and finetune.frozen(step):
        for group in groups:
            if group.get("encoder"):
                for p in group["params"]:
                    p.grad.zero_()
    grads = [p.grad for p in params]
    if gradient_clip_value is not None:
        for g in grads:
            g.clamp_(-gradient_clip_value, gradient_clip_value)
    if gradient_clip_norm is not None:
        clip_by_global_norm_(grads, gradient_clip_norm)
    schedule = getattr(optimizer, "lr_schedule", None)
    plateau = getattr(optimizer, "plateau_state", None)
    for group in groups:
        lr = schedule(step) if schedule is not None else group.setdefault("base_lr", group["lr"])
        if plateau is not None:
            lr = lr * float(plateau.scale)
        if finetune is not None and group.get("encoder"):
            lr = lr * finetune.encoder_scale(step)
        group["lr"] = lr
    optimizer.step()
