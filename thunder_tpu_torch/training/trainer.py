"""Training loop: the CTC train and eval steps, callbacks, ``fit`` and ``validate``.

Port of the single-device path of ``thunder_tpu/training/trainer.py``:

- :class:`TrainStep` is ``_train_step_body`` / ``make_train_step``: the
  model's train-mode forward, ``calculate_ctc`` (with ``sample_weights``),
  the backward, and once every ``accumulate_grad_batches`` calls (optax's
  ``MultiSteps``: the mean of the micro-batch gradients) the optimizer update
  of :func:`~thunder_tpu_torch.training.optim.optimizer_step`: optax's
  wrappers in the JAX trainer's order (the schedule, the value clip then the
  norm clip, the fine-tuning freeze, the accumulation, the plateau scale
  outermost); schedules count optimizer steps;
- a module's ``frozen_paths`` (``freeze_subtrees_transform``) keep their
  parameters out of the optimizer and the clip
  (:func:`~thunder_tpu_torch.training.optim.trainable_parameters`): they
  are not updated at all;
- :func:`eval_step` is ``make_eval_step``;
- :class:`FinetuneEncoderDecoder` and :class:`EarlyStopping` are the JAX
  callbacks;
- :class:`Trainer` keeps the JAX ``Trainer``'s fields and defaults, on the
  card unless ``device`` says otherwise. ``seed`` feeds one explicit
  generator on the device, which draws every random number of training
  (dither, masks, dropout, the training kernels' seeds); a checkpoint keeps
  its state, so a run resumed with ``resume_from`` replays the uninterrupted
  one.

Not ported (``ROADMAP.md``): meshes and model parallelism (``mesh``,
``model_parallel``), ``steps_per_execution`` (a CUDA graph of the train
step), and ``prng_impl``, which has no counterpart.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from thunder_tpu_torch.module import CTCModule, decode_greedy, require_device, to_device
from thunder_tpu_torch.ops.ctc import calculate_ctc, greedy_decode
from thunder_tpu_torch.training.checkpointing import load_train_state, restore_checkpoint, save_checkpoint, train_state
from thunder_tpu_torch.training.metrics import CharErrorRate, WordErrorRate
from thunder_tpu_torch.training.optim import (
    adamw,
    build_optimizer,
    clip_by_global_norm_,
    finetune_param_groups,
    finetune_schedule_transform,
    get_plateau_state,
    optimizer_step,
    plateau_schedule_transform,
    plateau_update,
    replace_plateau_state,
    trainable_parameters,
)

__all__ = ["TrainStep", "Trainer", "FinetuneEncoderDecoder", "EarlyStopping", "eval_step", "clip_by_global_norm_"]


@dataclass
class FinetuneEncoderDecoder:
    """Encoder freeze/unfreeze schedule: the encoder's updates are zero until
    ``unfreeze_encoder_at_epoch`` and scaled by ``1/encoder_initial_lr_div``
    afterwards. The running statistics keep moving in the frozen phase
    (``train_batchnorm``: they always do in train mode here, as with
    Lightning's ``BaseFinetuning(train_bn=True)``)."""

    unfreeze_encoder_at_epoch: int = 1
    encoder_initial_lr_div: float = 10.0
    train_batchnorm: bool = True

    def wrap(self, optimizer: torch.optim.Optimizer, steps_per_epoch: int) -> torch.optim.Optimizer:
        return finetune_schedule_transform(optimizer, self.unfreeze_encoder_at_epoch * steps_per_epoch,
                                           self.encoder_initial_lr_div)


@dataclass
class EarlyStopping:
    """Stop ``fit`` when a validation metric stops improving (Lightning's ``EarlyStopping``).

    Checked once per epoch after validation; an epoch improves when the
    monitored value beats the best seen by more than ``min_delta`` in the
    given ``mode``; after ``patience`` epochs in a row without improvement
    the fit loop ends (the returned module holds the last epoch's weights).
    """

    monitor: str = "loss/val_loss"
    patience: int = 3
    min_delta: float = 0.0
    mode: str = "min"

    def __post_init__(self):
        if self.mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {self.mode!r}")
        self._best: Optional[float] = None
        self._bad_epochs = 0

    def should_stop(self, metrics: Dict[str, float]) -> bool:
        current = metrics.get(self.monitor)
        if current is None:
            return False
        improved = self._best is None or (
            current < self._best - self.min_delta if self.mode == "min" else current > self._best + self.min_delta
        )
        if improved:
            self._best = float(current)
            self._bad_epochs = 0
            return False
        self._bad_epochs += 1
        return self._bad_epochs >= self.patience


def _encode_targets(text_transform, texts, multiple: int = 32):
    """Encode texts and pad the id array to a width bucket (a multiple of ``multiple``)."""
    targets, target_lengths = text_transform.encode(texts)
    width = max(multiple, -(-targets.shape[1] // multiple) * multiple)
    if width > targets.shape[1]:
        targets = np.pad(targets, ((0, 0), (0, width - targets.shape[1])), constant_values=text_transform.vocab.pad_idx)
    return targets, target_lengths


class TrainStep:
    """``step(audio, audio_lengths, targets, target_lengths, generator, sample_weights=None) -> loss``.

    Every call runs forward and backward; every ``accumulate_grad_batches``-th
    call also applies the optimizer (:func:`optimizer_step`, as update number
    ``steps``). Only the optimizer's parameters are clipped and stepped. The
    batch-norm running statistics move in place on every call. Returns the
    loss, detached, on the device.
    """

    def __init__(self, model, optimizer: torch.optim.Optimizer, blank_idx: int, accumulate_grad_batches: int = 1,
                 gradient_clip_norm: Optional[float] = None, gradient_clip_value: Optional[float] = None):
        self.model = model
        self.optimizer = optimizer
        self.blank_idx = blank_idx
        self.accumulate = max(int(accumulate_grad_batches), 1)
        self.gradient_clip_norm = gradient_clip_norm
        self.gradient_clip_value = gradient_clip_value
        self.calls = 0  # micro-batches
        self.steps = 0  # optimizer updates

    def __call__(self, audio, audio_lengths, targets, target_lengths, generator: torch.Generator,
                 sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits, out_lengths = self.model(audio, audio_lengths, train=True, generator=generator)
        loss = calculate_ctc(logits, targets, out_lengths, target_lengths, self.blank_idx, sample_weights=sample_weights)
        (loss / self.accumulate).backward()
        self.calls += 1
        if self.calls % self.accumulate == 0:
            optimizer_step(self.optimizer, self.steps, self.gradient_clip_value, self.gradient_clip_norm)
            self.optimizer.zero_grad(set_to_none=True)
            self.steps += 1
        return loss.detach()


@torch.no_grad()
def eval_step(model, blank_idx: int, audio, audio_lengths, targets, target_lengths):
    """Eval-mode forward: ``(loss, logits, preds, logit_lengths)``."""
    logits, out_lengths = model(audio, audio_lengths, train=False)
    loss = calculate_ctc(logits, targets, out_lengths, target_lengths, blank_idx)
    return loss, logits, greedy_decode(logits), out_lengths


def _device_batch(module: CTCModule, audio, audio_lengths, texts):
    targets, target_lengths = _encode_targets(module.text_transform, texts)
    d = module.device
    return (to_device(audio, torch.float32, d), to_device(audio_lengths, torch.int32, d),
            to_device(targets, torch.int32, d), to_device(target_lengths, torch.int32, d))


@dataclass
class Trainer:
    """fit/validate loop over ``(audio, audio_lengths, texts)`` batches, with the JAX ``Trainer``'s knobs:
    optimizer and scheduler builders with the ``total_steps_arg`` convention, callbacks, checkpoints and
    resuming, beam-decoded validation, epochs, ``fast_dev_run``."""

    max_epochs: int = 1
    optimizer_builder: Callable = adamw
    optimizer_kwargs: Dict[str, Any] = field(default_factory=dict)
    lr_scheduler_builder: Optional[Callable] = None
    lr_scheduler_kwargs: Dict[str, Any] = field(default_factory=dict)
    callbacks: List[Any] = field(default_factory=list)
    #: clip the global gradient norm before the optimizer (None = off)
    gradient_clip_norm: Optional[float] = None
    #: element-wise clip, applied before the norm clip (None = off)
    gradient_clip_value: Optional[float] = None
    checkpoint_dir: Optional[str] = None
    #: save a checkpoint only when this validation metric improves (falls: Lightning's
    #: ModelCheckpoint(monitor=..., save_top_k=1)); None saves every epoch
    checkpoint_monitor: Optional[str] = None
    seed: int = 0
    log_every: int = 50
    fast_dev_run: bool = False
    logger: Optional[Callable[[Dict[str, float]], None]] = None
    #: a checkpoint folder (from save_checkpoint) to resume the whole train state from
    resume_from: Optional[str] = None
    #: decode validation with CTC prefix beam search of this width on the host (None = greedy)
    eval_beam_width: Optional[int] = None
    #: shallow-fusion LM for eval_beam_width decoding: any object with ``partial_score`` and ``final_score``
    eval_lm: Optional[object] = None
    eval_lm_weight: float = 0.5
    #: average gradients over this many batches before each optimizer step; schedules and epoch-based
    #: callbacks count optimizer steps
    accumulate_grad_batches: int = 1
    device: Any = "cuda"

    logs: List[Dict[str, float]] = field(default_factory=list)

    def _log(self, entry: Dict[str, float]):
        self.logs.append(entry)
        if self.logger:
            self.logger(entry)

    def train_step_for(self, module: CTCModule, train_loader) -> tuple:
        """``(train_step, generator, plateau_kwargs)`` for ``module`` (already on the device) and a loader of
        ``len(train_loader)`` batches an epoch: the optimizer with the schedule, clips, fine-tuning freeze,
        accumulation and plateau of this trainer, and the training generator from ``seed``."""
        accum = max(int(self.accumulate_grad_batches), 1)
        steps_per_epoch = -(-len(train_loader) // accum)
        total_steps = 1 if self.fast_dev_run else steps_per_epoch * self.max_epochs
        # ReduceLROnPlateau is not a per-step schedule: it scales the updates by a state that moves once per
        # epoch with the validation loss
        lr_builder, lr_kwargs, plateau_kwargs = self.lr_scheduler_builder, self.lr_scheduler_kwargs, None
        if lr_builder is not None and getattr(lr_builder, "_is_plateau", False):
            plateau_kwargs, lr_builder, lr_kwargs = dict(lr_kwargs), None, {}
        params = trainable_parameters(module.model, module.frozen_paths)
        finetune = [cb for cb in self.callbacks if isinstance(cb, FinetuneEncoderDecoder)]
        if finetune:
            trainable = {id(p) for p in params}
            params = finetune_param_groups((n, p) for n, p in module.model.named_parameters() if id(p) in trainable)
        optimizer = build_optimizer(params, self.optimizer_builder, self.optimizer_kwargs, lr_builder, lr_kwargs,
                                    total_steps=total_steps, steps_per_epoch=steps_per_epoch)
        for cb in finetune:
            optimizer = cb.wrap(optimizer, steps_per_epoch)
        if plateau_kwargs is not None:
            optimizer = plateau_schedule_transform(optimizer, **plateau_kwargs)
        train_step = TrainStep(module.model, optimizer, module.blank_idx, accum, self.gradient_clip_norm,
                               self.gradient_clip_value)
        generator = torch.Generator(device=module.device).manual_seed(self.seed)
        return train_step, generator, plateau_kwargs

    def fit(self, module: CTCModule, train_loader=None, val_loader=None, datamodule=None) -> CTCModule:
        """Train a copy of ``module`` on ``self.device``; return it with the trained weights.

        ``datamodule`` (``setup("fit")``, then its train and val loaders) takes the place of the loaders. Each
        logged train step also carries ``lr``, the learning rate of the optimizer's last parameter group (the
        decoder's under the fine-tuning freeze) at its latest update.
        """
        if datamodule is not None:
            datamodule.setup("fit")
            train_loader = datamodule.train_dataloader()
            val_loader = datamodule.val_dataloader()
        device = require_device(self.device)
        module = module.to(device)
        train_step, generator, plateau_kwargs = self.train_step_for(module, train_loader)
        optimizer = train_step.optimizer
        if self.resume_from:
            payload = restore_checkpoint(self.resume_from, {"model": module.model.state_dict()})
            load_train_state(payload, train_step, generator)

        step = 0
        best_monitored: Optional[float] = None  # checkpoint_monitor's best
        t0 = time.perf_counter()
        for epoch in range(self.max_epochs):
            for audio, audio_lengths, texts in train_loader:
                loss = train_step(*_device_batch(module, audio, audio_lengths, texts), generator)
                step += 1
                if step % self.log_every == 0 or self.fast_dev_run:
                    self._log({"step": step, "epoch": epoch, "loss/train_loss": float(loss),
                               "lr": optimizer.param_groups[-1]["lr"],
                               "steps_per_sec": step / (time.perf_counter() - t0)})
                if self.fast_dev_run:
                    break
            metrics: Dict[str, float] = {}
            if val_loader is not None:
                metrics = self.validate(module, val_loader, epoch=epoch)
                if plateau_kwargs is not None:
                    new_plateau = plateau_update(get_plateau_state(optimizer), metrics["loss/val_loss"],
                                                 **plateau_kwargs)
                    replace_plateau_state(optimizer, new_plateau)
                    metrics["lr_scale/plateau"] = float(new_plateau.scale)
                self._log(metrics)
                if any(isinstance(cb, EarlyStopping) and cb.should_stop(metrics) for cb in self.callbacks):
                    self._log({"epoch": epoch, "early_stop": 1.0})
                    if self.checkpoint_dir:
                        save_checkpoint(self.checkpoint_dir, train_state(train_step, generator), step=step)
                    return module
            if self.checkpoint_dir:
                save = True
                if self.checkpoint_monitor is not None:
                    current = metrics.get(self.checkpoint_monitor)
                    save = current is not None and (best_monitored is None or current < best_monitored)
                    if save:
                        best_monitored = float(current)
                if save:
                    save_checkpoint(self.checkpoint_dir, train_state(train_step, generator), step=step)
            if self.fast_dev_run:
                break
        return module

    def validate(self, module: CTCModule, val_loader, epoch: int = 0) -> Dict[str, float]:
        """Eval-mode loss and CER/WER over ``val_loader``: greedy, or the host's prefix beam search
        (``ops/ctc_beam.py``) of ``eval_beam_width`` with ``eval_lm``."""
        from thunder_tpu_torch.ops.ctc_beam import beam_search_decode

        cer_m, wer_m = CharErrorRate(), WordErrorRate()
        losses = []
        tt = module.text_transform
        for audio, audio_lengths, texts in val_loader:
            batch = _device_batch(module, audio, audio_lengths, texts)
            loss, logits, preds, out_lengths = eval_step(module.model, module.blank_idx, *batch)
            losses.append(float(loss))
            if self.eval_beam_width:
                hyps = beam_search_decode(logits.float().cpu().numpy(), out_lengths.cpu().numpy(),
                                          blank=module.blank_idx, beam_width=self.eval_beam_width, lm=self.eval_lm,
                                          lm_weight=self.eval_lm_weight)
                decoded = [tt.decode_prediction(h[None], remove_repeated=False)[0] if len(h) else "" for h in hyps]
            else:
                decoded = decode_greedy(tt, preds, out_lengths)
            refs = tt.decode_prediction(batch[2].cpu().numpy(), remove_repeated=False)
            cer_m.update(decoded, refs)
            wer_m.update(decoded, refs)
            if self.fast_dev_run:
                break
        return {
            "epoch": epoch,
            "loss/val_loss": float(np.mean(losses)) if losses else float("nan"),
            "metrics/cer": cer_m.compute(),
            "metrics/wer": wer_m.compute(),
        }
