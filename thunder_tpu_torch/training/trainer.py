"""Training loop: the CTC train and eval steps, ``fit`` and ``validate``.

Port of the single-device path of ``thunder_tpu/training/trainer.py``:

- :class:`TrainStep` is ``_train_step_body`` / ``make_train_step``: the
  model's train-mode forward, ``calculate_ctc``, the backward, gradient
  clipping by value and then by global norm (optax's order and formulas), and
  the optimizer step (the optimizer's parameters without a gradient, such as
  a feature extractor's behind ``freeze_feature_extractor``, step with a zero
  gradient, so weight decay reaches them as it does in optax), once every
  ``accumulate_grad_batches`` calls (optax's ``MultiSteps``: the mean of the
  micro-batch gradients);
- a module's ``frozen_paths`` (``freeze_subtrees_transform``) keep their
  parameters out of the optimizer and the clip
  (:func:`~thunder_tpu_torch.training.optim.trainable_parameters`): they
  are not updated at all;
- :func:`eval_step` is ``make_eval_step``;
- :class:`Trainer` keeps the JAX ``Trainer``'s knobs that the slice needs
  (``max_epochs``, ``log_every``, ``fast_dev_run``,
  ``accumulate_grad_batches``, ``seed``, gradient clipping, the optimizer factory),
  on the card unless ``device`` says otherwise. ``seed`` feeds one explicit
  generator on the device, which draws every random number of training
  (dither, masks, dropout).

Not ported yet (``ROADMAP.md``): meshes and model parallelism,
``steps_per_execution``, checkpoints and resuming, schedulers (plateau
included), ``FinetuneEncoderDecoder``, ``EarlyStopping`` and beam decoding in
validation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from thunder_tpu_torch.module import CTCModule, decode_greedy, require_device, to_device
from thunder_tpu_torch.ops.ctc import calculate_ctc, greedy_decode
from thunder_tpu_torch.training.metrics import CharErrorRate, WordErrorRate
from thunder_tpu_torch.training.optim import adamw, build_optimizer, trainable_parameters

__all__ = ["TrainStep", "Trainer", "eval_step", "clip_by_global_norm_"]


def _encode_targets(text_transform, texts, multiple: int = 32):
    """Encode texts and pad the id array to a width bucket (a multiple of ``multiple``)."""
    targets, target_lengths = text_transform.encode(texts)
    width = max(multiple, -(-targets.shape[1] // multiple) * multiple)
    if width > targets.shape[1]:
        targets = np.pad(targets, ((0, 0), (0, width - targets.shape[1])), constant_values=text_transform.vocab.pad_idx)
    return targets, target_lengths


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place: unchanged below ``max_norm``,
    else ``g / norm * max_norm``. Stays on the device (no host sync)."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


class TrainStep:
    """``step(audio, audio_lengths, targets, target_lengths, generator) -> loss``.

    Every call runs forward and backward; every ``accumulate_grad_batches``-th
    call also clips and steps the optimizer. Only the optimizer's parameters
    are clipped and stepped. The batch-norm running statistics move in place
    on every call. Returns the loss, detached, on the device.
    """

    def __init__(self, model, optimizer: torch.optim.Optimizer, blank_idx: int, accumulate_grad_batches: int = 1,
                 gradient_clip_norm: Optional[float] = None, gradient_clip_value: Optional[float] = None):
        self.model = model
        self.optimizer = optimizer
        self.blank_idx = blank_idx
        self.accumulate = max(int(accumulate_grad_batches), 1)
        self.gradient_clip_norm = gradient_clip_norm
        self.gradient_clip_value = gradient_clip_value
        self.calls = 0
        self.params = [p for group in optimizer.param_groups for p in group["params"]]

    def __call__(self, audio, audio_lengths, targets, target_lengths, generator: torch.Generator) -> torch.Tensor:
        logits, out_lengths = self.model(audio, audio_lengths, train=True, generator=generator)
        loss = calculate_ctc(logits, targets, out_lengths, target_lengths, self.blank_idx)
        (loss / self.accumulate).backward()
        self.calls += 1
        if self.calls % self.accumulate == 0:
            # a parameter the loss does not reach (a frozen feature extractor) gets a zero gradient, as
            # JAX's stop_gradient gives it: optax's adamw still applies its decoupled weight decay to such
            # a parameter, and torch.optim.AdamW skips one whose gradient is None
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in self.params]
            if self.gradient_clip_value is not None:
                for g in grads:
                    g.clamp_(-self.gradient_clip_value, self.gradient_clip_value)
            if self.gradient_clip_norm is not None:
                clip_by_global_norm_(grads, self.gradient_clip_norm)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
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
    """Minimal fit/validate loop over ``(audio, audio_lengths, texts)`` batches."""

    max_epochs: int = 1
    optimizer_builder: Callable = adamw
    optimizer_kwargs: Dict[str, Any] = field(default_factory=dict)
    #: clip the global gradient norm before the optimizer (None = off)
    gradient_clip_norm: Optional[float] = None
    #: element-wise clip, applied before the norm clip (None = off)
    gradient_clip_value: Optional[float] = None
    seed: int = 0
    log_every: int = 50
    fast_dev_run: bool = False
    #: average gradients over this many batches before each optimizer step
    accumulate_grad_batches: int = 1
    device: Any = "cuda"

    logs: List[Dict[str, float]] = field(default_factory=list)

    def fit(self, module: CTCModule, train_loader, val_loader=None) -> CTCModule:
        """Train a copy of ``module`` on ``self.device``; return it with the trained weights."""
        device = require_device(self.device)
        module = module.to(device)
        params = trainable_parameters(module.model, module.frozen_paths)
        optimizer = build_optimizer(params, self.optimizer_builder, self.optimizer_kwargs)
        train_step = TrainStep(module.model, optimizer, module.blank_idx, self.accumulate_grad_batches,
                               self.gradient_clip_norm, self.gradient_clip_value)
        generator = torch.Generator(device=device).manual_seed(self.seed)
        step = 0
        t0 = time.perf_counter()
        for epoch in range(self.max_epochs):
            for audio, audio_lengths, texts in train_loader:
                loss = train_step(*_device_batch(module, audio, audio_lengths, texts), generator)
                step += 1
                if step % self.log_every == 0 or self.fast_dev_run:
                    self.logs.append({"step": step, "epoch": epoch, "loss/train_loss": float(loss),
                                      "steps_per_sec": step / (time.perf_counter() - t0)})
                if self.fast_dev_run:
                    break
            if val_loader is not None:
                self.logs.append(self.validate(module, val_loader, epoch=epoch))
            if self.fast_dev_run:
                break
        return module

    def validate(self, module: CTCModule, val_loader, epoch: int = 0) -> Dict[str, float]:
        """Eval-mode loss and greedy CER/WER over ``val_loader``."""
        cer_m, wer_m = CharErrorRate(), WordErrorRate()
        losses = []
        tt = module.text_transform
        for audio, audio_lengths, texts in val_loader:
            batch = _device_batch(module, audio, audio_lengths, texts)
            loss, _, preds, out_lengths = eval_step(module.model, module.blank_idx, *batch)
            losses.append(float(loss))
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
