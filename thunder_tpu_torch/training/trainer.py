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

On a mesh (``mesh``, or ``model_parallel > 1``, which builds one over the
process group: :mod:`thunder_tpu_torch.parallel`) a step is the
single-device step on the global batch, as the JAX trainer's SPMD step is:

- every rank reads the same global batch; :func:`_pad_batch_for_mesh` (the
  JAX function) repeats trailing rows with weight 0 and zero lengths until
  the batch divides the data axis, and each rank takes its data index's rows;
- the loss is the global weighted mean: each rank backpropagates its share
  (its rows' weighted sum over the global weight sum, which every rank knows
  from the padded batch), and the gradients are summed over the data group;
- batch norm takes the global batch's statistics, every random draw is the
  single-device step's for the same rows, and the training kernels hash the
  rows' global indices (:mod:`thunder_tpu_torch.parallel.spmd`);
- parameters whose output channels are wide enough shard over the model axis
  (``shard_variables``), with their optimizer state; the gradient clip takes
  the global norm;
- checkpoints hold the whole tensors and are written by rank 0, so a mesh
  checkpoint resumes meshless and the other way round; ``validate`` runs
  each rank's rows and sums the metrics' counts over the data group; ``fit``
  returns the module with whole tensors.

Not ported (``ROADMAP.md``): ``steps_per_execution`` (a CUDA graph of the train
step), and ``prng_impl``, which has no counterpart.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from thunder_tpu_torch.module import CTCModule, decode_greedy, require_device, to_device
from thunder_tpu_torch.ops.ctc import calculate_ctc, greedy_decode
from thunder_tpu_torch.parallel import DATA_AXIS, batch_sharding, make_mesh, shard_variables, spmd, unshard_variables
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


def _pad_batch_for_mesh(batch, mesh):
    """Repeat trailing rows so the batch divides the data axis. Returns ``(padded_batch, sample_weights)``:
    padding rows get weight 0 and zero audio and target lengths, so that every masked statistic (batch norm, the
    squeeze-excite pool, the frontend's normalization) leaves them out and the padded step is the unpadded one."""
    n = batch[0].shape[0]
    d = mesh.shape[DATA_AXIS]
    if n % d == 0:
        return batch, np.ones(n, np.float32)
    target = -(-n // d) * d
    idx = np.concatenate([np.arange(n), np.arange(target - n) % n])
    weights = np.concatenate([np.ones(n, np.float32), np.zeros(target - n, np.float32)])
    padded = [np.asarray(b)[idx] for b in batch]
    padded[1] = padded[1].copy()
    padded[1][n:] = 0
    padded[3] = padded[3].copy()
    padded[3][n:] = 0
    return tuple(padded), weights


def _data_sum_(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed in place over the mesh's data group (no gradient)."""
    dist.all_reduce(x, group=mesh.data_group)
    return x


def _sum_gradients(params, mesh) -> None:
    """Sum the gradients over the data group: one all-reduce of their concatenation."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _data_sum_(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


class TrainStep:
    """``step(audio, audio_lengths, targets, target_lengths, generator, sample_weights=None) -> loss``.

    Every call runs forward and backward; every ``accumulate_grad_batches``-th
    call also applies the optimizer (:func:`optimizer_step`, as update number
    ``steps``). Only the optimizer's parameters are clipped and stepped. The
    batch-norm running statistics move in place on every call. Returns the
    loss, detached, on the device.

    With a ``mesh`` the arguments are the global batch (padded to divide the
    data axis, with its ``sample_weights`` on the host, see
    :func:`_pad_batch_for_mesh`): the rank runs its rows as a data-parallel step
    (:func:`~thunder_tpu_torch.parallel.spmd.rows`), backpropagates its share of
    the global loss, and the gradients are summed over the data group before
    each update. The returned loss is the global one on every rank.
    """

    def __init__(self, model, optimizer: torch.optim.Optimizer, blank_idx: int, accumulate_grad_batches: int = 1,
                 gradient_clip_norm: Optional[float] = None, gradient_clip_value: Optional[float] = None, mesh=None):
        self.model = model
        self.optimizer = optimizer
        self.blank_idx = blank_idx
        self.accumulate = max(int(accumulate_grad_batches), 1)
        self.gradient_clip_norm = gradient_clip_norm
        self.gradient_clip_value = gradient_clip_value
        self.mesh = mesh
        self.calls = 0  # micro-batches
        self.steps = 0  # optimizer updates

    def _loss(self, audio, audio_lengths, targets, target_lengths, generator, sample_weights):
        """The loss to backpropagate and the loss to report."""
        if self.mesh is None:
            logits, out_lengths = self.model(audio, audio_lengths, train=True, generator=generator)
            loss = calculate_ctc(logits, targets, out_lengths, target_lengths, self.blank_idx,
                                 sample_weights=sample_weights)
            return loss, loss.detach()
        total = audio.shape[0]
        weights = (np.ones(total, np.float32) if sample_weights is None
                   else torch.as_tensor(sample_weights).float().cpu().numpy())
        shard = batch_sharding(self.mesh)
        audio, audio_lengths, targets, target_lengths = (shard(t) for t in (audio, audio_lengths, targets,
                                                                             target_lengths))
        local_w = shard(weights)
        rows = spmd.Rows(self.mesh.data_rank * audio.shape[0], total, self.mesh.data_group)
        with spmd.rows(rows):
            logits, out_lengths = self.model(audio, audio_lengths, train=True, generator=generator)
        # rows of weight 1 take the unweighted mean, the meshless step's
        w = None if np.all(local_w == 1.0) else torch.as_tensor(local_w, device=logits.device)
        local = calculate_ctc(logits, targets, out_lengths, target_lengths, self.blank_idx, sample_weights=w)
        share = spmd.loss_share(local, float(local_w.sum()), float(weights.sum()))
        return share, _data_sum_(share.detach().clone(), self.mesh)

    def __call__(self, audio, audio_lengths, targets, target_lengths, generator: torch.Generator,
                 sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        loss, reported = self._loss(audio, audio_lengths, targets, target_lengths, generator, sample_weights)
        (loss / self.accumulate).backward()
        self.calls += 1
        if self.calls % self.accumulate == 0:
            if self.mesh is not None:
                _sum_gradients([p for group in self.optimizer.param_groups for p in group["params"]], self.mesh)
            optimizer_step(self.optimizer, self.steps, self.gradient_clip_value, self.gradient_clip_norm)
            self.optimizer.zero_grad(set_to_none=True)
            self.steps += 1
        return reported


@torch.no_grad()
def eval_step(model, blank_idx: int, audio, audio_lengths, targets, target_lengths):
    """Eval-mode forward: ``(loss, logits, preds, logit_lengths)``."""
    logits, out_lengths = model(audio, audio_lengths, train=False)
    loss = calculate_ctc(logits, targets, out_lengths, target_lengths, blank_idx)
    return loss, logits, greedy_decode(logits), out_lengths


def _device_batch(module: CTCModule, audio, audio_lengths, texts, mesh=None):
    """The batch on the module's device with its targets encoded; on a ``mesh`` ``(batch, sample_weights)``, the
    batch padded to divide the data axis (:func:`_pad_batch_for_mesh`)."""
    targets, target_lengths = _encode_targets(module.text_transform, texts)
    batch = (audio, audio_lengths, targets, target_lengths)
    if mesh is not None:
        batch, weights = _pad_batch_for_mesh(batch, mesh)
    d = module.device
    batch = tuple(to_device(b, t, d) for b, t in zip(batch, (torch.float32, torch.int32, torch.int32, torch.int32)))
    return batch if mesh is None else (batch, weights)


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
    #: a :class:`~thunder_tpu_torch.parallel.Mesh` to train on (data- and channel-parallel); None trains on
    #: ``device``, unless ``model_parallel > 1`` builds a mesh over the process group
    mesh: Optional[Any] = None
    model_parallel: int = 1
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

    def train_step_for(self, module: CTCModule, train_loader, mesh=None) -> tuple:
        """``(train_step, generator, plateau_kwargs)`` for ``module`` (already on the device, and sharded on a
        ``mesh``) and a loader of ``len(train_loader)`` batches an epoch: the optimizer with the schedule, clips,
        fine-tuning freeze, accumulation and plateau of this trainer, and the training generator from ``seed``."""
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
                               self.gradient_clip_value, mesh=mesh)
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
        mesh = self.mesh
        if mesh is None and self.model_parallel > 1:
            mesh = make_mesh(model_parallel=self.model_parallel, device=self.device)
        self._mesh = mesh
        device = mesh.device if mesh is not None else require_device(self.device)
        module = module.to(device)
        if mesh is not None:
            shard_variables(module.model, mesh)
        train_step, generator, plateau_kwargs = self.train_step_for(module, train_loader, mesh)
        optimizer = train_step.optimizer
        if self.resume_from:
            payload = restore_checkpoint(self.resume_from, {"model": module.model.state_dict()})
            load_train_state(payload, train_step, generator)

        def checkpoint():
            # every rank takes part (the state's sharded tensors are gathered); rank 0 writes
            state = train_state(train_step, generator)
            if mesh is None or dist.get_rank() == 0:
                save_checkpoint(self.checkpoint_dir, state, step=step)
            if mesh is not None:
                dist.barrier()

        def finished():
            if mesh is not None:
                unshard_variables(module.model)
            return module

        step = 0
        best_monitored: Optional[float] = None  # checkpoint_monitor's best
        t0 = time.perf_counter()
        for epoch in range(self.max_epochs):
            for audio, audio_lengths, texts in train_loader:
                if mesh is None:
                    loss = train_step(*_device_batch(module, audio, audio_lengths, texts), generator)
                else:
                    batch, weights = _device_batch(module, audio, audio_lengths, texts, mesh)
                    loss = train_step(*batch, generator, sample_weights=weights)
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
                        checkpoint()
                    return finished()
            if self.checkpoint_dir:
                save = True
                if self.checkpoint_monitor is not None:
                    current = metrics.get(self.checkpoint_monitor)
                    save = current is not None and (best_monitored is None or current < best_monitored)
                    if save:
                        best_monitored = float(current)
                if save:
                    checkpoint()
            if self.fast_dev_run:
                break
        return finished()

    def _eval_rows(self, module: CTCModule, mesh, audio, audio_lengths, texts):
        """``(loss, logits, preds, out_lengths, targets)`` of one validation batch: the whole batch, or on a
        ``mesh`` this rank's rows of the padded batch without its padding rows, with the global loss."""
        batch = _device_batch(module, audio, audio_lengths, texts, mesh)
        if mesh is None:
            return (*eval_step(module.model, module.blank_idx, *batch), batch[2])
        batch, weights = batch
        shard = batch_sharding(mesh)
        audio, audio_lengths, targets, target_lengths = (shard(t) for t in batch)
        local_w = shard(weights)
        with torch.no_grad():
            logits, out_lengths = module.model(audio, audio_lengths, train=False)
            w = None if np.all(local_w == 1.0) else torch.as_tensor(local_w, device=logits.device)
            local = calculate_ctc(logits, targets, out_lengths, target_lengths, module.blank_idx, sample_weights=w)
            loss = _data_sum_(spmd.loss_share(local, float(local_w.sum()), float(weights.sum())), mesh)
        keep = torch.as_tensor(local_w > 0, device=logits.device)
        logits, out_lengths, targets = logits[keep], out_lengths[keep], targets[keep]
        return loss, logits, greedy_decode(logits), out_lengths, targets

    def validate(self, module: CTCModule, val_loader, epoch: int = 0) -> Dict[str, float]:
        """Eval-mode loss and CER/WER over ``val_loader``: greedy, or the host's prefix beam search
        (``ops/ctc_beam.py``) of ``eval_beam_width`` with ``eval_lm``. On a mesh each rank decodes its rows and
        the error counts are summed over the data group, so every rank reports the global rates."""
        from thunder_tpu_torch.ops.ctc_beam import beam_search_decode

        mesh = self.mesh if self.mesh is not None else getattr(self, "_mesh", None)
        cer_m, wer_m = CharErrorRate(), WordErrorRate()
        losses = []
        tt = module.text_transform
        for audio, audio_lengths, texts in val_loader:
            loss, logits, preds, out_lengths, targets = self._eval_rows(module, mesh, audio, audio_lengths, texts)
            losses.append(float(loss))
            if self.eval_beam_width:
                hyps = beam_search_decode(logits.float().cpu().numpy(), out_lengths.cpu().numpy(),
                                          blank=module.blank_idx, beam_width=self.eval_beam_width, lm=self.eval_lm,
                                          lm_weight=self.eval_lm_weight)
                decoded = [tt.decode_prediction(h[None], remove_repeated=False)[0] if len(h) else "" for h in hyps]
            else:
                decoded = decode_greedy(tt, preds, out_lengths)
            refs = tt.decode_prediction(targets.cpu().numpy(), remove_repeated=False)
            cer_m.update(decoded, refs)
            wer_m.update(decoded, refs)
            if self.fast_dev_run:
                break
        if mesh is not None:
            counts = torch.tensor([cer_m.errors, cer_m.total, wer_m.errors, wer_m.total], dtype=torch.float64,
                                  device=mesh.device)
            counts = _data_sum_(counts, mesh).tolist()
            cer_m.errors, cer_m.total, wer_m.errors, wer_m.total = (int(c) for c in counts)
        return {
            "epoch": epoch,
            "loss/val_loss": float(np.mean(losses)) if losses else float("nan"),
            "metrics/cer": cer_m.compute(),
            "metrics/wer": wer_m.compute(),
        }
