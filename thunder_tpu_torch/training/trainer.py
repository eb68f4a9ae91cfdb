"""Training loop: the CTC train and eval steps, callbacks, ``fit`` and ``validate``.

Port of the single-device path of ``thunder_tpu/training/trainer.py``:

- :class:`TrainStep` is ``_train_step_body`` / ``make_train_step``: the
  model's train-mode forward, ``calculate_ctc`` (with ``sample_weights``),
  the backward, and once every ``accumulate_grad_batches`` calls (optax's
  ``MultiSteps``: the mean of the micro-batch gradients) the optimizer update
  of :func:`~thunder_tpu_torch.training.optim.optimizer_step` (its learning
  rates set on the host, then its device part ``apply_update``): optax's
  wrappers in the JAX trainer's order (the schedule, the value clip then the
  norm clip, the fine-tuning freeze, the accumulation, the plateau scale
  outermost); schedules count optimizer steps;
- a module's ``frozen_paths`` (``freeze_subtrees_transform``) keep their
  parameters out of the optimizer and the clip
  (:func:`~thunder_tpu_torch.training.optim.trainable_parameters`): they
  are not updated at all;
- :class:`GraphedTrainStep` is ``make_train_scan_step``: K steps a dispatch
  as replays of one CUDA graph of the whole step a step kind, which
  ``Trainer(steps_per_execution=K)`` drives over chunks of K same-shape
  batches, as the JAX ``fit`` groups them;
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

With ``steps_per_execution`` K > 1 on a mesh, a chunk of K batches is stacked
and sharded on its batch axis (``stacked_batch_sharding``), and on the card each
step replays the CUDA graph of its kind (:class:`GraphedTrainStep`) with its
NCCL collectives captured: the statistics' and the loss's sums over the data
group, the model group's gathers, the gradients' sum and the clip's norm. The
loss share's factor and the local weights reach the graph as device inputs,
written before each replay; the losses are read once a chunk. Only groups of
one rank have run under capture: on several cards, the model axis's gathers
(``model_parallel > 1``), the clip's model-group norm and the data group's
sums across ranks are captured as they run eagerly but unverified.

``prng_impl`` has no counterpart: it picks a TPU random-bit generator.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from thunder_tpu_torch.kernels import KERNEL_WRAPPERS
from thunder_tpu_torch.models.layers import RematStates, remat_states
from thunder_tpu_torch.module import CTCModule, decode_greedy, require_device, to_device
from thunder_tpu_torch.ops.ctc import calculate_ctc, greedy_decode
from thunder_tpu_torch.parallel import (
    DATA_AXIS,
    batch_sharding,
    make_mesh,
    shard_variables,
    spmd,
    stacked_batch_sharding,
    unshard_variables,
)
from thunder_tpu_torch.training.checkpointing import load_train_state, restore_checkpoint, save_checkpoint, train_state
from thunder_tpu_torch.training.metrics import CharErrorRate, WordErrorRate
from thunder_tpu_torch.training.optim import (
    adamw,
    apply_update,
    build_optimizer,
    clip_by_global_norm_,
    encoder_frozen,
    finetune_param_groups,
    finetune_schedule_transform,
    get_plateau_state,
    learning_rate,
    plateau_schedule_transform,
    plateau_update,
    replace_plateau_state,
    set_learning_rates,
    trainable_parameters,
)

__all__ = ["TrainStep", "GraphedTrainStep", "TRAIN_GRAPHS", "Trainer", "FinetuneEncoderDecoder", "EarlyStopping",
           "eval_step", "clip_by_global_norm_", "chunk_batches"]

#: the most step kinds (shapes, update or not, frozen encoder or not) a :class:`GraphedTrainStep` captures; a step
#: of a later kind runs eagerly
TRAIN_GRAPHS = 8


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


@dataclass(frozen=True)
class _Share:
    """The host part of a mesh step, fixed for its graph: whether some local row's weight is not 1 (the weights
    then go to the device; rows of weight 1 take the meshless unweighted mean), the global batch's row count (the
    shape of :func:`~thunder_tpu_torch.parallel.spmd.draw_rows`' draws) and this rank's first row (an argument of
    the training kernels' launches)."""

    weighted: bool
    total_rows: int
    offset: int


def _host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without waiting for the device: through pinned memory on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class TrainStep:
    """``step(audio, audio_lengths, targets, target_lengths, generator, sample_weights=None) -> loss``.

    Every call runs forward and backward; every ``accumulate_grad_batches``-th
    call also applies the optimizer (:func:`set_learning_rates` and
    :func:`apply_update`, as update number ``steps``). Only the optimizer's
    parameters are clipped and stepped. The batch-norm running statistics move
    in place on every call. Returns the loss, detached, on the device.
    ``eager_steps`` counts the calls.

    With a ``mesh`` the arguments are the global batch (padded to divide the
    data axis, with its ``sample_weights`` on the host, see
    :func:`_pad_batch_for_mesh`): the rank runs its rows as a data-parallel step
    (:meth:`rows_step`), backpropagates its share of the global loss, and the
    gradients are summed over the data group before each update. The returned
    loss is the global one on every rank.
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
        self.eager_steps = 0

    def _loss(self, audio, audio_lengths, targets, target_lengths, generator, sample_weights):
        """The meshless step's loss."""
        logits, out_lengths = self.model(audio, audio_lengths, train=True, generator=generator)
        return calculate_ctc(logits, targets, out_lengths, target_lengths, self.blank_idx,
                             sample_weights=sample_weights)

    def __call__(self, audio, audio_lengths, targets, target_lengths, generator: torch.Generator,
                 sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.mesh is None:
            inputs = (audio, audio_lengths, targets, target_lengths)
            if sample_weights is not None:
                inputs += (torch.as_tensor(sample_weights, dtype=torch.float32, device=audio.device),)
            return self._step(inputs, generator, None)
        total = audio.shape[0]
        weights = (np.ones(total, np.float32) if sample_weights is None
                   else torch.as_tensor(sample_weights).float().cpu().numpy())
        shard = batch_sharding(self.mesh)
        batch = tuple(shard(t) for t in (audio, audio_lengths, targets, target_lengths))
        return self.rows_step(batch, shard(weights), float(weights.sum()), total, generator)

    def rows_step(self, batch: tuple, local_weights: np.ndarray, total_weight: float, total_rows: int,
                  generator: torch.Generator) -> torch.Tensor:
        """One step on a mesh from this rank's rows of a global batch of ``total_rows`` rows: ``batch`` (audio,
        lengths, targets, target lengths) and their ``local_weights`` on the host, whose sum over the global batch
        is ``total_weight``. Returns the global loss.

        The host part is read here: whether every local weight is 1, and the loss share's factor
        (:func:`~thunder_tpu_torch.parallel.spmd.share_factor`), which goes to the device as a float32 scalar with
        the weights; the step itself reads only device tensors."""
        audio = batch[0]
        # rows of weight 1 take the unweighted mean, the meshless step's
        share = _Share(not np.all(local_weights == 1.0), int(total_rows), self.mesh.data_rank * audio.shape[0])
        inputs = tuple(batch)
        if share.weighted:
            inputs += (_host_to_device(np.asarray(local_weights, np.float32), audio.device),)
        factor = spmd.share_factor(float(local_weights.sum()), total_weight)
        inputs += (torch.full((), factor, dtype=torch.float32, device=audio.device),)
        return self._step(inputs, generator, share)

    def _step(self, inputs: tuple, generator: torch.Generator, share: Optional[_Share]) -> torch.Tensor:
        """One step of device ``inputs`` (the batch; then, off a mesh, the sample weights if given; on a mesh the
        local weights if ``share.weighted`` and the loss share's factor)."""
        update = (self.calls + 1) % self.accumulate == 0
        frozen = update and encoder_frozen(self.optimizer, self.steps)
        loss = self._run(inputs, generator, share, update, frozen)
        self.calls += 1
        self.steps += int(update)
        return loss

    def _run(self, inputs: tuple, generator: torch.Generator, share: Optional[_Share], update: bool,
             frozen: bool) -> torch.Tensor:
        """The step, eagerly."""
        if update:
            set_learning_rates(self.optimizer, self.steps)
        self.eager_steps += 1
        return self._body(inputs, generator, share, update, frozen, set_to_none=True)

    def _body(self, inputs: tuple, generator: torch.Generator, share: Optional[_Share], update: bool, frozen: bool,
              set_to_none: bool) -> torch.Tensor:
        """The step as a graph holds it, with the learning rates already set: no host read, and nothing that
        outlives it allocated but, with ``set_to_none``, the gradients. Returns the reported loss."""
        if share is None:
            loss = self._loss(*inputs[:4], generator, inputs[4] if len(inputs) > 4 else None)
            reported = loss.detach()
        else:
            audio, audio_lengths, targets, target_lengths = inputs[:4]
            with spmd.rows(spmd.Rows(share.offset, share.total_rows, self.mesh.data_group)):
                logits, out_lengths = self.model(audio, audio_lengths, train=True, generator=generator)
            local = calculate_ctc(logits, targets, out_lengths, target_lengths, self.blank_idx,
                                  sample_weights=inputs[4] if share.weighted else None)
            loss = local * inputs[-1]  # the rank's share (spmd.share_factor)
            reported = _data_sum_(loss.detach().clone(), self.mesh)
        (loss / self.accumulate).backward()
        if update:
            if self.mesh is not None:
                _sum_gradients([p for group in self.optimizer.param_groups for p in group["params"]], self.mesh)
            apply_update(self.optimizer, frozen, self.gradient_clip_value, self.gradient_clip_norm)
            self.optimizer.zero_grad(set_to_none=set_to_none)
        return reported


@dataclass
class _StepGraph:
    """One captured step: the graph, its input buffers and loss, the launches its capture saw by wrapper, the
    generators of its checkpointed blocks with each block's entry offset relative to the step's start, and the
    ``(parameter, gradient)`` pairs whose gradients it accumulates into."""

    graph: Any
    inputs: tuple
    loss: torch.Tensor
    launches: dict
    remat: list
    grads: list


class GraphedTrainStep(TrainStep):
    """A :class:`TrainStep` whose steps replay CUDA graphs of the whole step: the counterpart of the JAX package's
    ``make_train_scan_step``, which ``Trainer(steps_per_execution=K)`` drives. It computes what the eager step
    computes, bit for bit where the algorithms are deterministic.

    A step's kind is its device inputs' shapes and dtypes, whether it ends in an optimizer update, whether the
    fine-tuning freeze holds at that update, and on a mesh the step's host part (whether it is weighted, the global
    row count and the rank's first row). The first step of a kind runs eagerly on the step's side stream (it is
    that batch's real step, and on a mesh it runs each collective of the kind once, which creates each group's
    NCCL communicator outside any capture); then the whole step is captured there as one CUDA graph, which runs
    nothing: the train-mode forward with its random draws (dither, masks, dropout, the training kernels' seeds)
    and its collectives, the loss (on a mesh the rank's share and the reported global loss), the backward, the
    gradients summed over the data group and :func:`~thunder_tpu_torch.training.optim.apply_update` (the freeze,
    the clips, the optimizer), and the gradients zeroed in place after an update. A later step of the kind copies
    its inputs into the graph's input buffers (the batch; on a mesh the local weights and the loss share's factor,
    which change from step to step), writes the learning rates
    (:func:`~thunder_tpu_torch.training.optim.set_learning_rates`) and the generator states of the checkpointed
    blocks (:class:`~thunder_tpu_torch.models.layers.RematStates`), and replays the graph on the current stream:
    no Python and no kernel launches on the host.

    - Everything that outlives a step lies outside the graphs' memory pool: parameters, gradients (zeroed in
      place, never freed), optimizer state, running statistics, the learning-rate tensors and the input buffers.
      So the graphs of all kinds share one pool and replay in any order.
    - The training generator is registered with every graph: a replay moves its offset as an eager step does.
    - A replay adds the launches its capture saw to each kernel wrapper's ``launches`` (the capture's own are
      taken back: it launched nothing on the card), and counts in ``replayed_steps``.
    - A step runs eagerly, counted in ``eager_steps``, on the CPU (a gloo mesh too), with an optimizer that is not
      capturable (``SGD``), and for a kind past :data:`TRAIN_GRAPHS`. A capture that fails raises: no step of
      the card runs eagerly in its place.
    - A step on another stream than the last one first waits for that stream.
    - A gradient cleared (``zero_grad(set_to_none=True)``) or replaced between steps goes back into the tensor
      the graphs accumulate into; an optimizer state replaced (``load_state_dict``) drops the graphs, and each
      kind is captured again after its next eager step.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.replayed_steps = 0
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._pool = None
        self._side = None
        self._stream = None
        self._optimizer_state = self.optimizer.state

    def _graphable(self, audio: torch.Tensor) -> bool:
        # a mesh of CUDA tensors is an NCCL one (make_mesh), whose collectives a graph captures
        return audio.device.type == "cuda" and all(group.get("capturable") for group in self.optimizer.param_groups)

    def _run(self, inputs: tuple, generator: torch.Generator, share: Optional[_Share], update: bool,
             frozen: bool) -> torch.Tensor:
        if not self._graphable(inputs[0]):
            return super()._run(inputs, generator, share, update, frozen)
        key = (tuple((tuple(t.shape), t.dtype) for t in inputs), update, frozen, share)
        current = torch.cuda.current_stream(inputs[0].device)
        if self._stream is not None and self._stream != current:
            current.wait_stream(self._stream)
        self._stream = current
        if self.optimizer.state is not self._optimizer_state:  # load_state_dict: the graphs hold the old state
            self._graphs.clear()
            self._pool = None  # freed with its last graph
            self._optimizer_state = self.optimizer.state
        entry = self._graphs.get(key)
        if update:
            set_learning_rates(self.optimizer, self.steps)
        if entry is None:
            return self._first(key, inputs, generator, share, update, frozen)
        return self._replay(entry, inputs, generator)

    def _first(self, key: tuple, inputs: tuple, generator: torch.Generator, share: Optional[_Share], update: bool,
               frozen: bool):
        """The eager step of a new kind on the side stream, then its capture there (up to TRAIN_GRAPHS kinds)."""
        device = inputs[0].device
        if self._side is None:
            self._side = torch.cuda.Stream(device)
        current, side = torch.cuda.current_stream(device), self._side
        side.wait_stream(current)
        start = generator.get_offset()
        states = RematStates()
        with torch.cuda.stream(side):
            with remat_states(states):
                loss = self._body(inputs, generator, share, update, frozen, set_to_none=False)
            self.eager_steps += 1
            if len(self._graphs) < TRAIN_GRAPHS:
                offsets = [offset - start for offset in states.offsets]
                self._graphs[key] = self._capture(inputs, generator, share, update, frozen, offsets)
        current.wait_stream(side)
        loss.record_stream(current)  # made on the side stream, read on the current one
        return loss

    def _capture(self, inputs: tuple, generator: torch.Generator, share: Optional[_Share], update: bool,
                 frozen: bool, offsets: list) -> _StepGraph:
        static = tuple(t.clone() for t in inputs)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        remat = [torch.Generator(device=generator.device) for _ in offsets]
        for block_generator in remat:
            graph.register_generator_state(block_generator)
        before = {w: w.launches for w in KERNEL_WRAPPERS}
        try:
            with remat_states(RematStates(remat)):
                # thread_local: the process group's watchdog thread may query its earlier work meanwhile
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    loss = self._body(static, generator, share, update, frozen, set_to_none=False)
                finally:
                    graph.capture_end()
        finally:
            launched = {w: w.launches - n for w, n in before.items() if w.launches != n}
            for w, n in before.items():
                w.launches = n
        grads = [(p, p.grad) for p in self.model.parameters() if p.grad is not None]
        return _StepGraph(graph, static, loss, launched, list(zip(remat, offsets)), grads)

    def _replay(self, entry: _StepGraph, inputs: tuple, generator: torch.Generator) -> torch.Tensor:
        for p, g in entry.grads:  # a gradient cleared or replaced since the capture goes back into the graph's
            if p.grad is not g:
                g.zero_() if p.grad is None else g.copy_(p.grad)
                p.grad = g
        for static, t in zip(entry.inputs, inputs):
            static.copy_(t)
        if entry.remat:
            seed, start = generator.initial_seed(), generator.get_offset()
            for block_generator, offset in entry.remat:
                block_generator.manual_seed(seed)
                block_generator.set_offset(start + offset)
        entry.graph.replay()
        for w, n in entry.launches.items():
            w.launches += n
        self.replayed_steps += 1
        return entry.loss.clone()


@torch.no_grad()
def eval_step(model, blank_idx: int, audio, audio_lengths, targets, target_lengths):
    """Eval-mode forward: ``(loss, logits, preds, logit_lengths)``."""
    logits, out_lengths = model(audio, audio_lengths, train=False)
    loss = calculate_ctc(logits, targets, out_lengths, target_lengths, blank_idx)
    return loss, logits, greedy_decode(logits), out_lengths


_BATCH_DTYPES = (torch.float32, torch.int32, torch.int32, torch.int32)


def _host_batch(module: CTCModule, audio, audio_lengths, texts, mesh=None) -> tuple:
    """``(batch, sample_weights)``: the batch with its targets encoded, and on a ``mesh`` padded to divide the data
    axis with its weights (:func:`_pad_batch_for_mesh`; None without a mesh)."""
    targets, target_lengths = _encode_targets(module.text_transform, texts)
    batch = (audio, audio_lengths, targets, target_lengths)
    if mesh is None:
        return batch, None
    return _pad_batch_for_mesh(batch, mesh)


def _device_batch(module: CTCModule, audio, audio_lengths, texts, mesh=None):
    """The batch on the module's device with its targets encoded; on a ``mesh`` ``(batch, sample_weights)``, the
    batch padded to divide the data axis (:func:`_pad_batch_for_mesh`)."""
    batch, weights = _host_batch(module, audio, audio_lengths, texts, mesh)
    batch = tuple(to_device(b, t, module.device) for b, t in zip(batch, _BATCH_DTYPES))
    return batch if mesh is None else (batch, weights)


def _batch_key(item: tuple) -> tuple:
    """The JAX ``fit``'s grouping key of a ``(batch, sample_weights)`` pair: the arrays' shapes, and whether the
    batch carries weights."""
    batch, weights = item
    return tuple(tuple(np.shape(b)) for b in batch) + (weights is None,)


def chunk_batches(items: Iterable, k: int) -> Iterator[list]:
    """Consecutive ``(batch, sample_weights)`` items in groups, as the JAX ``Trainer.fit`` groups batches for
    ``steps_per_execution=k``: a group ends when it holds ``k`` items, before an item whose key (the arrays'
    shapes, and whether it carries weights) differs from the group's, and at the end of ``items`` (an epoch).
    ``fit`` runs a group of ``k`` as one chunk and a shorter one a step at a time."""
    pending: list = []
    pending_key = None
    for item in items:
        item_key = _batch_key(item)
        if pending and item_key != pending_key:
            yield pending
            pending = []
        pending_key = item_key
        pending.append(item)
        if len(pending) == k:
            yield pending
            pending = []
    if pending:
        yield pending


@dataclass
class Trainer:
    """fit/validate loop over ``(audio, audio_lengths, texts)`` batches, with the JAX ``Trainer``'s knobs:
    optimizer and scheduler builders with the ``total_steps_arg`` convention, callbacks, checkpoints and
    resuming, beam-decoded validation, epochs, ``fast_dev_run``, ``steps_per_execution``."""

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
    #: run up to K optimizer steps a dispatch: consecutive same-shape batches are grouped in chunks of K, each
    #: chunk copied to the device once and run as K replays of one CUDA graph of the whole step
    #: (:class:`GraphedTrainStep`); leftovers run one step a dispatch, and the loss is still logged per step.
    #: Computes what K = 1 computes. 1 = one dispatch a batch, Lightning's behaviour
    steps_per_execution: int = 1
    device: Any = "cuda"

    logs: List[Dict[str, float]] = field(default_factory=list)
    #: the latest ``fit``'s steps that ran as CUDA graph replays, and eagerly
    replayed_steps: int = field(default=0, init=False)
    eager_steps: int = field(default=0, init=False)

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
        step_class = GraphedTrainStep if self.steps_per_execution > 1 else TrainStep
        train_step = step_class(module.model, optimizer, module.blank_idx, accum, self.gradient_clip_norm,
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

        self._state = lambda: train_state(train_step, generator)

        def checkpoint():
            # every rank takes part (the state's sharded tensors are gathered); rank 0 writes
            state = self.train_state()
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
        exec_k = max(int(self.steps_per_execution), 1)
        t0 = time.perf_counter()

        def log_steps(losses: torch.Tensor, lrs: List[float], epoch: int) -> None:
            """Count the steps of ``losses`` (their losses on the device, read back once if one is logged) and log
            every ``log_every``-th with its learning rate from the host."""
            nonlocal step
            values = None
            for i, lr in enumerate(lrs):
                step += 1
                if step % self.log_every == 0 or self.fast_dev_run:
                    values = losses.tolist() if values is None else values
                    self._log({"step": step, "epoch": epoch, "loss/train_loss": values[i], "lr": lr,
                               "steps_per_sec": step / (time.perf_counter() - t0)})
            self.replayed_steps = getattr(train_step, "replayed_steps", 0)
            self.eager_steps = train_step.eager_steps

        def run_step(batch: tuple, weights) -> torch.Tensor:
            batch = tuple(to_device(b, t, device) for b, t in zip(batch, _BATCH_DTYPES))
            if mesh is None:
                return train_step(*batch, generator)
            return train_step(*batch, generator, sample_weights=weights)

        def run_chunk(chunk: list) -> tuple:
            """K steps from one stacked copy of each of the chunk's arrays: their ``(K,)`` losses on the device and
            the learning rate after each. On a mesh the stack is sharded on its batch axis and the steps run this
            rank's rows."""
            arrays = [np.stack([np.asarray(batch[i]) for batch, _ in chunk]) for i in range(4)]
            losses, lrs = [], []
            if mesh is None:
                stacked = [to_device(a, t, device) for a, t in zip(arrays, _BATCH_DTYPES)]
                for k in range(len(chunk)):
                    losses.append(train_step(*(a[k] for a in stacked), generator))
                    lrs.append(learning_rate(optimizer.param_groups[-1]))
            else:
                shard = stacked_batch_sharding(mesh)
                weights = np.stack([w for _, w in chunk])
                local = [to_device(shard(a), t, device) for a, t in zip(arrays, _BATCH_DTYPES)]
                local_w = shard(weights)
                for k in range(len(chunk)):
                    losses.append(train_step.rows_step(tuple(a[k] for a in local), local_w[k],
                                                       float(weights[k].sum()), weights.shape[1], generator))
                    lrs.append(learning_rate(optimizer.param_groups[-1]))
            return torch.stack(losses), lrs

        for epoch in range(self.max_epochs):
            batches = (_host_batch(module, *b, mesh) for b in train_loader)
            for chunk in chunk_batches(itertools.islice(batches, 1) if self.fast_dev_run else batches, exec_k):
                if exec_k > 1 and len(chunk) == exec_k:
                    log_steps(*run_chunk(chunk), epoch)
                else:
                    for batch, weights in chunk:
                        loss = run_step(batch, weights)
                        log_steps(loss.reshape(1), [learning_rate(optimizer.param_groups[-1])], epoch)
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

    def train_state(self) -> dict:
        """The train state of the latest ``fit`` as a checkpoint holds it, on the host
        (:func:`~thunder_tpu_torch.training.checkpointing.train_state`): the weights and running statistics, the
        optimizer's state, the step counts and the training generator's state. On a mesh every rank calls it."""
        state = getattr(self, "_state", None)
        if state is None:
            raise RuntimeError("train_state() reads the latest fit: call fit first")
        return state()

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
            factor = spmd.share_factor(float(local_w.sum()), float(weights.sum()))
            loss = _data_sum_(local * factor, mesh)
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
