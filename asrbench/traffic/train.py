"""Traffic kind ``train``: ``Trainer.fit`` with ``steps_per_execution=K`` (each chunk of K steps as replays of
the CUDA graph of the whole step), AdamW, fed from a pool of host batches made from the seed.

Parameters (the traffic file's ``params``):

- ``batch``, ``bucket_s``: rows a batch and the seconds every row is padded to;
- ``min_s``, ``max_s``: clip lengths at the stratified quantiles of U(min, max) (after LibriSpeech
  train-clean-100's mean: :mod:`asrbench.traffic.corpus`);
- ``pool_batches``: host batches in the pool, cycled; each batch holds one of the pool's longest clips, so that
  every batch's longest text pads to the same 32-wide target bucket (a chunk replays one graph a key);
- ``chars_per_s``: the texts' length, random characters of the vocabulary;
- ``steps_per_execution``, ``learning_rate``, ``warm_chunks``: the trainer's K and rate, the chunks run in set-up
  after the three steps the reference follows;
- ``trace_seconds``: the last part of the window a traced run profiles (its rates come from the part before).

One ``fit`` call covers set-up and window, on one trainer, model and optimizer state: its first epoch is step 1
(eager, then captured), its second steps 2 and 3, its third the warm chunks and then the window, until
``--seconds`` have gone at a chunk's boundary; the window closes on a synchronize. Between the epochs the feed
reads the trainer's state, which the reference's three steps are compared with.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from asrbench import compare, core
from asrbench.reference import train as ref_train
from asrbench.traffic import corpus
from asrbench.work import waveform


def make_pool(ctx) -> list:
    """``(audio (B, bucket) float32, lengths int32, texts)`` host batches from the seed."""
    p, vocab = ctx.params, ctx.config["vocabulary"]
    n, rows = p["pool_batches"], p["batch"]
    rng = np.random.default_rng([ctx.seed, 5])
    lengths = corpus.uniform_lengths(n * rows, p["min_s"], p["max_s"])[::-1]
    order = np.concatenate([np.arange(n), n + rng.permutation(n * (rows - 1))])  # the n longest, one a batch
    lengths = lengths[order].reshape(rows, n).T
    clips = waveform.waveforms(lengths.reshape(-1), ctx.seed, ctx.device)
    width = int(p["bucket_s"] * corpus.SAMPLE_RATE)
    pool = []
    for b in range(n):
        audio = np.zeros((rows, width), np.float32)
        texts = []
        for r in range(rows):
            n_samples = int(lengths[b, r])
            audio[r, :n_samples] = clips[b * rows + r]
            chars = int(round(p["chars_per_s"] * n_samples / corpus.SAMPLE_RATE))
            texts.append("".join(vocab[i] for i in rng.integers(0, len(vocab), size=chars)))
        pool.append((audio, lengths[b].astype(np.int32), texts))
    return pool


class Feed:
    """The trainer's loader: one epoch a ``fit`` epoch (see the module docstring)."""

    def __init__(self, ctx, pool: list, trainer):
        self.ctx, self.pool, self.trainer = ctx, pool, trainer
        self.epoch = 0
        self.states: list = []
        self.calls: list = []
        self.audio_s = 0.0
        self.slice = None
        self.span = None
        self.start = self.counters = self.untraced = None

    def __len__(self) -> int:
        return len(self.pool)

    def _batch(self, i: int):
        return self.pool[i % len(self.pool)]

    def __iter__(self):
        epoch, self.epoch = self.epoch, self.epoch + 1
        if epoch == 0:
            yield self._batch(0)
            return
        self.states.append(_snapshot(self.trainer.train_state()))  # after step 1, then after step 3
        if epoch == 1:
            yield self._batch(1)
            yield self._batch(2)
            return
        yield from self._window()

    def _window(self):
        from asrbench import trace

        ctx, p, trainer = self.ctx, self.ctx.params, self.trainer
        k = p["steps_per_execution"]
        i = 3
        for _ in range(p["warm_chunks"] * k):
            yield self._batch(i)
            i += 1
        core.sync(ctx.device)
        trainer.log_every = 50  # the trainer's default: a loss read back every 50 steps
        self.counters = {"replayed_steps": trainer.replayed_steps, "eager_steps": trainer.eager_steps}
        ctx.window_starts()
        self.start = time.perf_counter()
        traced_from = None
        while True:
            now = time.perf_counter()
            if now - self.start >= ctx.seconds and (traced_from is None or now - traced_from >= p["trace_seconds"]):
                return
            if ctx.trace and self.slice is None and now - self.start >= ctx.seconds - p["trace_seconds"]:
                core.sync(ctx.device)
                self.untraced = (time.perf_counter() - self.start, list(self.calls), self.audio_s)
                self.slice = trace.Slice()
                self.slice.start()
                traced_from = time.perf_counter()
                self.span = torch.profiler.record_function(trace.SPAN_PREFIX + "slice")
                self.span.__enter__()
            for _ in range(k):
                audio, lengths, _ = batch = self._batch(i)
                i += 1
                call = {"batch": int(audio.shape[0]), "samples": int(audio.shape[1])}
                self.calls.append(call)
                if self.slice is not None:
                    self.slice.calls.append(call)
                self.audio_s += float(lengths.sum()) / corpus.SAMPLE_RATE
                yield batch


def _snapshot(state: dict) -> dict:
    """What the checks read of a train state: copies of the parameters and of AdamW's first moments (on the CPU
    the train state holds the live tensors)."""
    return {"model": {n: t.clone() for n, t in state["model"].items()},
            "exp_avg": {n: s["exp_avg"].clone() for n, s in state["optimizer"]["state"].items() if "exp_avg" in s}}


def run(ctx) -> None:
    from thunder_tpu_torch.training.trainer import Trainer

    p, fam, cfg, dev = ctx.params, ctx.family, ctx.config, ctx.device
    pool = make_pool(ctx)
    state = fam.make_state(cfg, ctx.seed, dev)
    module = fam.port_module(cfg, state, dev, train=True)
    state = {k: v.cpu() for k, v in state.items()}  # the reference's copy waits on the host
    trainer = Trainer(max_epochs=3, optimizer_kwargs={"learning_rate": p["learning_rate"]},
                      steps_per_execution=p["steps_per_execution"], seed=ctx.seed, log_every=1, device=dev)
    feed = Feed(ctx, pool, trainer)
    trainer.fit(module, train_loader=feed)
    core.sync(dev)
    window, calls, audio_s = time.perf_counter() - feed.start, feed.calls, feed.audio_s
    if feed.slice is not None:
        feed.span.__exit__(None, None, None)
        feed.slice.stop()
        ctx.record["trace"] = feed.slice.result()
        window, calls, audio_s = feed.untraced  # the rates of a traced run: the window's part before its slice
    counters = {k: getattr(trainer, k) - v for k, v in feed.counters.items()}
    losses = {e["step"]: e["loss/train_loss"] for e in trainer.logs if "loss/train_loss" in e and e["step"] <= 3}
    ctx.record.update(memory_peak_bytes=core.memory_peak(dev), attempted=len(feed.calls), failed=0,
                      window={"seconds": window, "audio_s": audio_s, "calls": calls, "counters": counters})
    print(f"asrbench: {len(calls)} steps in {window:.3f} s, {audio_s:.1f} s of audio, {counters}", file=sys.stderr)
    program = {"losses": [losses.get(s) for s in (1, 2, 3)], "after_first": feed.states[0], "after_third": feed.states[1]}
    del trainer, module, feed
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    judge(ctx, pool[:3], program, state)


def encode(texts: list, vocabulary: list):
    ids = [[vocabulary.index(c) for c in t] for t in texts]
    width = max(len(t) for t in ids)
    targets = np.zeros((len(ids), width), np.int64)
    for r, t in enumerate(ids):
        targets[r, : len(t)] = t
    return targets, np.asarray([len(t) for t in ids], np.int64)


def reference_steps(ctx, batches: list, state: dict, precision: dict | None = None,
                    loss_rows: int | None = None) -> dict:
    """The reference's first ``len(batches)`` steps from ``state`` (host tensors), on the card, TF32 off.
    ``precision``: the reference's ``operand`` and ``gradient`` rounding (a control); ``loss_rows``: the loss is
    the mean over the batch's first rows only (a fault planted in the reference)."""
    dev, cfg = ctx.device, ctx.config
    state = {k: v.to(dev, copy=True) for k, v in state.items()}
    model = ctx.family.reference(cfg, state, **(precision or {}))
    device_batches = []
    for audio, lengths, texts in batches:
        targets, target_lengths = encode(texts, cfg["vocabulary"])
        device_batches.append(tuple(torch.as_tensor(a, device=dev) for a in (audio, lengths.astype(np.int64),
                                                                              targets, target_lengths)))
    with compare.float32_exact():
        return ref_train.steps(model, ctx.family.trainable(cfg, state), device_batches,
                               ref_train.Draws(ctx.seed, dev), len(cfg["vocabulary"]),
                               ref_train.AdamW(ctx.params["learning_rate"]), loss_rows)


def _per_leaf(gap: dict, ref_norm: dict) -> list:
    """``(gap[n] over the larger of ref_norm[n] and the median leaf's norm, n)`` of each leaf, ascending."""
    med = float(np.median(list(ref_norm.values())))
    return sorted((gap[n] / max(ref_norm[n], med), n) for n in ref_norm)


def _median(gaps: list) -> float:
    return float(np.median([g for g, _ in gaps]))


def gaps(program: dict, ref: dict, start: dict, b1: float = 0.9) -> dict:
    """The compared numbers, from the program's losses and train states after steps 1 and 3 and the reference's
    three steps.

    - ``loss_gap``: each step's loss against the reference's, the largest relative gap; ``loss1_gap``: the first
      step's alone (the later steps' losses swing with the updates before them);
    - the first gradient of each leaf (the program's worked out from AdamW's first moment after one step,
      ``m / (1 - b1)``): ``grad_gap``, the worst leaf's gap between the program's norm and the reference's, over
      the larger of the reference's norm of that leaf and of the median leaf; ``grad_gap_median``, the median
      leaf's; ``grad_diff_median``, the median leaf's norm of the program's gradient less the reference's, over
      the same;
    - each leaf's change after three steps: ``change_gap``, ``change_gap_median``, ``change_diff_median`` alike.

    The change leaves out the elements whose reference gradient is under a thousandth of the median leaf's
    root-mean-square gradient: nought to rounding (a key's bias under the softmax), they move under Adam by
    round-off alone, in either program."""
    loss = [abs(a - b) / abs(b) if a is not None else float("inf") for a, b in zip(program["losses"], ref["losses"])]
    names = list(ref["first_grads"])
    grads = {n: ref["first_grads"][n].cpu() for n in names}
    moments = program["after_first"]["exp_avg"]  # a leaf the optimizer never stepped has none: a zero gradient
    g_prog = {n: moments[n].float().cpu() / (1.0 - b1) if n in moments else torch.zeros_like(grads[n])
              for n in names}
    rms = float(np.median([grads[n].norm().item() / grads[n].numel() ** 0.5 for n in names]))
    moving = {n: grads[n].abs() >= 1e-3 * rms for n in names}
    left_out = sum(int((~m).sum()) for m in moving.values())
    names_d = [n for n in names if bool(moving[n].any())]
    d_ref = {n: (ref["params"][n].cpu() - start[n])[moving[n]] for n in names_d}
    d_prog = {n: (program["after_third"]["model"][n].float().cpu() - start[n])[moving[n]] for n in names_d}

    def numbers(prog: dict, refd: dict, key: str) -> dict:
        ref_norm = {n: float(refd[n].norm()) for n in refd}
        by_norm = _per_leaf({n: abs(float(prog[n].norm()) - ref_norm[n]) for n in refd}, ref_norm)
        by_diff = _per_leaf({n: float((prog[n] - refd[n]).norm()) for n in refd}, ref_norm)
        return {f"{key}_gap": by_norm[-1][0], f"{key}_leaf": by_norm[-1][1], f"{key}_gap_median": _median(by_norm),
                f"{key}_diff_median": _median(by_diff)}

    return {"loss_gap": max(loss), "loss1_gap": loss[0],
            **numbers(g_prog, grads, "grad"), **numbers(d_prog, d_ref, "change"),
            "leaves": len(names), "elements_left_out": left_out,
            "losses": {"program": program["losses"], "reference": ref["losses"]}}


def judge(ctx, batches: list, program: dict, state: dict) -> None:
    ref = reference_steps(ctx, batches, state)
    g = gaps(program, ref, {n: state[n] for n in ref["first_grads"]})
    ctx.record["gaps"] = g
    print(f"asrbench: reference over 3 steps: {g}", file=sys.stderr)
    check(ctx, g)


def check(ctx, g: dict) -> None:
    """Each number the cell's traffic file limits, against its limit."""
    for name, limit in ctx.workload["checks"].items():
        ctx.check(name, g[name], limit, g[name] <= limit)
