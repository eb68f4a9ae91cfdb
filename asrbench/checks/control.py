"""The controls and the planted faults: what a cell's check has to refuse.

- The control of every cell is the reference put in the program's place one precision below the bf16 the
  configuration states: fp8, as Hopper's tensor cores take it (a scale a tensor at its largest magnitude). Both
  operands of every product and convolution are rounded to e4m3 (:func:`fp8`); in training the gradient that
  reaches each product's output is rounded to e5m2 before the product's backward (:func:`fp8_gradient`), so the
  backward's products take fp8 operands too. Served: the fp8 reference's tokens and logits judged against the
  float32 reference's as the served ones are; trained: its three steps against the float32 reference's.
- The program's own lower-precision serving path (:func:`asrbench.traffic.serve_batch.run` with ``control``:
  QuartzNet's ``int8_weights``, wav2vec2's ``int8_compute``) is read beside it by ``limits.py``.
- The faults, planted in the reference put in the program's place: a served token turned to its worst; half of a
  training batch left out of the loss, the mean taken over the rest.

Each returns the cell's compared numbers; :func:`judged` puts them through the cell's own checks.
"""

from __future__ import annotations

import torch

from asrbench.traffic import serve_batch, train

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / largest
    return (x / scale).to(dtype).to(x.dtype) * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale; the gradient passes straight through."""
    return x + (_round(x.detach(), torch.float8_e4m3fn, E4M3_MAX) - x).detach()


class _Fp8Gradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8_gradient(y: torch.Tensor) -> torch.Tensor:
    """``y`` unchanged; the gradient that reaches it rounded to float8 e5m2 under a per-tensor scale."""
    return _Fp8Gradient.apply(y)


FP8 = {"operand": fp8, "gradient": fp8_gradient}


def _start(ctx):
    pool = train.make_pool(ctx)
    state = {k: v.cpu() for k, v in ctx.family.make_state(ctx.config, ctx.seed, ctx.device).items()}
    return pool, state, train.reference_steps(ctx, pool[:3], state)


def _as_program(low: dict, b1: float = 0.9) -> dict:
    """The reference's steps in the shape the program's train states are read in."""
    return {"losses": low["losses"],
            "after_first": {"exp_avg": {n: (1.0 - b1) * g.cpu() for n, g in low["first_grads"].items()}},
            "after_third": {"model": {n: p.cpu() for n, p in low["params"].items()}}}


def train_control(ctx) -> dict:
    """The fp8 reference's three steps against the float32 reference's, from the cell's own weights, batches and
    random draws: the numbers a training cell's check compares."""
    pool, state, ref = _start(ctx)
    low = train.reference_steps(ctx, pool[:3], state, precision=FP8)
    return train.gaps(_as_program(low), ref, {n: state[n] for n in ref["first_grads"]})


def train_fault_half(ctx) -> dict:
    """The fault "half of the batch left out, the mean taken over the rest", planted in the reference put in the
    program's place: its three steps against the whole batch's, as the check compares them."""
    pool, state, ref = _start(ctx)
    low = train.reference_steps(ctx, pool[:3], state, loss_rows=len(pool[0][1]) // 2)
    return train.gaps(_as_program(low), ref, {n: state[n] for n in ref["first_grads"]})


def _served_by_reference(ctx, alter=None, **precision) -> dict:
    """The reference (``precision`` rounding it) put in the program's place on the rows a run judges, at their
    served widths, its tokens its argmax (``alter`` may change them): judged against the float32 reference."""
    from asrbench import compare

    host = serve_batch.build_batches(ctx)
    state = ctx.family.make_state(ctx.config, ctx.seed, ctx.device)
    model = ctx.family.reference(ctx.config, state)
    low = ctx.family.reference(ctx.config, state, **precision) if precision else model
    picked = serve_batch.sample(host, ctx.seed, ctx.params["check_batches"], ctx.params["check_rows"])
    rows = []
    for b, picked_rows in picked.items():
        audio, lengths = host[b][0][picked_rows], host[b][1][picked_rows]
        logits, frames = compare.reference_logits(model, audio, lengths, ctx.device)
        served, served_frames = (logits, frames) if low is model else compare.reference_logits(low, audio, lengths,
                                                                                              ctx.device)
        for i in range(len(picked_rows)):
            tokens = served[i].argmax(-1)
            if alter is not None:
                alter(tokens, served[i])
            rows.append((logits[i], frames[i], tokens, served_frames[i], served[i]))
    return compare.token_gaps(rows)


def serve_control(ctx) -> dict:
    """The fp8 reference served in the program's place: the gap of each token it puts first, and its logits'."""
    return _served_by_reference(ctx, operand=fp8)


def serve_fault_token(ctx) -> dict:
    """The fault "a token altered where it is produced": the reference's own tokens, with the first frame of every
    sampled row turned to its worst token, judged as the check judges the served ones."""

    def worst_first(tokens, logits):
        tokens[0] = logits[0].argmin()

    return _served_by_reference(ctx, alter=worst_first)


def judged(ctx, gaps: dict) -> dict:
    """``gaps`` put through the cell's own checks (:meth:`asrbench.core.Ctx.check`): the checks, by name."""
    ctx.checks = {}
    if ctx.workload["traffic"] == "serve_batch":
        serve_batch.check(ctx, gaps)
    else:
        train.check(ctx, gaps)
    return ctx.checks
