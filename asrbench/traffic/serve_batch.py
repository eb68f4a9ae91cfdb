"""Traffic kind ``serve_batch``: batch transcription by one caller in a closed loop, through
``InferenceEngine.predict`` (greedy).

Parameters (the traffic file's ``params``):

- ``lengths``: the corpus (:func:`asrbench.traffic.corpus.lognormal_lengths`);
- ``max_batch_s``: the padded audio a batch may hold (:func:`asrbench.traffic.corpus.pack`);
- ``trace_seconds``: the last part of the window that a traced run profiles (its rates come from the part before);
- ``check_batches``, ``check_rows``: the sample the reference judges: the batch with the longest clip and
  others drawn from the seed, in each the longest row and others drawn from the seed.

The seed draws the waveforms, the weights, the order of the batches in each pass over the corpus and the sample;
the clip lengths, and so every shape, are the same for every seed. Each batch is a host float32 array padded to
its longest clip, made before the window; every shape is run once in set-up. The window runs passes until
``--seconds`` have gone, and ends when the last call returns.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from asrbench import compare, core
from asrbench.traffic import corpus
from asrbench.work import waveform


class _Recorder:
    """Keeps the device outputs of the engine's last ``infer``: the served tokens of a call."""

    def __init__(self, infer):
        self._infer = infer
        self.last = None

    def __call__(self, audio, lengths):
        out = self._infer(audio, lengths)
        self.last = out
        return out


def build_batches(ctx):
    lengths = corpus.lognormal_lengths(ctx.params["lengths"])
    batches = corpus.pack(lengths, ctx.params["max_batch_s"])
    clips = waveform.waveforms(lengths, ctx.seed, ctx.device)
    host = []
    for idx in batches:
        width = int(max(lengths[i] for i in idx))
        audio = np.zeros((len(idx), width), np.float32)
        for row, i in enumerate(idx):
            audio[row, : lengths[i]] = clips[i]
        host.append((audio, lengths[idx].astype(np.int32)))
    return host


def sample(host: list, seed: int, n_batches: int, n_rows: int) -> dict:
    """Batch index -> rows the reference judges: the last batch (it holds the longest clip) and ``n_batches - 1``
    others; in each the longest row and ``n_rows - 1`` others, drawn from the seed."""
    rng = np.random.default_rng([seed, 7])
    last = len(host) - 1
    others = rng.choice(last, size=min(n_batches - 1, last), replace=False) if last else []
    picked = {}
    for b in [last, *sorted(int(x) for x in others)]:
        rows = len(host[b][1])
        longest = int(np.argmax(host[b][1]))
        rest = [r for r in range(rows) if r != longest]
        extra = rng.choice(len(rest), size=min(n_rows - 1, len(rest)), replace=False) if rest else []
        picked[b] = sorted({longest, *(rest[int(i)] for i in extra)})
    return picked


def run(ctx) -> None:
    p, fam, cfg, dev = ctx.params, ctx.family, ctx.config, ctx.device
    host = build_batches(ctx)
    state = fam.make_state(cfg, ctx.seed, dev)
    module = fam.port_module(cfg, state, dev)
    state = {k: v.cpu() for k, v in state.items()}  # the reference's copy waits on the host
    engine = fam.engine(module, control=bool(p.get("control", False)))
    recorder = _Recorder(engine.infer)
    engine.infer = recorder  # predict calls the instance's infer: the recorder sees the served tokens
    picked = sample(host, ctx.seed, p["check_batches"], p["check_rows"])
    for audio, lengths in host:  # every shape of the traffic once
        engine.predict(audio, lengths)
    core.sync(dev)
    served, window = _window(ctx, engine, recorder, host, picked)
    ctx.record["memory_peak_bytes"] = core.memory_peak(dev)
    del engine, module, recorder
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    judge(ctx, host, picked, served, {k: v.to(dev) for k, v in state.items()})


def _window(ctx, engine, recorder, host, picked):
    from asrbench import trace

    p = ctx.params
    order_rng = np.random.default_rng([ctx.seed, 3])
    latencies, calls, served = [], [], {}
    audio_s, failed = 0.0, 0
    slice_ = trace.Slice() if ctx.trace else None
    span = untraced = None
    ctx.window_starts()
    start = time.perf_counter()
    end = start
    done = False
    while not done:
        for b in order_rng.permutation(len(host)):
            audio, lengths = host[b]
            if slice_ is not None and span is None and end - start >= ctx.seconds - p["trace_seconds"]:
                untraced = (end - start, list(calls), audio_s)
                slice_.start()
                traced_from = time.perf_counter()
                span = torch.profiler.record_function(trace.SPAN_PREFIX + "slice")
                span.__enter__()
            t0 = time.perf_counter()
            try:
                if span is not None:
                    with torch.profiler.record_function(trace.SPAN_PREFIX + "predict"):
                        texts = engine.predict(audio, lengths)
                else:
                    texts = engine.predict(audio, lengths)
            except Exception as exc:  # a failed request counts and the loop goes on
                failed += 1
                print(f"asrbench: predict failed: {exc!r}", file=sys.stderr)
                texts = None
            end = time.perf_counter()
            call = {"batch": int(audio.shape[0]), "samples": corpus.bucket(audio.shape[1])}
            if texts is not None:
                latencies.append((end - t0) * 1e3)
                audio_s += float(lengths.sum()) / corpus.SAMPLE_RATE
                calls.append(call)
                if b in picked:
                    served[int(b)] = (*recorder.last, texts)
            if span is not None:
                slice_.calls.append(call)
            if end - start >= ctx.seconds and (span is None or end - traced_from >= p["trace_seconds"]):
                done = True
                break
    window = end - start
    if span is not None:
        span.__exit__(None, None, None)
        slice_.stop()
        ctx.record["trace"] = slice_.result()
        window, calls, audio_s = untraced  # the rates of a traced run: the window's part before its slice
    served = {b: (logits.cpu().numpy(), preds.cpu().numpy(), n.cpu().numpy(), texts)
              for b, (logits, preds, n, texts) in served.items()}
    ctx.record.update(attempted=len(calls) + failed, failed=failed,
                      window={"seconds": window, "audio_s": audio_s, "latencies_ms": latencies, "calls": calls})
    print(f"asrbench: {len(calls)} predict calls in {window:.3f} s, {audio_s:.1f} s of audio, {failed} failed",
          file=sys.stderr)
    return served, window


def judge(ctx, host, picked, served, state) -> None:
    """The reference over the sampled rows, and the checks of the served tokens and texts."""
    model = ctx.family.reference(ctx.config, state)
    vocab = ctx.config["vocabulary"]
    rows, texts_bad, missing = [], 0, 0
    for b, picked_rows in picked.items():
        if b not in served:
            missing += 1
            continue
        program_logits, preds, n, texts = served[b]
        audio, lengths = host[b]
        logits, frames = compare.reference_logits(model, audio[picked_rows], lengths[picked_rows], ctx.device)
        for i, r in enumerate(picked_rows):
            rows.append((logits[i], frames[i], preds[r], n[r], program_logits[r]))
            texts_bad += compare.collapse_text(preds[r, : int(n[r])], vocab) != texts[r]
    gaps = compare.token_gaps(rows)
    ctx.record["gaps"] = gaps
    print(f"asrbench: reference over {len(rows)} rows: {gaps}", file=sys.stderr)
    check(ctx, gaps, missing, texts_bad)


def check(ctx, gaps: dict, missing: int = 0, texts_bad: int = 0) -> None:
    """The served rows' checks: every sampled batch served, every row of the reference's length, every text the
    collapse of its tokens, and each number the cell's traffic file limits under its limit."""
    ctx.check("sampled_batches_missing", missing, 0, missing == 0)
    ctx.check("rows_with_other_lengths", gaps["rows_with_other_lengths"], 0, gaps["rows_with_other_lengths"] == 0)
    ctx.check("texts_not_their_tokens", int(texts_bad), 0, texts_bad == 0)
    for name, limit in ctx.workload["checks"].items():
        ctx.check(name, gaps[name], limit, gaps[name] <= limit)
