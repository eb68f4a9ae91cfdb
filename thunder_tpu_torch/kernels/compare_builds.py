"""Time this checkout's kernels against another checkout's on one card, in turns.

    python3 -m thunder_tpu_torch.kernels.compare_builds --other DIR

``DIR`` is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Each side runs in its own process with its own build,
in the order other, this, this, other, so that drift in the card's clocks
falls on both. Each process times, with CUDA events:

- the serving attention at wav2vec2-base's 16 × 15 s shape (B = 16, T = 749,
  12 heads) and at 8 × 15 s, the training attention's forward at 8 × 15 s
  (rate 0.1) and its backward alone at 8 × 15 s and 8 × 30 s (T = 1499), at
  rate 0.1 and at rate 0 (at 8 × 15 s, rate 0.1, also each kernel's device
  time by torch.profiler), on random bf16 inputs from one seed;
- MMS-1b-all's widths at 12 of its 48 layers (``MMS_1B``: 1,280 hidden, 16
  heads of 80, stable LN, attention adapters of 16; random weights from
  generator seed 0): one greedy forward at 16 × 15 s (its launches and
  logits' SHA-256 too);
- the CTC kernels (``ctc_alpha``, ``ctc_beta`` and the pair) at the shapes of
  ``CTC_SHAPES``: QuartzNet's training step (B = 16, T = 751, V = 29) and
  wav2vec2-base's (B = 8, T = 749, V = 32), targets of 64 labels (S = 129),
  each kernel also in nanoseconds a frame;
- the separable repeat (``fused_separable_repeat``) at each of the eight
  shapes of QuartzNet15x5's 77 launches a 64 × 15 s forward
  (``QUARTZNET_SEPARABLE_SHAPES``), their count-weighted sum, and three
  shapes that take most of one phase away (``SEPARABLE_PHASE_SHAPES``);
- the log-mel kernel (``fused_log_mel``) at each of ``LOG_MEL_SHAPES``:
  QuartzNet's serving batch (64 × 15 s) and training batch (16 × 15 s) at
  16 kHz, and 16 × 15 s of 48 kHz audio with a 25 ms window (hop 480, win
  1200, n_fft 2048); a shape the checkout's wrapper does not take (decided
  before the call, by its plan or by the parent kernel's predicate) is
  recorded as ``"refused"``;
- the beam scan (``beam_scan``, floor -12) at the shapes of
  ``BEAM_SHAPES``: QuartzNet's serving decode (64 × 751 × 29, K = V), the
  ``beam_device_topk`` shape (64 × 188 × 1025, K = 50; the wrapper's top-K
  sort is in the time, and is timed alone beside it) and one ``predict_long``
  window (1 × 1000 × 29), on the ``beam_device`` inputs (numpy seed 3) with
  every row at full length, at W = 16; 16 × 188 × 3000, every token a step
  (K = 3000), past one block of shared memory; and 2 × 10 × 29 at W = 3,000,
  past the state that fits in shared memory (``"refused"`` where the checkout
  refuses a shape);
- the beam backtrace at the shapes of ``BACKTRACE_SHAPES`` (the served
  decode, 64 x 751 at W = 16, one path a row; a ``predict_long`` window,
  1 x 1001, every slot's path, both on the scan's own pointers; 264 x 751 at
  W = 300, one path a row, on random pointers): the kernel's device time by
  the profiler with the L2 flushed before each call and L2-warm, and L2-cold
  by ``cold_ms`` (copies of the pointers in turns, 100 MB); the same for the
  serial walk on staged spans whatever the plan picks, where the checkout
  has it; and one ``beam_search_device`` decode at the served shape;
- the add + dropout + LayerNorm training kernels at wav2vec2-base's step
  shape (5,992 rows of 768, rate 0.1): the forward's and the backward's
  device time a call L2-cold (rotating among six input sets, 166 MB in all,
  with the card held by a sleep kernel until the host has queued every call)
  and L2-warm (torch.profiler), and the backward's two kernels apart; the
  keep mask at that shape and the serving add + LayerNorm at 11,984 × 768,
  each L2-cold, flushed and warm;
- one wav2vec2-base greedy forward at 16 × 15 s (``InferenceEngine.infer``;
  also its launches by kernel wrapper and the SHA-256 of its logits, which
  the last lines compare across the four runs)
  and one training step at 8 × 15 s (frozen extractor, dropout 0.1, AdamW;
  beside it the device time of the step's add + dropout + LayerNorm kernels
  by torch.profiler),
  and one QuartzNet15x5 greedy forward at 64 × 15 s (20 iterations; its
  launches and logits' SHA-256 too), a beam
  ``predict`` of the same batch (``beam_width=16, beam_backend="device"``, the
  median of 5 on the host clock, from numpy audio to transcripts) and a
  training step at 16 × 15 s (SpecAugment,
  dropout 0.1, bf16, AdamW), as ``chip_smoke.py`` runs them, on noise audio
  from numpy seed 0;
- one Citrinet-256 greedy forward at 64 × 15 s (80 mels, 1,024 tokens and
  the blank, random weights from generator seed 0, as ``chip_smoke.py``'s
  ``citrinet_create``; 20 iterations; its launches and logits' SHA-256 too),
  on noise audio from numpy seed 1;
- QuartzNet15x5's forward at 64 × 15 s one synchronized request at a time
  (``sync_step``, as ``chip_smoke.py``'s profiling phase times it): in each of
  ``SYNC_STEP_ROUNDS`` rounds the forward back to back, ``StepTimer``'s RTF
  over 10 synchronized forwards against it, the host's time to queue one
  forward and the device time to the end of the frontend in a synchronized
  step (its launches and logits' SHA-256 too).

Every number is a mean over its iterations in milliseconds; the last line is
one JSON object with both sides' four runs. Only the API both checkouts share
is used. ``--sass THIS=OTHER,...`` then compares the SASS of kernels in the two
checkouts' built libraries (``cuobjdump -sass``, each kernel named by a
substring of its mangled name on this side and, after ``=``, on the other;
one name where both sides share it): the instructions each has and how many
differ, addresses and encodings left out. ``--parts`` limits each process to some of the groups
(``attention``, ``ctc``, ``separable``, ``log_mel``, ``beam``, ``add_ln``,
``wav2vec2``, ``quartznet``, ``citrinet``, ``sync_step``, ``mms``).
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PARTS = ("attention", "ctc", "separable", "log_mel", "beam", "add_ln", "wav2vec2", "quartznet", "citrinet",
         "sync_step", "mms")
#: MMS-1b-all's published widths at 12 of its 48 layers (chip_smoke.py's ``mms_1b``)
MMS_1B = dict(hidden_size=1280, num_hidden_layers=12, num_attention_heads=16, intermediate_size=5120,
              feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True, adapter_attn_dim=16)
#: rounds of the synchronized-step timing (``sync_step``)
SYNC_STEP_ROUNDS = 3
#: QuartzNet15x5's separable repeats in one forward at 64 x 15 s (T = 1501 log-mel frames, 751 after the stem):
#: (t_in, C_in, C_out, k, stride, dilation) -> launches
QUARTZNET_SEPARABLE_SHAPES = {
    (1501, 64, 256, 33, 2, 1): 1,
    (751, 256, 256, 33, 1, 1): 15,
    (751, 256, 256, 39, 1, 1): 15,
    (751, 256, 512, 51, 1, 1): 1,
    (751, 512, 512, 51, 1, 1): 14,
    (751, 512, 512, 63, 1, 1): 15,
    (751, 512, 512, 75, 1, 1): 15,
    (751, 512, 512, 87, 1, 2): 1,
}


#: the log-mel's shapes: name -> (B, samples, fused_log_mel keywords)
LOG_MEL_SHAPES = {
    "serving_64x240000": (64, 240000, {}),
    "training_16x240000": (16, 240000, {}),
    "48k_16x720000_n2048_hop480": (16, 720000, dict(sample_rate=48000, n_fft=2048, hop_length=480, win_length=1200)),
}


#: the beam scan's shapes: name -> (B, T, V, W, k_tokens)
BEAM_SHAPES = {
    "serving_64x751x29": (64, 751, 29, 16, 50),  # QuartzNet's decode of 64 x 15 s: K = V = 29
    "topk_64x188x1025": (64, 188, 1025, 16, 50),  # beam_device_topk: Citrinet's vocabulary, K = 50
    "window_1x1000x29": (1, 1000, 29, 16, 50),  # one 20 s predict_long window
    "chunked_16x188x3000": (16, 188, 3000, 16, 3000),  # every token a step past one block: the chunked scan
    "workspace_2x10x29_w3000": (2, 10, 29, 3000, 29),  # W = 3,000: the state in device memory (the workspace plan)
}

#: the CTC kernels' shapes: name -> (B, T, V), targets padded to 64 labels (S = 129), every row at full length
CTC_SHAPES = {"quartznet_16x751": (16, 751, 29), "wav2vec2_8x749": (8, 749, 32)}

#: the add + dropout + LayerNorm training kernels' shape: wav2vec2-base's step at 8 x 15 s (rows, D, rate)
ADD_LN_TRAIN_SHAPE = (5992, 768, 0.1)
#: input sets a cold timing rotates among: 6 x 27.6 MB of x, y and dout at that shape (110 MB of x and y alone), over
#: twice the 50 MB L2
COLD_SETS = 6
#: the backtrace's shapes: name -> (B, T, W, paths a row). QuartzNet's served decode walks one path a row and a
#: predict_long window every slot's path, both on the scan's own pointers (the beam_device inputs, numpy seed 3, every
#: row at full length, W = 16); at W = 300 (the serial walk on staged spans, two rows an SM) the pointers are random in
#: [0, W) (torch seed 0): the walk's steps do not depend on them
BACKTRACE_SHAPES = {"serving_64x751_w16_paths1": (64, 751, 16, 1), "window_1x1001_w16_paths16": (1, 1001, 16, 16),
                    "wide_264x751_w300_paths1": (264, 751, 300, 1)}
#: the serving add + LayerNorm's shape (kernels/add_ln.py): wav2vec2-base's 16 x 15 s forward (rows, D)
ADD_LN_SHAPE = (11984, 768)
#: bytes a fill writes before each call of a flushed timing: over twice the L2
FLUSH_BYTES = 128 << 20


def _cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def separable_shape_name(shape) -> str:
    t, c, co, k, stride, dilation = shape
    return f"{t}x{c}->{co}_k{k}_s{stride}_d{dilation}"


#: shapes that take one phase of the separable repeat away, beside the most frequent full shape (C 512, k 63):
#: C_out = 8 leaves the depthwise (and the span copies) with a product 64x smaller; k = 1 leaves the product (and
#: the copies) with a depthwise 63x smaller
SEPARABLE_PHASE_SHAPES = {
    "full": (751, 512, 512, 63, 1, 1),
    "depthwise_mostly": (751, 512, 8, 63, 1, 1),
    "product_mostly": (751, 512, 512, 1, 1, 1),
}


def _separable_ms(shape, batch: int, iters: int, gen) -> float:
    import torch

    from thunder_tpu_torch.kernels.separable_conv import fused_separable_repeat

    t, c, co, k, stride, dilation = shape
    x = torch.randn((batch, t, c), device="cuda", generator=gen).to(torch.bfloat16)
    dw = (torch.randn((k, c), device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
    pw = (torch.randn((c, co), device="cuda", generator=gen) * 0.05).to(torch.bfloat16)
    bias = torch.randn((co,), device="cuda", generator=gen)
    out_len = torch.full((batch,), -(-t // stride), dtype=torch.int32, device="cuda")
    return _cuda_ms(lambda: fused_separable_repeat(x, out_len, dw, pw, bias, k, stride=stride, dilation=dilation), iters)


def measure_separable(batch: int = 64, iters: int = 10) -> dict:
    """``fused_separable_repeat`` at each of ``QUARTZNET_SEPARABLE_SHAPES`` on random bf16 inputs (seed 0),
    with every row at full length: ``{name: ms}``, ``sum_77_ms`` (the count-weighted sum) and ``phases``
    (``SEPARABLE_PHASE_SHAPES``)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    out, total = {}, 0.0
    for shape, count in QUARTZNET_SEPARABLE_SHAPES.items():
        ms = _separable_ms(shape, batch, iters, gen)
        out[separable_shape_name(shape)] = ms
        total += count * ms
    out["sum_77_ms"] = total
    out["phases"] = {name: _separable_ms(shape, batch, iters, gen) for name, shape in SEPARABLE_PHASE_SHAPES.items()}
    return out


def measure_beam(iters: int = 10) -> dict:
    """``beam_scan`` at each of ``BEAM_SHAPES`` on the ``beam_device`` inputs (seed 3), every row at full
    length: ``{name: ms}``, ``"refused"`` where the checkout's wrapper raises before any launch, and
    ``{name}_topk_sort_ms`` (``candidates`` alone) where K < V."""
    import torch

    from thunder_tpu_torch.kernels.beam import beam_scan, candidates
    from thunder_tpu_torch.kernels.selftest import beam_case

    out = {}
    for name, (batch, frames, vocab, width, k) in BEAM_SHAPES.items():
        logits, _ = beam_case(3, batch, frames, vocab, "cuda")
        logp = torch.log_softmax(logits, dim=-1).contiguous()
        lens = torch.full((batch,), frames, dtype=torch.int32, device="cuda")
        try:
            beam_scan(logp, lens, -12.0, blank=0, beam_width=width, k_tokens=k)
        except ValueError:  # the wrapper's refusal, before any launch
            out[name] = "refused"
            continue
        out[name] = _cuda_ms(lambda: beam_scan(logp, lens, -12.0, blank=0, beam_width=width, k_tokens=k), iters)
        if k < vocab:
            out[f"{name}_topk_sort_ms"] = _cuda_ms(lambda: candidates(logp, k), iters)
    return out


def flushed_kernel_ms(fn, names, iters: int = 20) -> float:
    """Device milliseconds a call of ``fn`` in the kernels whose names hold one of ``names``, by torch.profiler's
    kernel durations, with the L2 flushed before each call (a fill of ``FLUSH_BYTES``, not counted): the kernels'
    own time with their inputs in device memory, neither the host's pace nor the gaps between launches in it."""
    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def call():
        flush.zero_()
        fn()

    by_kernel = device_ms_by_kernel(call, iters)
    del flush
    return sum(ms for name, ms in by_kernel.items() if any(n in name for n in names))


def measure_backtrace(iters: int = 20) -> dict:
    """``beam_backtrace`` at each of ``BACKTRACE_SHAPES``: ``{name: {...}}`` with the kernel's device time a call by
    the profiler, L2-flushed before each call (``flushed_ms``) and L2-warm (``warm_ms``), and, where the pointers
    are over 4 MB, ``cold_ms`` (:func:`cold_ms` over copies of the pointers, together over 100 MB: back-to-back
    launches, the gaps between them in the time); where the checkout has ``thunder_beam_backtrace_serial``, the same function by the serial walk on
    staged spans whatever the plan picks (``serial_cold_ms``, ``serial_flushed_ms``); and ``beam_decode_ms``, one
    ``beam_search_device`` call at the served shape (64 x 751 x 29), CUDA events, its host copies included."""
    import torch

    from thunder_tpu_torch.kernels import _build
    from thunder_tpu_torch.kernels.beam import beam_backtrace, beam_scan
    from thunder_tpu_torch.kernels.selftest import beam_case
    from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device

    lib = _build.load()
    serial = getattr(lib, "thunder_beam_backtrace_serial", None)
    if serial is not None:
        serial.argtypes, serial.restype = _build.SIGNATURES["thunder_beam_backtrace"], ctypes.c_int
    names = ("beam_backtrace",)
    out = {}
    for name, (batch, frames, width, paths) in BACKTRACE_SHAPES.items():
        if width == 16:
            logits, _ = beam_case(3, batch, frames, 29, "cuda")
            lens = torch.full((batch,), frames, dtype=torch.int32, device="cuda")
            logp = torch.log_softmax(logits, dim=-1).contiguous()
            parents, exts, total, _ = beam_scan(logp, lens, -12.0, blank=0, beam_width=width, k_tokens=29)
            slots0 = torch.argsort(-total, dim=1, stable=True)[:, :paths].to(torch.int32).contiguous()
        else:
            gen = torch.Generator(device="cuda").manual_seed(0)
            parents, exts = (torch.randint(0, width, (batch, frames, width), generator=gen, device="cuda",
                                           dtype=torch.int32) for _ in range(2))
            slots0 = torch.zeros((batch, paths), dtype=torch.int32, device="cuda")
        toks = torch.empty((batch, paths, frames), dtype=torch.int32, device="cuda")
        origin = torch.empty((batch, paths), dtype=torch.int32, device="cuda")

        def walk_serial(p, e):
            stream = torch.cuda.current_stream().cuda_stream
            _build.check(serial(p.data_ptr(), e.data_ptr(), slots0.data_ptr(), toks.data_ptr(), origin.data_ptr(),
                                batch, frames, width, paths, stream), "thunder_beam_backtrace_serial")

        routes = {"": lambda p, e: beam_backtrace(p, e, slots0)}
        if serial is not None:
            routes["serial_"] = walk_serial
        entry = {f"{prefix}flushed_ms": flushed_kernel_ms(lambda fn=fn: fn(parents, exts), names, iters)
                 for prefix, fn in routes.items()}
        entry["warm_ms"] = sum(device_ms_by_kernel(lambda: beam_backtrace(parents, exts, slots0), iters).values())
        if batch * frames * width * 8 < 4 << 20:  # a window's 128 KB: copies over 100 MB would fill the launch queue
            out[name] = entry
            continue
        sets = [(parents, exts)] + [(parents.clone(), exts.clone())
                                    for _ in range(-(-100_000_000 // (batch * frames * width * 8)) - 1)]
        entry["cold_sets"] = len(sets)
        for prefix, fn in routes.items():
            try:
                timed = cold_ms([lambda p=p, e=e, fn=fn: fn(p, e) for p, e in sets], max(2 * len(sets), 8))
            except RuntimeError as err:
                raise RuntimeError(f"{name}, {prefix or 'plan'} route: {err}") from err
            entry[f"{prefix}cold_ms"], entry[f"{prefix}cold_host_queue_ms"] = timed["ms"], timed["host_queue_ms"]
        del sets
        out[name] = entry
        if name.startswith("serving"):
            out["beam_decode_ms"] = _cuda_ms(lambda: beam_search_device(logits, lens, blank=0, beam_width=width), 5)
    return out


def measure_keep_mask_and_add_ln(iters: int = 40) -> dict:
    """``dropout_keep_mask`` at ``ADD_LN_TRAIN_SHAPE`` (rows, D, rate) and ``add_layer_norm`` (the serving kernel) at
    ``ADD_LN_SHAPE`` on random bf16 inputs (seed 1): each one's device time a call L2-cold (:func:`cold_ms`: six
    seeds for the mask, whose output is all it moves; ``COLD_SETS`` input sets for the add + LayerNorm), flushed
    (:func:`flushed_kernel_ms`) and L2-warm (the profiler)."""
    import torch

    from thunder_tpu_torch.kernels.add_ln import add_layer_norm
    from thunder_tpu_torch.kernels.add_ln_train import dropout_keep_mask

    rows, d, rate = ADD_LN_TRAIN_SHAPE
    seeds = [torch.tensor([20260821 + i], dtype=torch.int32, device="cuda") for i in range(COLD_SETS)]
    masks = [lambda s=s: dropout_keep_mask((rows, d), s, rate) for s in seeds]
    out = {"keep_mask": {"shape": [rows, d, rate], "cold_ms": cold_ms(masks, iters)["ms"],
                         "flushed_ms": flushed_kernel_ms(masks[0], ("dropout_keep_mask",)),
                         "warm_ms": sum(device_ms_by_kernel(masks[0], 10).values())}}
    n_rows, n_d = ADD_LN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    sets = [tuple((torch.randn((n_rows, n_d), device="cuda", generator=gen) * sd).to(torch.bfloat16) for sd in (2.0, 1.0))
            for _ in range(COLD_SETS)]
    scale = torch.randn((n_d,), device="cuda", generator=gen) + 1.0
    bias = torch.randn((n_d,), device="cuda", generator=gen)
    calls = [lambda x=x, y=y: add_layer_norm(x, y, scale, bias) for x, y in sets]
    out["add_ln"] = {"shape": [n_rows, n_d], "cold_ms": cold_ms(calls, iters)["ms"],
                     "flushed_ms": flushed_kernel_ms(calls[0], ("add_ln",)),
                     "warm_ms": sum(device_ms_by_kernel(calls[0], 10).values())}
    return out


def cold_ms(calls, iters: int = 40) -> dict:
    """Device milliseconds a call of ``calls`` (functions of no argument, each on its own inputs, together over
    the L2's 50 MB), called in turn ``iters`` times back to back, by CUDA events. A sleep kernel holds the card
    until the host has queued every call, so the host's pace is not in the time; each call finds its inputs in
    device memory. Returns ``{"ms", "host_queue_ms", "held_ms"}``: the host's queueing must end inside the hold."""
    import torch

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    before.record()
    torch.cuda._sleep(50_000_000)  # about 25 ms at the card's clock
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        calls[i % len(calls)]()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    held = before.elapsed_time(start)
    if host_ms >= held:
        raise RuntimeError(f"the host queued for {host_ms} ms, past the card's {held} ms hold: the time is the host's")
    return {"ms": start.elapsed_time(end) / iters, "host_queue_ms": host_ms, "held_ms": held}


def measure_add_ln(iters: int = 40) -> dict:
    """The add + dropout + LayerNorm training kernels at ``ADD_LN_TRAIN_SHAPE`` on random bf16 inputs (seed 0):
    the forward's and the backward's (with its partial sum) device time a call, L2-cold (:func:`cold_ms` over
    ``COLD_SETS`` input sets) and L2-warm (one set, torch.profiler's kernel times: ``*_warm_ms``)."""
    import torch

    from thunder_tpu_torch.kernels.add_ln_train import add_ln_train_backward, add_ln_train_forward

    rows, d, rate = ADD_LN_TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = lambda scale: (torch.randn((rows, d), device="cuda", generator=gen) * scale).to(torch.bfloat16)  # noqa: E731
    sets = [(bf(2.0), bf(1.0), bf(1.0)) for _ in range(COLD_SETS)]
    scale = torch.randn((d,), device="cuda", generator=gen) + 1.0
    bias = torch.randn((d,), device="cuda", generator=gen)
    seed = torch.tensor([20260821], dtype=torch.int32, device="cuda")
    fwd = [lambda x=x, y=y: add_ln_train_forward(x, y, scale, bias, seed, rate) for x, y, _ in sets]
    bwd = [lambda x=x, y=y, do=do: add_ln_train_backward(x, y, scale, seed, do, rate) for x, y, do in sets]
    out = {"shape": [rows, d, rate]}
    for name, calls in (("fwd", fwd), ("bwd", bwd)):
        cold = cold_ms(calls, iters)
        out[f"{name}_cold_ms"], out[f"{name}_cold_host_queue_ms"] = cold["ms"], cold["host_queue_ms"]
        out[f"{name}_warm_ms"] = sum(device_ms_by_kernel(calls[0], 10).values())
    by_kernel = device_ms_by_kernel(lambda: [fn() for fn in bwd], 5)  # a call of each set, in turn
    out["bwd_cold_by_kernel_ms"] = {name: ms / len(bwd) for name, ms in by_kernel.items()}
    return out


def _log_mel_refused(n_fft: int = 512, hop_length: int = 160, win_length: int = 320, n_mels: int = 64, **_) -> bool:
    """Whether the checkout's log-mel wrapper refuses these sizes, decided before any launch: by its plan where
    it has one, else by the predicate of the dense kernel it replaced (at most 1,024 bins, n_fft and hop
    multiples of 4)."""
    from thunder_tpu_torch.kernels import frontend

    if hasattr(frontend, "log_mel_plan"):
        return frontend.log_mel_plan(n_fft, hop_length, win_length, n_mels)["smem_bytes"] == 0
    return n_fft // 2 + 1 > 1024 or n_fft % 4 != 0 or hop_length % 4 != 0


def measure_log_mel(iters: int = 20) -> dict:
    """``fused_log_mel`` at each of ``LOG_MEL_SHAPES`` on noise audio (seed 0): ``{name: ms}``, or ``"refused"``
    where the checkout's wrapper does not take the sizes (:func:`_log_mel_refused`)."""
    import torch

    from thunder_tpu_torch.kernels.frontend import fused_log_mel

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (batch, samples, kw) in LOG_MEL_SHAPES.items():
        if _log_mel_refused(**kw):
            out[name] = "refused"
            continue
        audio = torch.randn((batch, samples), device="cuda", generator=gen) * 0.1
        out[name] = _cuda_ms(lambda: fused_log_mel(audio, **kw), iters)
    return out


def measure(parts=PARTS) -> dict:
    """The timings of the checkout that ``thunder_tpu_torch`` imports from, for the groups in ``parts``."""
    import numpy as np
    import torch

    from thunder_tpu_torch.kernels import _build

    _build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(Path(sys.modules["thunder_tpu_torch"].__file__).parents[1])}

    if "separable" in parts:
        out["separable_ms"] = measure_separable()
    if "log_mel" in parts:
        out["log_mel_ms"] = measure_log_mel()
    if "beam" in parts:
        out["beam_scan_ms"] = measure_beam()
        out["beam_backtrace"] = measure_backtrace()
    if "add_ln" in parts:
        out["add_ln_train"] = measure_add_ln()
        out.update(measure_keep_mask_and_add_ln())
    if "attention" in parts:
        _measure_attention(out, gen)
    if "ctc" in parts:
        _measure_ctc(out, gen)
    rng = np.random.default_rng(0)
    vocab = list("abcdefghijklmnopqrstuvwxyz '.,?")
    audio = torch.as_tensor((rng.standard_normal((16, 240000)) * 0.1).astype(np.float32), device="cuda")
    audio_lens = torch.full((16,), 240000, dtype=torch.int32, device="cuda")
    step_gen = torch.Generator(device="cuda").manual_seed(0)
    if "wav2vec2" in parts:
        _measure_wav2vec2(out, vocab, audio, audio_lens, step_gen)
    if "quartznet" in parts:
        _measure_quartznet(out, rng, step_gen)
    if "citrinet" in parts:
        _measure_citrinet(out)
    if "sync_step" in parts:
        _measure_sync_step(out)
    if "mms" in parts:
        _measure_mms(out, vocab, audio, audio_lens)
    return out


def _measure_attention(out: dict, gen) -> None:
    import torch

    from thunder_tpu_torch.kernels.attention import mha_from_qkv
    from thunder_tpu_torch.kernels.attention_train import mha_train_backward, mha_train_forward

    qkv = torch.randn((16, 749, 3 * 768), device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.full((16,), 749, dtype=torch.int32, device="cuda")
    out["attention_serving_ms"] = _cuda_ms(lambda: mha_from_qkv(qkv, lens, 12), 50)
    qkv8, lens8 = (qkv[:8] * 0.3).contiguous(), lens[:8]
    out["attention_serving_b8_ms"] = _cuda_ms(lambda: mha_from_qkv(qkv8, lens8, 12), 50)
    seed = torch.tensor([20260821], dtype=torch.int32, device="cuda")
    out["attention_train_fwd_ms"] = _cuda_ms(lambda: mha_train_forward(qkv8, lens8, seed, 12, 0.1), 50)
    # the backward alone at the step's length (15 s) and at 30 s, with dropout and without
    for t, suffix in ((749, ""), (1499, "_1499")):
        x = qkv8 if t == 749 else (torch.randn((8, t, 3 * 768), device="cuda", generator=gen) * 0.3).to(torch.bfloat16)
        lens_t = torch.full((8,), t, dtype=torch.int32, device="cuda")
        dout = torch.randn((8, t, 768), device="cuda", generator=gen).to(torch.bfloat16)
        for rate, tag in ((0.1, ""), (0.0, "_rate0")):
            o, stats = mha_train_forward(x, lens_t, seed, 12, rate)
            out[f"attention_train_bwd{suffix}{tag}_ms"] = _cuda_ms(
                lambda: mha_train_backward(x, o, stats, dout, lens_t, seed, 12, rate), 20)
            if not suffix and not tag:
                out["attention_train_bwd_by_kernel_ms"] = device_ms_by_kernel(
                    lambda: mha_train_backward(x, o, stats, dout, lens_t, seed, 12, rate), 10)


def device_ms_by_kernel(fn, iters: int) -> dict:
    """The device time of each kernel that ``iters`` calls of ``fn`` launch, per call, by torch.profiler
    (after one call outside it): ``{kernel name (60 characters): ms}``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return by_name


def _measure_ctc(out: dict, gen) -> None:
    import torch

    from thunder_tpu_torch.kernels.ctc import ctc_alpha, ctc_beta, ll_from_alpha
    from thunder_tpu_torch.ops.ctc import extended_emissions

    for name, (batch, frames, vocab) in CTC_SHAPES.items():
        logits = torch.randn((batch, frames, vocab), device="cuda", generator=gen)
        targets = torch.randint(1, vocab, (batch, 64), device="cuda", generator=gen, dtype=torch.int32)
        tl = torch.randint(10, 65, (batch,), device="cuda", generator=gen, dtype=torch.int32)
        lens = torch.full((batch,), frames, dtype=torch.int32, device="cuda")
        lp_z, skip_ok = extended_emissions(torch.log_softmax(logits, dim=-1), targets, blank=0)
        alpha = ctc_alpha(lp_z, skip_ok, lens, tl)
        ll, ghat = ll_from_alpha(alpha, lens, tl), 1.0 / tl.float()
        alpha_ms = _cuda_ms(lambda: ctc_alpha(lp_z, skip_ok, lens, tl), 50)
        beta_ms = _cuda_ms(lambda: ctc_beta(lp_z, alpha, skip_ok, lens, tl, ll, ghat), 50)
        pair_ms = _cuda_ms(lambda: (ctc_alpha(lp_z, skip_ok, lens, tl),
                                    ctc_beta(lp_z, alpha, skip_ok, lens, tl, ll, ghat)), 50)
        out[f"ctc_{name}"] = {"pair_ms": pair_ms, "alpha_ms": alpha_ms, "beta_ms": beta_ms,
                              "alpha_ns_per_frame": alpha_ms * 1e6 / frames, "beta_ns_per_frame": beta_ms * 1e6 / frames}
    out["ctc_pair_ms"] = out["ctc_quartznet_16x751"]["pair_ms"]


def _measure_wav2vec2(out: dict, vocab, audio, audio_lens, step_gen) -> None:
    import torch

    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.optim import adamw
    from thunder_tpu_torch.training.trainer import TrainStep, _encode_targets

    module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                              Wav2Vec2Encoder(Wav2Vec2Config()), LinearDecoder(len(vocab) + 1),
                              BatchTextTransformer(vocab), device="cuda")
    engine = InferenceEngine(module)
    out.update(_forward_fingerprint("w2v2", engine, audio, audio_lens))
    out["w2v2_forward_ms"] = _cuda_ms(lambda: engine.infer(audio, audio_lens), 5)
    del engine, module

    tt = BatchTextTransformer(vocab)
    cfg = Wav2Vec2Config(hidden_dropout=0.1, attention_dropout=0.1, feat_proj_dropout=0.1)
    train = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=False),
                             Wav2Vec2Encoder(cfg, dtype=torch.bfloat16, freeze_feature_extractor=True),
                             LinearDecoder(tt.num_tokens, dtype=torch.bfloat16), tt, device="cuda")
    tgt, tgt_lens = _encode_targets(tt, ["the quick brown fox jumps over the lazy dog"] * 8)
    batch = (audio[:8], audio_lens[:8], torch.as_tensor(tgt, device="cuda"), torch.as_tensor(tgt_lens, device="cuda"))
    step = TrainStep(train.model, adamw(train.model.parameters(), learning_rate=1e-4), train.blank_idx)
    for _ in range(2):
        step(*batch, step_gen)
    out["w2v2_train_step_ms"] = _cuda_ms(lambda: step(*batch, step_gen), 5)
    # the step's add + dropout + LayerNorm kernels (forward, backward, partial sum) by torch.profiler
    by_kernel = device_ms_by_kernel(lambda: step(*batch, step_gen), 2)
    out["w2v2_train_step_add_ln_ms"] = sum(ms for name, ms in by_kernel.items() if "add_ln_train_" in name)


def _measure_mms(out: dict, vocab, audio, audio_lens) -> None:
    import torch

    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                              Wav2Vec2Encoder(Wav2Vec2Config(**MMS_1B)), LinearDecoder(len(vocab) + 1),
                              BatchTextTransformer(vocab), device="cuda")
    engine = InferenceEngine(module)
    out.update(_forward_fingerprint("mms", engine, audio, audio_lens))
    out["mms_forward_ms"] = _cuda_ms(lambda: engine.infer(audio, audio_lens), 5)


def _forward_fingerprint(prefix: str, engine, audio, lengths) -> dict:
    """One forward's launches by kernel wrapper and the SHA-256 of its float32 logits' bytes, so that two
    checkouts' forwards can be found equal bit for bit."""
    import hashlib

    import torch

    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts

    reset_launch_counts()
    logits = engine.infer(audio, lengths)[0]
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in KERNEL_WRAPPERS if w.launches}
    digest = hashlib.sha256(logits.float().contiguous().cpu().numpy().tobytes()).hexdigest()
    return {f"{prefix}_launches": launches, f"{prefix}_logits_sha256": digest}


def _measure_quartznet(out: dict, rng, step_gen) -> None:
    import numpy as np
    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.optim import adamw
    from thunder_tpu_torch.training.trainer import TrainStep, _encode_targets

    chars = BatchTextTransformer(list("abcdefghijklmnopqrstuvwxyz '"))
    qn = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(), QuartznetEncoder(repeat_blocks=3),
                          Conv1dDecoder(29), chars, device="cuda")
    qn_engine = InferenceEngine(qn)
    qn_audio = torch.as_tensor((rng.standard_normal((64, 240000)) * 0.1).astype(np.float32), device="cuda")
    qn_lens = torch.full((64,), 240000, dtype=torch.int32, device="cuda")
    out.update(_forward_fingerprint("quartznet", qn_engine, qn_audio, qn_lens))
    out["quartznet_forward_ms"] = _cuda_ms(lambda: qn_engine.infer(qn_audio, qn_lens), 20)
    host_audio, host_lens = qn_audio.cpu().numpy(), qn_lens.cpu().numpy()
    qn_engine.predict(host_audio, host_lens, beam_width=16, beam_backend="device")
    beam_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qn_engine.predict(host_audio, host_lens, beam_width=16, beam_backend="device")
        beam_ms.append((time.perf_counter() - t0) * 1e3)
    out["quartznet_beam_predict_ms"] = float(np.median(beam_ms))
    del qn_engine, qn
    augmenting = FilterbankFeatures(num_time_masks=2, num_freq_masks=2)
    qn_train = CTCModule.create(torch.Generator().manual_seed(0), augmenting,
                                QuartznetEncoder(repeat_blocks=3, dropout=0.1, dtype=torch.bfloat16),
                                Conv1dDecoder(29, dtype=torch.bfloat16), chars, device="cuda")
    tgt, tgt_lens = _encode_targets(chars, ["the quick brown fox jumps over the lazy dog"] * 16)
    batch = (qn_audio[:16], qn_lens[:16], torch.as_tensor(tgt, device="cuda"), torch.as_tensor(tgt_lens, device="cuda"))
    step = TrainStep(qn_train.model, adamw(qn_train.model.parameters(), learning_rate=1e-4), qn_train.blank_idx)
    for _ in range(2):
        step(*batch, step_gen)
    out["quartznet_train_step_ms"] = _cuda_ms(lambda: step(*batch, step_gen), 5)


def _measure_citrinet(out: dict) -> None:
    import numpy as np
    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.models import CitrinetEncoder, Conv1dDecoder
    from thunder_tpu_torch.models.citrinet import CITRINET_256_FILTERS, CITRINET_256_KERNELS, CITRINET_256_STRIDES
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    vocab = [chr(0x4E00 + i) for i in range(1024)]
    encoder = CitrinetEncoder(CITRINET_256_FILTERS, CITRINET_256_KERNELS, CITRINET_256_STRIDES, feat_in=80)
    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(nfilt=80, dither=0.0), encoder,
                              Conv1dDecoder(len(vocab) + 1), BatchTextTransformer(vocab), device="cuda")
    engine = InferenceEngine(module)
    rng = np.random.default_rng(1)
    audio = torch.as_tensor((rng.standard_normal((64, 240000)) * 0.1).astype(np.float32), device="cuda")
    lengths = torch.full((64,), 240000, dtype=torch.int32, device="cuda")
    out.update(_forward_fingerprint("citrinet", engine, audio, lengths))
    out["citrinet_forward_ms"] = _cuda_ms(lambda: engine.infer(audio, lengths), 20)


def _measure_sync_step(out: dict) -> None:
    """QuartzNet15x5's greedy forward at 64 x 15 s taken one request at a time, each ended by a synchronize, as
    ``chip_smoke.py``'s profiling phase times it, in ``SYNC_STEP_ROUNDS`` rounds. A round's numbers, after a
    ``gc.collect()``: the forward back to back (CUDA events over 10, the mean of one taken before and one after the
    steps), ``StepTimer``'s RTF over 10 synchronized
    forwards over the RTF of that forward (``timer_ratio``; the collections of each generation in those steps), the
    host's time to queue one forward (median of 10, from a synchronized card), and
    the device time from a synchronized step's start to the end of its frontend as the engine runs it (the log-mel
    and the graph of the rest where the checkout's engine has one; median of 20, CUDA events)."""
    import gc
    import statistics

    import numpy as np
    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.profiling import StepTimer
    from thunder_tpu_torch.text import BatchTextTransformer

    chars = BatchTextTransformer(list("abcdefghijklmnopqrstuvwxyz '"))
    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(), QuartznetEncoder(repeat_blocks=3),
                              Conv1dDecoder(29), chars, device="cuda")
    engine = InferenceEngine(module)
    rng = np.random.default_rng(0)
    batch, samples = 64, 240000
    audio = torch.as_tensor((rng.standard_normal((batch, samples)) * 0.1).astype(np.float32), device="cuda")
    lengths = torch.full((batch,), samples, dtype=torch.int32, device="cuda")
    out.update(_forward_fingerprint("sync_step", engine, audio, lengths))
    forward = lambda: engine.infer(audio, lengths)  # noqa: E731
    tail = getattr(engine, "_frontend_tail", None)  # the engine's CUDA graph after the log-mel, where it has one

    @torch.inference_mode()
    def frontend():
        if tail is None:
            return engine.frontend(audio, lengths)
        return tail(engine.frontend.log_mel(audio), lengths)

    rounds = []
    for _ in range(SYNC_STEP_ROUNDS):
        gc.collect()
        forward_ms = _cuda_ms(forward, 10)
        timer, collections = StepTimer(), gc.get_stats()
        for _ in range(10):
            with timer.step(batch * samples):
                forward()
                torch.cuda.synchronize()
        collections = [b["collections"] - a["collections"] for a, b in zip(collections, gc.get_stats())]
        forward_ms = (forward_ms + _cuda_ms(forward, 10)) / 2
        queue_ms, frontend_ms = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            queue_ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(20):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            frontend()
            end.record()
            torch.cuda.synchronize()
            frontend_ms.append(start.elapsed_time(end))
        rounds.append({"forward_ms": forward_ms, "step_ms": [t * 1e3 for t in timer.times],
                       "collections_in_steps": collections,
                       "timer_ratio": timer.summary()["rtf"] / (batch * samples / 16000 / (forward_ms / 1e3)),
                       "queue_ms": statistics.median(queue_ms), "frontend_ms": statistics.median(frontend_ms)})
    out["sync_step"] = rounds


def _library(root: Path) -> Path:
    """The kernel library a checkout built last."""
    return max((root / "thunder_tpu_torch" / "build").glob("libthunder_kernels_*.so"), key=lambda p: p.stat().st_mtime)


def _sass_functions(library: Path) -> dict:
    """``{mangled name: [instruction text]}`` of a library, by ``cuobjdump -sass``, addresses and encodings dropped."""
    from thunder_tpu_torch.kernels import _build

    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    functions, current = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            current = functions.setdefault(line.split("Function :")[1].strip(), [])
        elif current is not None and line.strip().startswith("/*") and "*/" in line:
            instruction = line.split("*/", 1)[1].split("/*")[0].strip()
            if instruction:
                current.append(instruction)
    return functions


def sass_diff(pairs: list, this: Path, other: Path) -> dict:
    """For each (this side's name, the other side's name): each side's instruction count and the lines that differ."""
    mine, theirs = _sass_functions(_library(this)), _sass_functions(_library(other))
    out = {}
    for name, other_name in pairs:
        a = [f for f in mine if name in f]
        b = [f for f in theirs if other_name in f]
        if len(a) != 1 or len(b) != 1:
            raise SystemExit(f"--sass: {name!r} names {len(a)} kernels here and {other_name!r} {len(b)} there")
        ours, parent = mine[a[0]], theirs[b[0]]
        changed = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in
                      difflib.SequenceMatcher(None, ours, parent, autojunk=False).get_opcodes() if tag != "equal")
        out[name] = {"this_instructions": len(ours), "other_instructions": len(parent), "lines_differing": changed}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    parser.add_argument("--parts", default=",".join(PARTS), help="comma-separated groups to time (default: all)")
    parser.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--sass", default="", help="kernels whose SASS to compare, THIS=OTHER or NAME, comma-separated")
    args = parser.parse_args()
    parts = tuple(args.parts.split(","))
    unknown = set(parts) - set(PARTS)
    if unknown:
        parser.error(f"unknown parts {sorted(unknown)}; choose from {PARTS}")
    if args.measure:
        print(json.dumps(measure(parts)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    other = Path(args.other).resolve()
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        root = other if side == "other" else ROOT
        env = {**os.environ, "PYTHONPATH": str(root)}
        proc = subprocess.run([sys.executable, __file__, "--other", str(other), "--parts", args.parts, "--measure"],
                              cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": side, **result}), flush=True)
        runs[side].append(result)
    if args.sass:
        pairs = [(item.split("=")[0], item.split("=")[-1]) for item in args.sass.split(",")]
        print(json.dumps({"sass": sass_diff(pairs, ROOT, other)}), flush=True)
    every = runs["other"] + runs["this"]
    same = {key: all(r[key] == every[0][key] for r in every) for key in every[0]
            if key.endswith(("_logits_sha256", "_launches"))}
    print(json.dumps({"same_on_both_sides": same}), flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
