"""Smoke run of the PyTorch/CUDA port (``thunder_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a Hopper card (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which fails the run:

1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
2. build the CUDA kernels from ``thunder_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card
   (``thunder_tpu_torch.kernels.selftest``), one JSON line per check (the
   log-mel also at the ``frontend_log_mel_edge_*`` sizes: 44.1 and 48 kHz,
   hop 161, n_fft 4096, the dense path's n_fft 400, a row of zeros, one
   frame);
4. QuartzNet15x5 greedy serving through ``CTCModule.create`` and
   ``InferenceEngine.predict`` at 64 rows x 15 s of speech-like audio, with
   random weights (seed 0) and random BN statistics: the launch counts of
   one forward must be 1 log-mel and 77 separable repeats; rows 0-1 are held
   against the port's float32 CPU path (bf16-vs-f32 bound 0.1 of the logits'
   scale); RTF = audio seconds per second of device time; one forward under
   torch.profiler gives the device time by kernel and the device's idle
   share between the forward's first and last device event;
5. each kernel's time and its plain version's at the main path's shapes; for
   the log-mel, the path its plan takes (must be ``"fft"``), and a chain of
   PyTorch calls for the same function (preemphasis, ``torch.stft`` with the
   centered reflect pad and the window, which runs cuFFT, ``|.|^2``,
   ``torch.matmul`` with the filterbank and the guarded log: timed only, the
   kernels line's ``library_ms``), and the frontend's time apart: the
   log-mel, the masked per-feature normalize and the whole
   ``FilterbankFeatures`` call; for the separable repeat, at each of its eight shapes, also a chain of PyTorch
   calls for the same function (bf16 ``F.conv1d(groups=C)`` + ``torch.matmul``
   + bias, ReLU and mask: timed only, its sum is the kernels line's
   ``library_ms``) and the kernel's launch plan (shared memory a block, ring
   stages, resident blocks per SM);
6. QuartzNet15x5 CTC training at 16 rows x 15 s (``bench_train.py --model
   quartznet``: SpecAugment 2+2 masks, dither, dropout 0.1, bf16 compute with
   float32 parameters, AdamW lr 1e-4, random noise audio from numpy seed 0,
   one fixed text padded to 64 labels): one ``Trainer.fit`` step must make
   exactly 1 log-mel, 1 ``ctc_alpha`` and 1 ``ctc_beta`` launch (and no
   separable repeat: training runs PyTorch convolutions, as the JAX package
   trains through XLA); then ``TRAIN_WARMUP`` warm-up steps and
   ``TRAIN_TIMED`` steps timed with CUDA events (step ms, audio seconds per
   second, peak memory), one step under torch.profiler, every loss finite and
   the loss of the last step below ``1 - LOSS_FALL`` times the first; one
   train-mode forward with dropout and augmentation off, bf16 on the card
   against the port's float32 CPU path on rows 0-1, within
   ``TRAIN_LOSS_BOUND``;
7. the CTC kernel pair at the training shape against its plain version and
   against ``F.ctc_loss`` forward + backward (``library_ms``, timed here only:
   the port never calls it);
8. wav2vec2-base greedy serving (``scripts/bench_w2v2.py``'s configuration:
   ``Wav2Vec2Preprocess(mask_input=True)``, 7-conv extractor, 12 post-LN
   layers of hidden 768 and 12 heads, ``LinearDecoder`` over 31 characters and
   the blank) through ``CTCModule.create`` and ``InferenceEngine.predict`` at
   16 rows x 15 s of speech-like audio (T = 749 frames), random weights
   (seed 0): one forward must make exactly 12 attention and 25 add +
   LayerNorm launches and no other kernel launch; rows 0-1 are held against
   the port's float32 CPU path (``LOGIT_BOUND``), with the argmax agreement
   printed; RTF from CUDA events and one profiled forward; one 40 s
   speech-like clip through ``predict`` (T = 1999 frames, past the 1664 that
   the first attention kernel's score panel held) must make the same 12 + 25
   launches and give the transcript of the same predict through the plain
   versions (logits within ``LOGIT_BOUND`` of theirs, argmax agreement
   printed); then both kernels at the shapes of that forward (layer 0's own
   qkv and its first add + LayerNorm's inputs, captured by hooks) against
   their plain versions and a PyTorch call (the split into heads +
   ``F.scaled_dot_product_attention`` with the key mask; ``F.layer_norm`` of
   the float32 sum), timed here only; the attention kernel and its PyTorch
   call are timed ``SPREAD_REPEATS`` times in turns (minimum, median and
   maximum printed; the median goes to the kernels line);
9. beam serving on the QuartzNet15x5 engine of phase 4, same 64 x 15 s batch:
   one ``InferenceEngine.predict(audio, beam_width=16, beam_backend="device")``
   must make exactly 1 log-mel, 77 separable-repeat, 1 ``beam_scan`` and 1
   ``beam_backtrace`` launch, and its transcripts must equal the same predict
   through the plain versions on the card, for all 64 rows; the beam decode
   is timed with CUDA events on the forward's own logits (the whole
   ``beam_search_device`` call, the scan and the backtrace apart, each beside
   its plain version), and the whole predict on the host clock; on peaked
   logits (``scripts/bench_beam_device.py::peaked_logits``: 70 % blank
   frames, peak 6, numpy seed 0) rows 0-1 must equal the port's numpy host
   search, and on the served logits the share of rows 0-1 that agree with it
   is printed; ``predict_long`` on a 60 s speech-like clip with the device
   beam must make one launch of each beam kernel per window and give the
   text of the same windows through the plain versions; the scan alone is
   timed on the first window's logits (B = 1, one 20 s window); and the scan
   past one block of shared memory (phase ``beam_chunked_shape``: B = 16, T =
   188, V = K = 3000, W = 16, the ``beam_device`` inputs of numpy seed 3, the
   chunked kernel) must equal its plain version exactly, both timed;
10. wav2vec2-base CTC training at 8 rows x 15 s (``bench_train.py --model
    wav2vec2``: ``Wav2Vec2Preprocess(mask_input=False)``, the feature
    extractor frozen, attention, hidden and feature-projection dropout 0.1,
    bf16 compute with float32 parameters, AdamW lr 1e-4, random noise audio
    from numpy seed 0, T = 749 frames, one fixed text padded to 64 labels),
    full width and depth: one ``Trainer.fit`` step must make exactly 12
    ``mha_train`` forward launches and 24 backward (the dq and the dk/dv
    kernel of each layer), 25 add + dropout + LayerNorm forward launches and
    50 backward (the backward and the sum of its partial ``dscale``/``dbias``
    rows), 1 ``ctc_alpha`` and 1 ``ctc_beta``, and no other kernel launch;
    then ``W2V_TRAIN_WARMUP`` warm-up steps and ``W2V_TRAIN_TIMED`` steps
    timed with CUDA events (step ms, audio seconds per second, peak memory),
    one step under torch.profiler, every loss finite and the last below ``1 -
    W2V_LOSS_FALL`` times the first; one train-mode forward with every
    dropout rate 0, bf16 on the card against the port's float32 CPU path on
    rows 0-1, within ``W2V_TRAIN_LOSS_BOUND``; two steps with the extractor
    trained too (``--no-freeze``) at 2 rows x 15 s: finite losses, and every
    extractor parameter receives a gradient;
11. the training kernels at that step's own shapes (layer 0's packed qkv and
    the cotangent of its attention output, its first add + LayerNorm's inputs
    and cotangent, captured by hooks; each cotangent times the power of two
    that brings its largest magnitude to 1, since a mean CTC loss's are about
    1e-7): forward and backward against the plain versions (8 bf16 ULP, dq, dk
    and dv each at their own magnitude; 1 % for ``dscale``/``dbias``; zeros in
    place of a gradient must fail the same comparison), their times, the plain
    versions' and a PyTorch call's, forward + backward (the split into heads +
    ``F.scaled_dot_product_attention`` with the key mask and ``dropout_p=0.1``;
    ``F.dropout`` + ``F.layer_norm`` of the float32 sum), timed here only (the
    attention's forward, backward at rate 0.1 and at rate 0, and its PyTorch
    call's forward, backward alone on a retained graph and forward + backward
    ``SPREAD_REPEATS`` times in turns, as in phase 8; the PyTorch backward's
    kernels by device time, which name its backend; the add + LayerNorm
    kernels' device time a call with their inputs in device memory, as a step
    finds them, ``fwd_cold_ms`` and ``bwd_cold_ms``: the step's inputs and
    five more sets of their shape in turns, 166 MB in all, by CUDA events
    with the card held by a sleep kernel until the host has queued every
    call, which is the kernels line's ``ms``; beside it their L2-warm time
    by torch.profiler and their back-to-back time at the host's pace); and
    ``dropout_keep_mask`` at the add + LayerNorm's shape against its plain
    version (equal) and ``torch.rand`` (timed only). The train step never
    launches ``dropout_keep_mask``: its ``launches`` is 0 and the count of
    that one call stands under ``own_call_launches``.

Every kernel's ``bound_ms`` is computed from this run's shapes: the largest
of its bytes (each input read once, each output written once) over 3.35
TB/s and its operations of each type over the published peak for that type
(989 TFLOP/s bf16 tensor, 67 TFLOP/s float32), for an H100 SXM at 700 W.
The log-mel's operations are an FFT-based STFT's, the least the function
needs; its bytes are the audio in, the log-mel out and the kernel's tables. The training attention's
are 4 T^2 64 forward and 10 T^2 64 backward a head and row (five products, the
least the function needs, whatever the kernels recompute).

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

VOCAB = list("abcdefghijklmnopqrstuvwxyz '")
BATCH, SECONDS, SAMPLE_RATE = 64, 15.0, 16000
LOGIT_BOUND = 0.1  # max|bf16 card - f32 CPU| / max|f32 CPU| over valid frames
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_TEXT = 16, 15.0, "the quick brown fox jumps over the lazy dog"
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
W2V_VOCAB = list("abcdefghijklmnopqrstuvwxyz '.,?")
W2V_BATCH, W2V_SECONDS = 16, 15.0
LONG_CLIP_SECONDS = 40  # wav2vec2 serving past the 1664 frames (33.3 s) that the first attention kernel held
# the last of the 1 + TRAIN_WARMUP + TRAIN_TIMED = 14 losses must be below (1 - LOSS_FALL) x the first; on the
# port's float32 CPU path, the same configuration at 4 x 3 s and 2 x 6 s ended at 0.38 and 0.25 of the first loss
LOSS_FALL = 0.25
# |bf16 card - f32 CPU| / |f32 CPU| of the train-mode loss on rows 0-1: bf16 activations through 54 conv
# layers with batch statistics; the serving logits deviate by 0.004 of their scale, the loss sums 751 frames
TRAIN_LOSS_BOUND = 0.05
W2V_TRAIN_BATCH, W2V_TRAIN_WARMUP, W2V_TRAIN_TIMED = 8, 2, 5
# the last of the 1 + W2V_TRAIN_WARMUP + W2V_TRAIN_TIMED = 8 losses must be below (1 - W2V_LOSS_FALL) x the first;
# on the port's float32 CPU path the same configuration (frozen extractor, dropout 0.1, lr 1e-4) at a small
# size (4 x 3 s, hidden 128, 2 layers; 2 x 6 s, hidden 256, 4 layers) ended its 8th step at 0.59 and 0.40 of the first
W2V_LOSS_FALL = 0.15
# |bf16 card - f32 CPU| / |f32 CPU| of the train-mode loss with every dropout rate 0 on rows 0-1: the serving
# logits of the same model deviate by about 0.01 of their scale, and the loss averages 749 frames
W2V_TRAIN_LOSS_BOUND = 0.05
TRAIN_KERNEL_ULP = 8.0  # the training kernels against their plain versions, bf16 ULP (dscale, dbias: 1 %)
HBM_BYTES_PER_MS = 3.35e9  # 3.35 TB/s
BF16_FLOP_PER_MS, F32_FLOP_PER_MS = 989e9, 67e9  # dense tensor-core bf16, float32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def speech_like(samples: int, rng: np.random.Generator) -> np.ndarray:
    """A speech-like harmonic series with pitch and amplitude modulation plus noise."""
    t = np.arange(samples) / SAMPLE_RATE
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)  # pitch contour
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t))  # syllable-rate AM
    return (0.15 * envelope * voiced + 0.01 * rng.standard_normal(samples)).astype(np.float32)


def randomize_bn(module, seed: int = 0) -> None:
    """Non-trivial BN statistics and affines, so that BN folding is exercised."""
    import torch

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.model.state_dict().items():
            if name.endswith(".var"):
                t.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, t.shape).astype(np.float32)))
            elif name.endswith((".mean", ".bn.scale", ".bn.bias")):
                t.copy_(torch.as_tensor((rng.standard_normal(t.shape) * 0.3).astype(np.float32)))


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches, after a warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain, iters: int) -> tuple[float, float]:
    """Kernel and plain times taken in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = cuda_ms(plain, iters), cuda_ms(kernel, iters), cuda_ms(kernel, iters), cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


SPREAD_REPEATS = 5


def spread_ms(fns: dict, iters: int, repeats: int = SPREAD_REPEATS) -> dict:
    """Each of ``fns`` timed ``repeats`` times by :func:`cuda_ms`, in turns (all of them once, then again):
    ``{name: {"min", "median", "max", "runs"}}`` in milliseconds."""
    runs = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            runs[name].append(cuda_ms(fn, iters))
    return {name: {"min": min(r), "median": float(np.median(r)), "max": max(r), "runs": r} for name, r in runs.items()}


#: device-time categories of a profile, by the first pattern a kernel's name contains
PROFILE_CATEGORIES = (
    ("ctc_recursion", ("ctc_alpha_kernel", "ctc_beta_kernel")),
    ("attention_train", ("mha_forward_kernel<true>", "mha_forward_kernel<(bool)1>", "mha_train_dq_kernel",
                         "mha_train_dkv_kernel")),
    ("attention", ("mha_forward_kernel",)),
    ("add_layer_norm_train", ("add_ln_train_",)),
    ("add_layer_norm", ("add_ln_kernel",)),
    ("beam_search", ("beam_scan_kernel", "beam_backtrace_kernel")),
    ("log_mel", ("log_mel",)),
    ("separable_repeat", ("separable_repeat_kernel",)),
    ("depthwise_conv", ("conv_depthwise",)),
    ("conv_backward", ("dgrad", "wgrad")),
    ("gemm_and_dense_conv", ("gemm", "nvjet", "cutlass", "cudnn", "xmma", "implicit_convolve")),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("reductions", ("reduce_kernel",)),
    ("copies_and_casts", ("Memcpy", "Memset", "copy", "CatArray")),
)


def device_profile(fn) -> dict:
    """Device activity of one call of ``fn`` under torch.profiler: busy and idle
    time between its first and last device event, the top kernels by time, and
    the time per category of ``PROFILE_CATEGORIES`` (the rest is "elementwise_and_other")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return {"device_events": 0, "idle_share": "not measured"}
    span_us = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name: dict = {}
    for e in events:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    categories: dict = {}
    for name, (total, _) in by_name.items():
        category = next((c for c, patterns in PROFILE_CATEGORIES if any(p in name for p in patterns)),
                        "elementwise_and_other")
        categories[category] = categories.get(category, 0.0) + total / 1e3
    return {
        "device_events": len(events),
        "span_ms": span_us / 1e3,
        "busy_ms": busy_us / 1e3,
        "idle_share": max(0.0, 1.0 - busy_us / span_us),
        "top": [{"name": n[:80], "ms": t / 1e3, "calls": c} for n, (t, c) in top],
        "categories_ms": dict(sorted(categories.items(), key=lambda kv: -kv[1])),
    }


def to_unit_scale(cotangent):
    """``cotangent`` times the power of two that brings its largest magnitude into [1, 2): exact in bf16.
    The cotangents of a mean CTC loss are about 1e-7, far below the floor of ``ulp_bf16_error``'s
    magnitude, where a gradient of zeros would pass; a backward is linear in its cotangent, so the
    scaled one exercises the same kernels on the same data."""
    top = cotangent.float().abs().max().item()
    return cotangent * 2.0 ** -np.floor(np.log2(top)) if top > 0 else cotangent


def bound(n_bytes: float, bf16_flop: float = 0.0, f32_flop: float = 0.0) -> dict:
    """The least time for the work: the largest of bytes / memory rate and operations / peak rate of
    their type (the tensor cores and the float32 pipes run at the same time, so their times do not add)."""
    by_bytes = n_bytes / HBM_BYTES_PER_MS
    by_ops = max(bf16_flop / BF16_FLOP_PER_MS, f32_flop / F32_FLOP_PER_MS)
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def log_mel_bound(batch: int, samples: int, n_fft=512, hop=160, win=320, n_mels=64) -> dict:
    """Audio in, log-mel out, and the FFT path's tables in (twiddles, window, the mel bands). The operations
    are those of an FFT-based STFT per frame: the window, a real FFT at 2.5 n_fft log2 n_fft, the power, the
    mel product over the filterbank's non-zeros, and the guarded log."""
    from thunder_tpu_torch.kernels.frontend import mel_bands

    n_freqs, frames = n_fft // 2 + 1, batch * (samples // hop + 1)
    bands, weights = mel_bands(n_fft, n_mels, SAMPLE_RATE)
    tables = 8 * n_fft + 4 * win + bands.nbytes + weights.nbytes
    n_bytes = 4 * (batch * samples + frames * n_mels) + tables
    per_frame = n_fft + 2.5 * n_fft * np.log2(n_fft) + 3 * n_freqs + 2 * weights.size + 2 * n_mels
    return bound(n_bytes, f32_flop=frames * per_frame)


def log_mel_library(n_fft=512, hop=160, win=320, n_mels=64, preemph=0.97):
    """The log-mel as a chain of PyTorch library calls, the yardstick for its kernel (timed here only; the
    port never calls it): preemphasis, ``torch.stft`` (cuFFT) with the centered reflect pad and the hann
    window, ``|.|^2``, ``torch.matmul`` with the filterbank and ``log(. + 2^-24)``. Returns ``fn(audio)``."""
    import torch

    from thunder_tpu_torch.ops.stft import hann_window, mel_filterbank

    window = torch.as_tensor(hann_window(win), device="cuda")
    fb = torch.as_tensor(mel_filterbank(n_fft // 2 + 1, n_mels, SAMPLE_RATE), device="cuda")

    def fn(audio):
        y = torch.cat([audio[:, :1], audio[:, 1:] - preemph * audio[:, :-1]], dim=1)
        spec = torch.stft(y, n_fft, hop_length=hop, win_length=win, window=window, center=True, pad_mode="reflect",
                          return_complex=True)
        power = torch.view_as_real(spec).square().sum(-1).transpose(1, 2)
        return torch.log(torch.matmul(power, fb) + 2.0**-24)

    return fn


def separable_bound(batch, t_in, t_out, c_in, c_out, k) -> dict:
    """bf16 input, taps and weights in, bf16 output out, f32 bias; depthwise in f32, pointwise on bf16 tensor cores."""
    n_bytes = 2 * (batch * t_in * c_in + k * c_in + c_in * c_out + batch * t_out * c_out) + 4 * c_out
    return {"bytes": n_bytes, "f32_flop": 2.0 * batch * t_out * c_in * k, "bf16_flop": 2.0 * batch * t_out * c_in * c_out}


def separable_chain(x, out_lengths, dw, pw, bias, kernel_size, stride=1, dilation=1, relu=True):
    """The separable repeat as a chain of PyTorch library calls in bf16, the yardstick for its kernel (timed
    here only; the port never calls it): ``F.conv1d(groups=C)`` + ``torch.matmul`` + bias, ReLU and the mask."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.ops.conv import get_same_padding

    pad = get_same_padding(kernel_size, stride, dilation)
    y = F.conv1d(x.transpose(1, 2), dw.t().unsqueeze(1), stride=stride, padding=pad, dilation=dilation,
                 groups=x.shape[-1])
    z = torch.matmul(y.transpose(1, 2), pw) + bias
    if relu:
        z = torch.relu(z)
    mask = torch.arange(z.shape[1], device=z.device)[None, :, None] < out_lengths[:, None, None]
    return torch.where(mask, z, 0.0).to(x.dtype)


def ctc_bound(t: int, b: int, s: int) -> dict:
    """Forward: lp in, alpha out; backward: lp and alpha in, dlp out (float32), plus the (B, S)
    skip mask and the (B,) lengths, log-likelihoods and cotangents. About 40 float32 operations
    per state and frame over both directions (3 + 4 exp, 2 log, the maxima and sums)."""
    plane = 4 * t * b * s
    return bound(5 * plane + 2 * b * s + 16 * b, f32_flop=40.0 * t * b * s)


def attention_bound(batch: int, t: int, heads: int) -> dict:
    """qkv in and the output out (bf16, plus the int32 lengths); q k^T and P V on the bf16 tensor cores."""
    h = heads * 64
    return bound(2 * batch * t * 4 * h + 4 * batch, bf16_flop=4.0 * batch * heads * t * t * 64)


def add_ln_bound(rows: int, d: int) -> dict:
    """x and y in, the output out (bf16), scale and bias in (float32); about 8 float32 operations a value."""
    return bound(3 * 2 * rows * d + 2 * 4 * d, f32_flop=8.0 * rows * d)


def attention_train_bounds(batch: int, t: int, heads: int) -> tuple[dict, dict]:
    """Forward: qkv in, the output out, two products. Backward: qkv, o and do in, dqkv out, five products
    (dP, dS K, dS^T q, Pd^T dO' and the scores), whatever the kernels recompute."""
    h = heads * 64
    pairs = batch * heads * float(t) * t * 64
    return (bound(2 * batch * t * 4 * h + 4 * batch, bf16_flop=4.0 * pairs),
            bound(2 * batch * t * 8 * h + 4 * batch, bf16_flop=10.0 * pairs))


def add_ln_train_bounds(rows: int, d: int) -> tuple[dict, dict]:
    """Forward: x and y in, the output out (3 bf16 passes). Backward: x, y and do in, dx and dy out (5 passes);
    the float32 parameters and their gradients; about 10 and 25 float32 operations a value."""
    return (bound(3 * 2 * rows * d + 2 * 4 * d, f32_flop=10.0 * rows * d),
            bound(5 * 2 * rows * d + 3 * 4 * d, f32_flop=25.0 * rows * d))


def sum_bounds(*bounds: dict) -> dict:
    """The bound of functions that run one after the other: their times add; bound by what binds the largest."""
    return {"bound_ms": sum(b["bound_ms"] for b in bounds), "bound_by": max(bounds, key=lambda b: b["bound_ms"])["bound_by"]}


def expected_counts(**launched: int) -> dict:
    """The launch count of every kernel wrapper: 0 but for those named."""
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS

    counts = {w.__name__: 0 for w in KERNEL_WRAPPERS}
    unknown = set(launched) - set(counts)
    check(not unknown, f"no kernel wrapper named {sorted(unknown)}")
    return {**counts, **launched}


def beam_scan_bound(batch: int, t: int, v: int, width: int) -> dict:
    """logp (B, T, V) float32 in (K = V: the candidates are logp itself), parents and exts (B, T, W)
    int32 out, the lengths and the five (B, W) state arrays in, six out. The float32 operations per
    row and frame: about 6 for each logaddexp (3 W of them) and 3 for each of the W*V extend rows."""
    n_bytes = 4 * batch * t * v + 8 * batch * t * width + 4 * batch * (1 + 11 * width)
    return bound(n_bytes, f32_flop=batch * t * (18.0 * width + 3.0 * width * v))


def beam_backtrace_bound(batch: int, t: int, n_out: int) -> dict:
    """What the walk needs: one parent and one ext read per path and frame, the start slot read, the
    token written per path and frame and the origin written."""
    return bound(4 * batch * n_out * (3 * t + 2))


@contextlib.contextmanager
def plain_beam():
    """Route the device beam search through the plain versions of both kernels, on the same device."""
    import thunder_tpu_torch.ops.ctc_beam_device as device_beam
    from thunder_tpu_torch.kernels.beam import beam_backtrace_reference, beam_scan_reference

    saved = device_beam.beam_scan, device_beam.beam_backtrace
    device_beam.beam_scan, device_beam.beam_backtrace = beam_scan_reference, beam_backtrace_reference
    try:
        yield
    finally:
        device_beam.beam_scan, device_beam.beam_backtrace = saved


@contextlib.contextmanager
def plain_wav2vec2():
    """Route wav2vec2's serving attention and add + LayerNorm through their plain versions, on the same device."""
    import thunder_tpu_torch.models.wav2vec2 as w2v
    from thunder_tpu_torch.kernels.add_ln import add_layer_norm_reference
    from thunder_tpu_torch.kernels.attention import mha_from_qkv_reference

    saved = w2v.mha_from_qkv, w2v.add_layer_norm
    w2v.mha_from_qkv, w2v.add_layer_norm = mha_from_qkv_reference, add_layer_norm_reference
    try:
        yield
    finally:
        w2v.mha_from_qkv, w2v.add_layer_norm = saved


def peaked_logits(rng, batch, t, v, blank, blank_frac=0.7, peak=6.0):
    """``scripts/bench_beam_device.py::peaked_logits``: normal logits, one token per frame raised by
    ``peak``, the blank on ``blank_frac`` of the frames."""
    logits = rng.normal(0, 1.0, (batch, t, v)).astype(np.float32)
    which = rng.random((batch, t)) < blank_frac
    idx = np.where(which, blank, rng.integers(0, v, (batch, t)))
    for b in range(batch):
        logits[b, np.arange(t), idx[b]] += peak
    return logits


def gpu_line() -> str:
    cmd = ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


class Failed(Exception):
    """A phase failed; the run prints why and exits 1."""


def check(ok: bool, message: str) -> None:
    if not ok:
        raise Failed(message)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device", file=sys.stderr)
        return 1
    try:
        return run()
    except Failed as failure:
        print(f"chip_smoke: {failure}", file=sys.stderr)
        return 1


def run() -> int:
    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import _build, reset_launch_counts
    from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_plan, log_mel_reference
    from thunder_tpu_torch.kernels.selftest import KERNEL_CHECKS, exact_float32, run_selftests, ulp_bf16_error
    from thunder_tpu_torch.ops.masking import lengths_to_mask, normalize_tensor
    from thunder_tpu_torch.kernels.separable_conv import (
        fused_separable_repeat,
        separable_plan,
        separable_repeat_reference,
    )
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    card = gpu_line()
    print(card, flush=True)
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    exact_float32()

    # ---- build
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": _build.library_path().name})

    # ---- kernel checks
    checks = run_selftests()
    for r in checks:
        emit({"kernel_check": r})
    bad = [r["name"] for r in checks if not r["ok"]]
    check(not bad, f"kernel checks failed: {bad}")

    # ---- main path: QuartzNet15x5 greedy serving at B=64 x 15 s
    tt = BatchTextTransformer(VOCAB)
    module = CTCModule.create(
        torch.Generator().manual_seed(0),
        FilterbankFeatures(),
        QuartznetEncoder(repeat_blocks=3),
        Conv1dDecoder(29),
        tt,
        device="cuda",
    )
    randomize_bn(module)
    engine = InferenceEngine(module)
    rng = np.random.default_rng(0)
    samples = int(SECONDS * SAMPLE_RATE)
    base = speech_like(samples, rng)
    audio = np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(BATCH)])
    lengths = np.full((BATCH,), samples, dtype=np.int32)
    engine.warmup([BATCH], [SECONDS])

    reset_launch_counts()
    texts = engine.predict(audio, lengths)
    launches = {"log_mel": fused_log_mel.launches, "separable_repeat": fused_separable_repeat.launches}
    emit({"phase": "launches_per_forward", **launches})
    check(launches == {"log_mel": 1, "separable_repeat": 77}, f"expected 1 log-mel and 77 separable launches, got {launches}")
    check(len(texts) == BATCH and all(isinstance(t, str) and set(t) <= set(VOCAB) for t in texts),
          f"transcripts outside the vocabulary: {texts[:4]}")

    audio_d = torch.as_tensor(audio, device="cuda")
    lengths_d = torch.as_tensor(lengths, device="cuda")
    logits, preds, out_lengths = engine.infer(audio_d, lengths_d)
    check(bool(torch.isfinite(logits).all()) and logits.shape == (BATCH, 751, len(VOCAB) + 1),
          f"logits not finite or of shape {tuple(logits.shape)}")

    iters = 10
    forward_ms = cuda_ms(lambda: engine.infer(audio_d, lengths_d), iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.predict(audio, lengths)
    predict_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "serving", "batch": BATCH, "seconds": SECONDS, "forward_ms": forward_ms,
          "rtf": BATCH * SECONDS / (forward_ms / 1e3), "predict_ms_host_clock": predict_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})
    emit({"phase": "profile", **device_profile(lambda: engine.infer(audio_d, lengths_d))})

    # rows 0-1 through the port's float32 CPU path (plain versions of both kernels)
    torch.set_num_threads(8)
    t0 = time.perf_counter()
    ref_logits, ref_lengths = InferenceEngine(module.to("cpu"))(audio[:2], lengths[:2])
    cpu_seconds = time.perf_counter() - t0
    check(torch.equal(ref_lengths, out_lengths[:2].cpu()), f"lengths differ from the CPU path: {ref_lengths} vs {out_lengths[:2]}")
    got = logits[:2].float().cpu()
    valid = torch.arange(got.shape[1])[None, :] < ref_lengths[:, None]
    rel = ((got - ref_logits).abs()[valid].max() / ref_logits.abs()[valid].max()).item()
    agree = (got.argmax(-1) == ref_logits.argmax(-1))[valid].float().mean().item()
    emit({"phase": "vs_cpu_f32", "rows": 2, "max_rel_dev": rel, "bound": LOGIT_BOUND, "argmax_agreement": agree,
          "cpu_seconds": cpu_seconds})
    check(rel < LOGIT_BOUND, f"bf16 card vs f32 CPU deviation {rel} >= {LOGIT_BOUND}")

    # ---- each kernel against its plain version at the main path's shapes
    kernels = []
    frontend = engine.frontend
    path = log_mel_plan(frontend.fft_size, frontend.n_window_stride, frontend.n_window_size, frontend.nfilt)["path"]
    check(path == "fft", f"the log-mel plan takes the {path} path at the main shape, not fft")
    library = log_mel_library()
    k_ms, p_ms = paired_ms(lambda: fused_log_mel(audio_d), lambda: log_mel_reference(audio_d), 20)
    _, lib_ms = paired_ms(lambda: fused_log_mel(audio_d), lambda: library(audio_d), 20)
    mel = fused_log_mel(audio_d)
    err = (mel - log_mel_reference(audio_d)).abs().max().item()
    lib_err = (library(audio_d) - log_mel_reference(audio_d)).abs().max().item()
    log_mel_tol = KERNEL_CHECKS["frontend_log_mel"][1]
    check(err <= log_mel_tol, f"log-mel at the main path's shape off by {err} > {log_mel_tol}")
    kernels.append({"name": "log_mel", "route": "cuda", "source": "thunder_tpu_torch/csrc/log_mel.cu",
                    "replaces": "thunder_tpu/kernels/frontend_pallas.py:105", "launches": launches["log_mel"],
                    "path": path, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **log_mel_bound(BATCH, samples),
                    "library_ms": lib_ms, "library_max_abs_err": lib_err,
                    "library": "a chain, not one call: preemphasis + torch.stft (cuFFT, reflect pad, window) + |.|^2 "
                               "+ torch.matmul with the filterbank + log"})
    # the frontend apart: the log-mel kernel, the masked per-feature normalize, the whole FilterbankFeatures call
    mask = lengths_to_mask(frontend.output_lengths(lengths_d), mel.shape[1])[:, :, None]
    norm_ms = cuda_ms(lambda: normalize_tensor(mel, mask, div_guard=frontend.div_guard, axis=1), 20)
    frontend_ms = cuda_ms(lambda: frontend(audio_d, lengths_d), 20)
    emit({"phase": "frontend_breakdown", "log_mel_ms": k_ms, "normalize_ms": norm_ms, "frontend_ms": frontend_ms,
          "forward_ms": forward_ms, "card": card})

    feats, feat_lengths = engine.frontend(audio_d, lengths_d)
    shapes = {}
    t_in, c_in = feats.shape[1], feats.shape[2]
    for block in engine._plan:
        for rp in block.repeats:
            if rp.kind == "separable":
                key = (t_in, c_in, rp.pw.shape[1], rp.kernel_size, rp.stride, rp.dilation)
                shapes.setdefault(key, [rp, 0])[1] += 1
            c_in = rp.pw.shape[1]
            t_in = -(-t_in // rp.stride)
    total_k = total_p = total_chain = max_err = max_ulp = 0.0
    work = {"bytes": 0.0, "f32_flop": 0.0, "bf16_flop": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (t, c, co, k, s, d), (rp, count) in shapes.items():
        x = torch.randn((BATCH, t, c), device="cuda", generator=gen).to(torch.bfloat16)
        t_out = -(-t // s)
        out_len = torch.full((BATCH,), t_out, dtype=torch.int32, device="cuda")
        args = (x, out_len, rp.dw, rp.pw, rp.bias, k)
        kw = dict(stride=s, dilation=d, relu=rp.relu)
        got, want = fused_separable_repeat(*args, **kw), separable_repeat_reference(*args, **kw)
        e_abs = (got.float() - want.float()).abs().max().item()
        e_ulp = ulp_bf16_error(got, want)
        km, pm = paired_ms(lambda: fused_separable_repeat(*args, **kw), lambda: separable_repeat_reference(*args, **kw), 10)
        _, chain_ms = paired_ms(lambda: fused_separable_repeat(*args, **kw), lambda: separable_chain(*args, **kw), 10)
        shape_work = separable_bound(BATCH, t, t_out, c, co, k)
        emit({"separable_shape": {"t_in": t, "c_in": c, "c_out": co, "k": k, "stride": s, "dilation": d,
                                  "count": count, "ms": km, "plain_ms": pm, "chain_ms": chain_ms,
                                  "max_abs_err": e_abs, "ulp": e_ulp, "plan": separable_plan(c, k, s, d),
                                  **bound(shape_work["bytes"], shape_work["bf16_flop"], shape_work["f32_flop"])}})
        total_k, total_p, total_chain = total_k + count * km, total_p + count * pm, total_chain + count * chain_ms
        max_err, max_ulp = max(max_err, e_abs), max(max_ulp, e_ulp)
        for key in work:
            work[key] += count * shape_work[key]
        check(e_ulp <= 8.0, f"separable repeat at {(t, c, co, k, s, d)} off by {e_ulp} bf16 ULP")
    kernels.append({"name": "separable_repeat", "route": "cuda", "source": "thunder_tpu_torch/csrc/separable_repeat.cu",
                    "replaces": "thunder_tpu/kernels/separable_conv.py:56",
                    "also_replaces": "thunder_tpu/kernels/repeat_tm.py:162",
                    "launches": launches["separable_repeat"], "max_abs_err": max_err, "max_ulp": max_ulp,
                    "ms": total_k, "plain_ms": total_p, "ms_is": "sum over the 77 launches of one forward",
                    **bound(work["bytes"], work["bf16_flop"], work["f32_flop"]), "library_ms": total_chain,
                    "library": "a chain, not one call: bf16 F.conv1d(groups=C) + torch.matmul + bias, ReLU, mask "
                               "(sum over the 77 launches)"})

    # ---- QuartzNet15x5 training, then the CTC kernel pair at its shape
    kernels.append(training_phase(card, KERNEL_CHECKS["ctc_recursion"][1]))

    # ---- wav2vec2-base serving, then its two kernels at the forward's shapes
    kernels.extend(wav2vec2_phase(card, KERNEL_CHECKS["attn_onepanel"][1], KERNEL_CHECKS["add_ln"][1]))

    # ---- beam serving on the phase-4 engine, then its two kernels at the forward's shapes
    kernels.extend(beam_phase(card, engine, audio, lengths, KERNEL_CHECKS["beam_device"][1]))
    del engine, module, logits

    # ---- wav2vec2-base training, then its kernels at the step's shapes
    kernels.extend(wav2vec2_training_phase(card))

    print(gpu_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def training_phase(card: str, ctc_tol: float) -> dict:
    """Train QuartzNet15x5 at TRAIN_BATCH x TRAIN_SECONDS on the card (phases 6 and 7 of the
    module docstring); returns the CTC kernel pair's entry of the kernels line."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.kernels.ctc import alpha_reference, beta_reference, ctc_alpha, ctc_beta, ll_from_alpha
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.ops.ctc import extended_emissions
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.optim import adamw
    from thunder_tpu_torch.training.trainer import Trainer, TrainStep, _encode_targets

    tt = BatchTextTransformer(VOCAB)
    bf16 = torch.bfloat16

    def create(device, dtype, train_config: bool) -> CTCModule:
        """The same weights (generator seed 0) in either configuration."""
        frontend = FilterbankFeatures(num_time_masks=2, num_freq_masks=2) if train_config else FilterbankFeatures(dither=0.0)
        encoder = QuartznetEncoder(repeat_blocks=3, dropout=0.1 if train_config else 0.0, dtype=dtype)
        return CTCModule.create(torch.Generator().manual_seed(0), frontend, encoder, Conv1dDecoder(29, dtype=dtype), tt,
                                device=device)

    samples = int(TRAIN_SECONDS * SAMPLE_RATE)
    audio = (np.random.default_rng(0).standard_normal((TRAIN_BATCH, samples)) * 0.1).astype(np.float32)
    lengths = np.full((TRAIN_BATCH,), samples, dtype=np.int32)
    texts = [TRAIN_TEXT] * TRAIN_BATCH
    targets, target_lengths = _encode_targets(tt, texts)
    check(targets.shape == (TRAIN_BATCH, 64), f"targets of shape {targets.shape}, expected ({TRAIN_BATCH}, 64)")

    # one step through the user's entry point: exactly one launch of each kernel of the path
    module = create("cuda", bf16, True)
    Trainer(seed=0, device="cuda").fit(module, [(audio, lengths, texts)])  # builds and warms up
    reset_launch_counts()
    trainer = Trainer(seed=0, log_every=1, device="cuda")
    trainer.fit(module, [(audio, lengths, texts)])
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    emit({"phase": "train_launches_per_step", **counts})
    check(counts == expected_counts(fused_log_mel=1, ctc_alpha=1, ctc_beta=1),
          f"one train step must launch 1 log-mel, 1 ctc_alpha and 1 ctc_beta, got {counts}")
    check(np.isfinite(trainer.logs[0]["loss/train_loss"]), f"Trainer.fit loss {trainer.logs[0]}")

    # warm-up and timed steps on one fixed batch, with one optimizer and one generator
    batch = (torch.as_tensor(audio, device="cuda"), torch.as_tensor(lengths, device="cuda"),
             torch.as_tensor(targets, device="cuda"), torch.as_tensor(target_lengths, device="cuda"))
    model = module.model
    step = TrainStep(model, adamw(model.parameters(), learning_rate=1e-4), module.blank_idx)
    generator = torch.Generator(device="cuda").manual_seed(0)
    losses = [step(*batch, generator) for _ in range(1 + TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN_TIMED):
        losses.append(step(*batch, generator))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
    step_ms = start.elapsed_time(end) / TRAIN_TIMED
    losses = [loss.item() for loss in losses]
    emit({"phase": "training", "batch": TRAIN_BATCH, "seconds": TRAIN_SECONDS, "step_ms": step_ms,
          "step_ms_host_clock": host_ms, "audio_s_per_s": TRAIN_BATCH * TRAIN_SECONDS / (step_ms / 1e3),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses, "card": card})
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] < (1 - LOSS_FALL) * losses[0],
          f"loss did not fall by {LOSS_FALL:.0%} over {len(losses)} steps: {losses[0]} -> {losses[-1]}")
    emit({"phase": "train_profile", **device_profile(lambda: step(*batch, generator))})

    # bf16 on the card against float32 on the CPU: one train-mode forward, dropout and augmentation off
    with torch.no_grad():
        card_loss, _ = create("cuda", bf16, False).loss(audio[:2], lengths[:2], targets[:2], target_lengths[:2],
                                                        train=True)
        t0 = time.perf_counter()
        cpu_loss, _ = create("cpu", torch.float32, False).loss(audio[:2], lengths[:2], targets[:2],
                                                               target_lengths[:2], train=True)
    rel = abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    emit({"phase": "train_vs_cpu_f32", "rows": 2, "card_loss": card_loss.item(), "cpu_loss": cpu_loss.item(),
          "rel_dev": rel, "bound": TRAIN_LOSS_BOUND, "cpu_seconds": time.perf_counter() - t0})
    check(rel < TRAIN_LOSS_BOUND, f"bf16 card loss vs f32 CPU loss off by {rel} >= {TRAIN_LOSS_BOUND}")

    # the CTC pair at the training shape: kernel, plain version and F.ctc_loss on the same inputs
    logits = torch.randn((TRAIN_BATCH, 751, len(VOCAB) + 1), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(2))
    log_probs = torch.log_softmax(logits, dim=-1)
    lens = torch.full((TRAIN_BATCH,), 751, dtype=torch.int32, device="cuda")
    lp_z, skip_ok = extended_emissions(log_probs, batch[2], blank=0)
    tl = batch[3]
    ghat = 1.0 / tl.float()

    def kernel_pair():
        alpha = ctc_alpha(lp_z, skip_ok, lens, tl)
        return alpha, ctc_beta(lp_z, alpha, skip_ok, lens, tl, ll_from_alpha(alpha, lens, tl), ghat)

    def plain_pair():
        alpha = alpha_reference(lp_z, skip_ok, lens, tl)
        return alpha, beta_reference(lp_z, alpha, skip_ok, lens, tl, ll_from_alpha(alpha, lens, tl), ghat)

    lp_t = log_probs.detach().transpose(0, 1).contiguous().requires_grad_(True)

    def library():
        loss = F.ctc_loss(lp_t, batch[2], lens, tl, blank=0, reduction="sum", zero_infinity=True)
        return torch.autograd.grad(loss, lp_t)

    (a_k, d_k), (a_p, d_p) = kernel_pair(), plain_pair()
    ll_k, ll_p = ll_from_alpha(a_k, lens, tl), ll_from_alpha(a_p, lens, tl)
    loss_delta = ((ll_k - ll_p) / tl).abs().sum().item()
    grad_rel = ((d_k - d_p).abs().max() / d_p.abs().max()).item()
    err = max((ll_k - ll_p).abs().max().item(), (d_k - d_p).abs().max().item())
    k_ms, p_ms = paired_ms(kernel_pair, plain_pair, 3)
    lib_ms = cuda_ms(library, 20)
    emit({"phase": "ctc_training_shape", "T": 751, "B": TRAIN_BATCH, "S": int(lp_z.shape[2]),
          "kernel_ms": k_ms, "alpha_ms": cuda_ms(lambda: ctc_alpha(lp_z, skip_ok, lens, tl), 20),
          "plain_ms": p_ms, "library_ms": lib_ms, "loss_delta": loss_delta, "grad_rel_delta": grad_rel})
    check(max(loss_delta, grad_rel) <= ctc_tol,
          f"CTC pair at the training shape off by {max(loss_delta, grad_rel)} > {ctc_tol}")
    return {"name": "ctc_recursion", "route": "cuda", "source": "thunder_tpu_torch/csrc/ctc_recursion.cu",
            "replaces": "thunder_tpu/kernels/ctc_pallas.py:264", "launches": counts["ctc_alpha"] + counts["ctc_beta"],
            "launches_is": "ctc_alpha + ctc_beta in one train step", "max_abs_err": err, "ms": k_ms,
            "ms_is": f"ctc_alpha + ctc_beta at T=751, B={TRAIN_BATCH}, S={lp_z.shape[2]}", "plain_ms": p_ms,
            **ctc_bound(751, TRAIN_BATCH, int(lp_z.shape[2])), "library_ms": lib_ms,
            "library": "F.ctc_loss forward + backward, reduction sum, zero_infinity"}


def wav2vec2_phase(card: str, attn_tol: float, add_ln_tol: float) -> list:
    """Serve wav2vec2-base at W2V_BATCH x W2V_SECONDS on the card (phase 8 of the module
    docstring); returns the attention and add + LayerNorm entries of the kernels line."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.kernels.add_ln import add_layer_norm, add_layer_norm_reference
    from thunder_tpu_torch.kernels.attention import mha_from_qkv, mha_from_qkv_reference
    from thunder_tpu_torch.kernels.selftest import ulp_bf16_error
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    tt = BatchTextTransformer(W2V_VOCAB)
    t0 = time.perf_counter()
    module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                              Wav2Vec2Encoder(Wav2Vec2Config()), LinearDecoder(tt.num_tokens), tt,
                              device="cuda")
    engine = InferenceEngine(module)
    create_s = time.perf_counter() - t0
    cfg = module.model.encoder.config
    rng = np.random.default_rng(1)
    samples = int(W2V_SECONDS * SAMPLE_RATE)
    base = speech_like(samples, rng)
    audio = np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(W2V_BATCH)])
    lengths = np.full((W2V_BATCH,), samples, dtype=np.int32)
    engine.warmup([W2V_BATCH], [W2V_SECONDS])

    reset_launch_counts()
    texts = engine.predict(audio, lengths)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    emit({"phase": "w2v2_launches_per_forward", **counts})
    layers = cfg.num_hidden_layers
    want = expected_counts(mha_from_qkv=layers, add_layer_norm=2 * layers + 1)
    check(counts == want, f"one wav2vec2 forward must launch {want}, got {counts}")
    check(len(texts) == W2V_BATCH and all(isinstance(t, str) and set(t) <= set(W2V_VOCAB) for t in texts),
          f"transcripts outside the vocabulary: {texts[:4]}")

    audio_d = torch.as_tensor(audio, device="cuda")
    lengths_d = torch.as_tensor(lengths, device="cuda")
    logits, preds, out_lengths = engine.infer(audio_d, lengths_d)
    frames = int(out_lengths[0])
    check(bool(torch.isfinite(logits).all()) and logits.shape == (W2V_BATCH, frames, tt.num_tokens),
          f"logits not finite or of shape {tuple(logits.shape)}")
    torch.cuda.reset_peak_memory_stats()
    forward_ms = cuda_ms(lambda: engine.infer(audio_d, lengths_d), 5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    engine.predict(audio, lengths)
    predict_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "w2v2_serving", "batch": W2V_BATCH, "seconds": W2V_SECONDS, "frames": frames,
          "forward_ms": forward_ms, "rtf": W2V_BATCH * W2V_SECONDS / (forward_ms / 1e3),
          "predict_ms_host_clock": predict_ms, "peak_mem_gb": peak_gb, "create_s": create_s, "card": card})
    emit({"phase": "w2v2_profile", **device_profile(lambda: engine.infer(audio_d, lengths_d))})

    # rows 0-1 through the port's float32 CPU path (plain versions, exact gelu, unfused attention)
    t0 = time.perf_counter()
    ref_logits, ref_lengths = InferenceEngine(module.to("cpu"))(audio[:2], lengths[:2])
    cpu_seconds = time.perf_counter() - t0
    check(torch.equal(ref_lengths, out_lengths[:2].cpu()), f"lengths differ from the CPU path: {ref_lengths}")
    got = logits[:2].float().cpu()
    valid = torch.arange(got.shape[1])[None, :] < ref_lengths[:, None]
    rel = ((got - ref_logits).abs()[valid].max() / ref_logits.abs()[valid].max()).item()
    agree = (got.argmax(-1) == ref_logits.argmax(-1))[valid].float().mean().item()
    emit({"phase": "w2v2_vs_cpu_f32", "rows": 2, "max_rel_dev": rel, "bound": LOGIT_BOUND, "argmax_agreement": agree,
          "cpu_seconds": cpu_seconds})
    check(rel < LOGIT_BOUND, f"wav2vec2 bf16 card vs f32 CPU deviation {rel} >= {LOGIT_BOUND}")

    # one 40 s clip through predict: T = 1999 frames, past the 1664 that the first attention kernel held
    clip = speech_like(LONG_CLIP_SECONDS * SAMPLE_RATE, np.random.default_rng(3))
    clip_args = (clip[None], np.array([clip.shape[0]], np.int32))
    clip_logits, _, clip_lengths = engine.infer(*clip_args)
    with plain_wav2vec2():
        plain_logits, _, _ = engine.infer(*clip_args)
    clip_rel = ((clip_logits - plain_logits).abs().max() / plain_logits.abs().max()).item()
    clip_agree = (clip_logits.argmax(-1) == plain_logits.argmax(-1)).float().mean().item()
    reset_launch_counts()
    t0 = time.perf_counter()
    clip_text = engine.predict(clip)[0]
    torch.cuda.synchronize()
    clip_ms = (time.perf_counter() - t0) * 1e3
    clip_counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    with plain_wav2vec2():
        clip_plain = engine.predict(clip)[0]
    emit({"phase": "w2v2_predict_40s", "seconds": LONG_CLIP_SECONDS, "frames": int(clip_lengths[0]),
          "launches": {k: v for k, v in clip_counts.items() if v}, "ms_host_clock": clip_ms, "chars": len(clip_text),
          "equal_to_plain": clip_text == clip_plain, "logits_max_rel_dev_vs_plain": clip_rel,
          "argmax_agreement_vs_plain": clip_agree})
    check(int(clip_lengths[0]) == 1999, f"a 40 s clip gave {int(clip_lengths[0])} frames, expected 1999")
    check(clip_counts == want, f"the 40 s predict must launch {want}, got {clip_counts}")
    check(clip_text == clip_plain and set(clip_text) <= set(W2V_VOCAB) and clip_rel < LOGIT_BOUND,
          f"the 40 s predict differs from the plain versions': text equal {clip_text == clip_plain}, logits {clip_rel}")

    # both kernels on the inputs the forward gives them: layer 0's packed qkv and its first add + LayerNorm
    captured = {}

    def keep(name, value) -> None:  # a forward hook that returns None leaves the output as it is
        captured[name] = value

    layer0 = engine._encoder.layer0
    hooks = [layer0.attention.qkv_proj.register_forward_hook(lambda m, args, out: keep("qkv", out)),
             layer0.layer_norm.register_forward_hook(lambda m, args, out: keep("add_ln", args))]
    engine.infer(audio_d, lengths_d)
    for hook in hooks:
        hook.remove()
    qkv, heads, h = captured["qkv"], cfg.num_attention_heads, cfg.hidden_size
    lens = out_lengths.to(torch.int32)
    mask = (torch.arange(frames, device="cuda")[None, :] < lens[:, None])[:, None, None, :]

    def attention_library():
        q, k, v = (a.reshape(W2V_BATCH, frames, heads, 64).transpose(1, 2) for a in qkv.split(h, dim=-1))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return out.transpose(1, 2).reshape(W2V_BATCH, frames, h)

    got, want = mha_from_qkv(qkv, lens, heads), mha_from_qkv_reference(qkv, lens, heads)
    a_err, a_ulp = (got.float() - want.float()).abs().max().item(), ulp_bf16_error(got, want)
    _, a_plain = paired_ms(lambda: mha_from_qkv(qkv, lens, heads), lambda: mha_from_qkv_reference(qkv, lens, heads), 10)
    a_spread = spread_ms({"kernel": lambda: mha_from_qkv(qkv, lens, heads), "library": attention_library}, 20)
    a_ms, a_lib = a_spread["kernel"]["median"], a_spread["library"]["median"]
    lib_ulp = ulp_bf16_error(attention_library(), want)
    emit({"phase": "w2v2_attention_shape", "B": W2V_BATCH, "T": frames, "heads": heads, "ms": a_ms, "plain_ms": a_plain,
          "library_ms": a_lib, "spread_ms": a_spread, "ulp": a_ulp, "library_ulp_vs_plain": lib_ulp})
    check(a_ulp <= attn_tol, f"attention at the forward's shape off by {a_ulp} bf16 ULP > {attn_tol}")

    x, y = (t.contiguous() for t in captured["add_ln"][:2])
    ln = layer0.layer_norm
    rows = x.numel() // h
    got, want = add_layer_norm(x, y, ln.scale, ln.bias), add_layer_norm_reference(x, y, ln.scale, ln.bias)
    n_err, n_ulp = (got.float() - want.float()).abs().max().item(), ulp_bf16_error(got, want)
    n_ms, n_plain = paired_ms(lambda: add_layer_norm(x, y, ln.scale, ln.bias),
                              lambda: add_layer_norm_reference(x, y, ln.scale, ln.bias), 50)
    n_lib = cuda_ms(lambda: F.layer_norm(x.float() + y.float(), (h,), ln.scale, ln.bias, ln.epsilon).to(x.dtype), 50)
    emit({"phase": "w2v2_add_ln_shape", "rows": rows, "D": h, "ms": n_ms, "plain_ms": n_plain, "library_ms": n_lib,
          "ulp": n_ulp})
    check(n_ulp <= add_ln_tol, f"add + LayerNorm at the forward's shape off by {n_ulp} bf16 ULP > {add_ln_tol}")
    return [
        {"name": "mha_from_qkv", "route": "cuda", "source": "thunder_tpu_torch/csrc/mha_from_qkv.cu",
         "replaces": "thunder_tpu/kernels/attn_onepanel.py:85", "launches": counts["mha_from_qkv"],
         "max_abs_err": a_err, "max_ulp": a_ulp, "ms": a_ms, "plain_ms": a_plain,
         "ms_is": f"one launch at B={W2V_BATCH}, T={frames}, {heads} heads of 64 (layer 0's qkv); median of "
                  f"{SPREAD_REPEATS} timings taken in turns with the library call's",
         "ms_min_max": [a_spread["kernel"]["min"], a_spread["kernel"]["max"]],
         **attention_bound(W2V_BATCH, frames, heads), "library_ms": a_lib,
         "library_ms_min_max": [a_spread["library"]["min"], a_spread["library"]["max"]],
         "library": "split into (B, heads, T, 64) + F.scaled_dot_product_attention with the key mask + merge"},
        {"name": "add_layer_norm", "route": "cuda", "source": "thunder_tpu_torch/csrc/add_ln.cu",
         "replaces": "thunder_tpu/kernels/add_ln.py:41", "launches": counts["add_layer_norm"],
         "max_abs_err": n_err, "max_ulp": n_ulp, "ms": n_ms, "plain_ms": n_plain,
         "ms_is": f"one launch at {rows} rows x {h} (layer 0's first add + LayerNorm)",
         **add_ln_bound(rows, h), "library_ms": n_lib, "library": "F.layer_norm(x.float() + y.float()).to(bf16)"},
    ]


def wav2vec2_training_phase(card: str) -> list:
    """Train wav2vec2-base at W2V_TRAIN_BATCH x W2V_SECONDS on the card (phases 10 and 11 of the module
    docstring); returns the entries of the training attention, the add + dropout + LayerNorm and the
    keep-mask kernels of the kernels line."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.kernels.add_ln_train import (
        add_ln_train_backward,
        add_ln_train_backward_reference,
        add_ln_train_forward,
        add_ln_train_forward_reference,
        dropout_keep_mask,
        dropout_keep_mask_reference,
    )
    from thunder_tpu_torch.kernels.attention_train import (
        mha_train_backward,
        mha_train_backward_reference,
        mha_train_forward,
        mha_train_forward_reference,
    )
    from thunder_tpu_torch.kernels.compare_builds import COLD_SETS, cold_ms, device_ms_by_kernel
    from thunder_tpu_torch.kernels.selftest import ulp_bf16_error
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.optim import adamw
    from thunder_tpu_torch.training.trainer import Trainer, TrainStep, _encode_targets

    tt = BatchTextTransformer(VOCAB)
    bf16 = torch.bfloat16
    rate = 0.1

    def create(device, dtype, dropout: float, freeze: bool = True) -> CTCModule:
        """The same weights (generator seed 0) whatever the device, dtype and dropout rates."""
        cfg = Wav2Vec2Config(hidden_dropout=dropout, attention_dropout=dropout, feat_proj_dropout=dropout)
        encoder = Wav2Vec2Encoder(cfg, dtype=dtype, freeze_feature_extractor=freeze)
        return CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=False), encoder,
                                LinearDecoder(tt.num_tokens, dtype=dtype), tt, device=device)

    b = W2V_TRAIN_BATCH
    samples = int(W2V_SECONDS * SAMPLE_RATE)
    audio = (np.random.default_rng(0).standard_normal((b, samples)) * 0.1).astype(np.float32)
    lengths = np.full((b,), samples, dtype=np.int32)
    texts = [TRAIN_TEXT] * b
    targets, target_lengths = _encode_targets(tt, texts)
    check(targets.shape == (b, 64), f"targets of shape {targets.shape}, expected ({b}, 64)")

    # ---- phase 10: one step through the user's entry point, with the launch counts of the path
    module = create("cuda", bf16, rate)
    cfg = module.model.encoder.config
    layers, heads, h = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.hidden_size
    Trainer(seed=0, device="cuda").fit(module, [(audio, lengths, texts)])  # warms up
    reset_launch_counts()
    trainer = Trainer(seed=0, log_every=1, device="cuda")
    trainer.fit(module, [(audio, lengths, texts)])
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    emit({"phase": "w2v2_train_launches_per_step", **counts})
    want = expected_counts(mha_train_forward=layers, mha_train_backward=2 * layers,
                           add_ln_train_forward=2 * layers + 1, add_ln_train_backward=2 * (2 * layers + 1),
                           ctc_alpha=1, ctc_beta=1)
    check(counts == want, f"one wav2vec2 train step must launch {want}, got {counts}")
    check(np.isfinite(trainer.logs[0]["loss/train_loss"]), f"Trainer.fit loss {trainer.logs[0]}")

    # warm-up and timed steps on one fixed batch, with one optimizer and one generator
    batch = (torch.as_tensor(audio, device="cuda"), torch.as_tensor(lengths, device="cuda"),
             torch.as_tensor(targets, device="cuda"), torch.as_tensor(target_lengths, device="cuda"))
    model = module.model
    step = TrainStep(model, adamw(model.parameters(), learning_rate=1e-4), module.blank_idx)
    generator = torch.Generator(device="cuda").manual_seed(0)
    conv0 = model.encoder.feature_extractor.conv0.kernel
    norm_before = conv0.detach().double().norm().item()
    losses = [step(*batch, generator) for _ in range(1 + W2V_TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(W2V_TRAIN_TIMED):
        losses.append(step(*batch, generator))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / W2V_TRAIN_TIMED
    step_ms = start.elapsed_time(end) / W2V_TRAIN_TIMED
    losses = [loss.item() for loss in losses]
    frames = 749
    emit({"phase": "w2v2_training", "batch": b, "seconds": W2V_SECONDS, "frames": frames, "step_ms": step_ms,
          "step_ms_host_clock": host_ms, "audio_s_per_s": b * W2V_SECONDS / (step_ms / 1e3),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses, "card": card})
    check(all(np.isfinite(losses)), f"non-finite wav2vec2 training loss: {losses}")
    check(losses[-1] < (1 - W2V_LOSS_FALL) * losses[0],
          f"wav2vec2 loss did not fall by {W2V_LOSS_FALL:.0%} over {len(losses)} steps: {losses[0]} -> {losses[-1]}")
    # the frozen extractor has no gradient, and AdamW's weight decay still shrinks it by lr * wd a step
    shrink = conv0.detach().double().norm().item() / norm_before
    want_shrink = (1 - 1e-4 * 1e-2) ** len(losses)
    check(abs(shrink - want_shrink) < 1e-6, f"the frozen extractor's conv0 shrank by {shrink}, expected {want_shrink}")
    profile = device_profile(lambda: step(*batch, generator))
    emit({"phase": "w2v2_train_profile", **profile})

    # bf16 on the card against float32 on the CPU: one train-mode forward with every dropout rate 0
    with torch.no_grad():
        card_loss, _ = create("cuda", bf16, 0.0).loss(audio[:2], lengths[:2], targets[:2], target_lengths[:2], train=True)
        t0 = time.perf_counter()
        cpu_loss, _ = create("cpu", torch.float32, 0.0).loss(audio[:2], lengths[:2], targets[:2], target_lengths[:2],
                                                             train=True)
    rel = abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    emit({"phase": "w2v2_train_vs_cpu_f32", "rows": 2, "card_loss": card_loss.item(), "cpu_loss": cpu_loss.item(),
          "rel_dev": rel, "bound": W2V_TRAIN_LOSS_BOUND, "cpu_seconds": time.perf_counter() - t0})
    check(rel < W2V_TRAIN_LOSS_BOUND, f"wav2vec2 bf16 card loss vs f32 CPU loss off by {rel} >= {W2V_TRAIN_LOSS_BOUND}")

    # ---- the shapes of the step: layer 0's packed qkv, its attention output's cotangent, its first
    # add + LayerNorm's inputs and cotangent
    captured = {}

    def grad_of(name, tensor) -> None:
        tensor.register_hook(lambda g: captured.__setitem__(name, g.detach()))

    def on_out_proj(mod, args) -> None:
        grad_of("attn_dout", args[0])

    def on_qkv(mod, args, out) -> None:
        captured["qkv"] = out.detach()

    def on_add_ln(mod, args, out) -> None:
        captured["add_ln"] = tuple(a.detach().contiguous() for a in args[:2])
        grad_of("add_ln_dout", out)

    layer0 = model.encoder.layer0
    hooks = [layer0.attention.qkv_proj.register_forward_hook(on_qkv),
             layer0.attention.out_proj.register_forward_pre_hook(on_out_proj),
             layer0.layer_norm.register_forward_hook(on_add_ln)]
    step(*batch, generator)
    for hook in hooks:
        hook.remove()
    torch.cuda.synchronize()

    # ---- the extractor trained too, two steps at 2 rows
    unfrozen = create("cuda", bf16, rate, freeze=False)
    small = tuple(a[:2] for a in batch)
    probe = TrainStep(unfrozen.model, adamw(unfrozen.model.parameters(), learning_rate=1e-4), unfrozen.blank_idx,
                      accumulate_grad_batches=3)  # no optimizer step: the gradients stay to be read
    t0 = time.perf_counter()
    unfrozen_losses = [probe(*small, generator).item() for _ in range(2)]
    torch.cuda.synchronize()
    no_grad = [n for n, p in unfrozen.model.encoder.feature_extractor.named_parameters()
               if p.grad is None or not bool(p.grad.abs().sum() > 0)]
    emit({"phase": "w2v2_training_no_freeze", "batch": 2, "losses": unfrozen_losses,
          "step_ms_host_clock": (time.perf_counter() - t0) * 1e3 / 2, "extractor_parameters_without_gradient": no_grad})
    check(all(np.isfinite(unfrozen_losses)) and not no_grad,
          f"unfrozen wav2vec2 training: losses {unfrozen_losses}, extractor parameters without a gradient {no_grad}")
    del unfrozen, probe

    # ---- phase 11: the attention kernels at the step's shape
    qkv, raw_dout = captured["qkv"].contiguous(), captured["attn_dout"].contiguous()
    dout = to_unit_scale(raw_dout)
    check(qkv.shape == (b, frames, 3 * h) and dout.shape == (b, frames, h), f"captured qkv {tuple(qkv.shape)}")
    lens = torch.full((b,), frames, dtype=torch.int32, device="cuda")
    seed = torch.tensor([20260821], dtype=torch.int32, device="cuda")
    out, stats = mha_train_forward(qkv, lens, seed, heads, rate)
    dqkv = mha_train_backward(qkv, out, stats, dout, lens, seed, heads, rate)
    out_p, _ = mha_train_forward_reference(qkv, lens, seed, heads, rate)
    dqkv_p = mha_train_backward_reference(qkv, out, stats, dout, lens, seed, heads, rate)
    # dq, dk and dv each at their own magnitude; zeros in place of a gradient must fail the same comparison
    parts = dict(zip(("dq", "dk", "dv"), zip(dqkv.split(h, dim=-1), dqkv_p.split(h, dim=-1))))
    a_ulp = {"fwd": ulp_bf16_error(out, out_p), **{n: ulp_bf16_error(g, w) for n, (g, w) in parts.items()}}
    a_max = {"fwd": out_p.float().abs().max().item(), **{n: w.float().abs().max().item() for n, (_, w) in parts.items()}}
    a_zero_ulp = {n: ulp_bf16_error(torch.zeros_like(w), w) for n, (_, w) in parts.items()}
    check(min(a_zero_ulp.values()) > TRAIN_KERNEL_ULP,
          f"zeros in place of dq, dk or dv would pass the comparison: {a_zero_ulp} bf16 ULP, max|want| {a_max}")
    a_err = max((out.float() - out_p.float()).abs().max().item(), (dqkv.float() - dqkv_p.float()).abs().max().item())
    _, af_plain = paired_ms(lambda: mha_train_forward(qkv, lens, seed, heads, rate),
                            lambda: mha_train_forward_reference(qkv, lens, seed, heads, rate), 5)
    _, ab_plain = paired_ms(lambda: mha_train_backward(qkv, out, stats, dout, lens, seed, heads, rate),
                            lambda: mha_train_backward_reference(qkv, out, stats, dout, lens, seed, heads, rate), 5)
    del out_p, dqkv_p, parts
    mask = (torch.arange(frames, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    leaf = qkv.clone().requires_grad_(True)

    def attention_library(backward: bool):
        q, k, v = (a.reshape(b, frames, heads, 64).transpose(1, 2) for a in leaf.split(h, dim=-1))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=rate).transpose(1, 2).reshape(b, frames, h)
        return torch.autograd.grad(o, leaf, dout) if backward else o

    def library_forward():
        with torch.no_grad():
            return attention_library(False)

    lib_out = attention_library(False)  # with its graph: the library's backward alone, on the same cotangent

    def library_backward():
        return torch.autograd.grad(lib_out, leaf, dout, retain_graph=True)

    # which SDPA backend ran (with a key mask, not flash attention): the backward's kernels by device time
    lib_bwd_kernels = device_ms_by_kernel(library_backward, 5)
    out0, stats0 = mha_train_forward(qkv, lens, seed, heads, 0.0)
    a_spread = spread_ms({"fwd": lambda: mha_train_forward(qkv, lens, seed, heads, rate),
                          "bwd": lambda: mha_train_backward(qkv, out, stats, dout, lens, seed, heads, rate),
                          "bwd_rate0": lambda: mha_train_backward(qkv, out0, stats0, dout, lens, seed, heads, 0.0),
                          "library_fwd": library_forward, "library_bwd": library_backward,
                          "library_fwd_bwd": lambda: attention_library(True)}, 10)
    af_ms, ab_ms, ab0_ms = a_spread["fwd"]["median"], a_spread["bwd"]["median"], a_spread["bwd_rate0"]["median"]
    alib_f, alib_b = a_spread["library_fwd"]["median"], a_spread["library_bwd"]["median"]
    alib = a_spread["library_fwd_bwd"]["median"]
    emit({"phase": "w2v2_train_attention_shape", "B": b, "T": frames, "heads": heads, "rate": rate, "fwd_ms": af_ms,
          "bwd_ms": ab_ms, "bwd_rate0_ms": ab0_ms, "plain_fwd_ms": af_plain, "plain_bwd_ms": ab_plain,
          "library_fwd_ms": alib_f, "library_bwd_ms": alib_b, "library_fwd_bwd_ms": alib,
          "library_bwd_kernels": lib_bwd_kernels, "spread_ms": a_spread, "ulp": a_ulp, "max_abs_want": a_max,
          "ulp_of_zeros": a_zero_ulp,
          "max_abs_cotangent": dout.float().abs().max().item(),
          "max_abs_cotangent_of_the_step": raw_dout.float().abs().max().item()})
    check(max(a_ulp.values()) <= TRAIN_KERNEL_ULP,
          f"training attention at the step's shape off by {a_ulp} bf16 ULP > {TRAIN_KERNEL_ULP}")

    # ---- the add + dropout + LayerNorm kernels at the step's shape
    (x, y), raw_n_dout = captured["add_ln"], captured["add_ln_dout"].contiguous()
    n_dout = to_unit_scale(raw_n_dout)
    ln = layer0.layer_norm
    scale, bias = ln.scale.detach(), ln.bias.detach()
    rows = x.numel() // h
    got = (add_ln_train_forward(x, y, scale, bias, seed, rate), *add_ln_train_backward(x, y, scale, seed, n_dout, rate))
    plain = (add_ln_train_forward_reference(x, y, scale, bias, seed, rate),
             *add_ln_train_backward_reference(x, y, scale, seed, n_dout, rate))
    n_ulp = {name: ulp_bf16_error(got[i], plain[i]) for i, name in enumerate(("fwd", "dx", "dy"))}
    n_rel = {name: ((got[i] - plain[i]).abs().max() / plain[i].abs().max().clamp_min(1e-9)).item()
             for i, name in ((3, "dscale"), (4, "dbias"))}
    n_err = max((g.float() - p.float()).abs().max().item() for g, p in zip(got[:3], plain[:3]))
    n_max = {name: plain[i].float().abs().max().item() for i, name in enumerate(("fwd", "dx", "dy", "dscale", "dbias"))}
    n_zero_ulp = {name: ulp_bf16_error(torch.zeros_like(plain[i]), plain[i]) for i, name in ((1, "dx"), (2, "dy"))}
    check(min(n_zero_ulp.values()) > TRAIN_KERNEL_ULP and min(n_max["dscale"], n_max["dbias"]) > 1e-3,
          f"zeros in place of a gradient would pass the comparison: {n_zero_ulp} bf16 ULP, max|want| {n_max}")
    nf_ms, nf_plain = paired_ms(lambda: add_ln_train_forward(x, y, scale, bias, seed, rate),
                                lambda: add_ln_train_forward_reference(x, y, scale, bias, seed, rate), 20)
    nb_ms, nb_plain = paired_ms(lambda: add_ln_train_backward(x, y, scale, seed, n_dout, rate),
                                lambda: add_ln_train_backward_reference(x, y, scale, seed, n_dout, rate), 20)
    leaves = [a.clone().requires_grad_(True) for a in (x, y, scale, bias)]

    def add_ln_library(backward: bool):
        xl, yl, sl, bl = leaves
        o = F.layer_norm(xl.float() + F.dropout(yl, rate, training=True).float(), (h,), sl, bl, ln.epsilon).to(xl.dtype)
        return torch.autograd.grad(o, leaves, n_dout) if backward else o

    with torch.no_grad():
        nlib_f = cuda_ms(lambda: add_ln_library(False), 20)
    nlib = cuda_ms(lambda: add_ln_library(True), 20)
    # the device's busy time a call, beside the back-to-back calls' time above (which the host may set)
    n_busy = {name: sum(device_ms_by_kernel(fn, 10).values()) for name, fn in (
        ("fwd", lambda: add_ln_train_forward(x, y, scale, bias, seed, rate)),
        ("bwd", lambda: add_ln_train_backward(x, y, scale, seed, n_dout, rate)))}
    # the device time a call with the inputs in device memory, as a step finds them: the step's inputs and
    # COLD_SETS - 1 more sets of their shape, in turns, the card held until the host has queued every call
    gen = torch.Generator(device="cuda").manual_seed(3)
    sets = [(x, y, n_dout)] + [tuple((torch.randn(x.shape, device="cuda", generator=gen) * sd).to(bf16)
                                     for sd in (2.0, 1.0, 1.0)) for _ in range(COLD_SETS - 1)]
    n_cold = {"fwd": cold_ms([lambda a=a: add_ln_train_forward(a[0], a[1], scale, bias, seed, rate) for a in sets]),
              "bwd": cold_ms([lambda a=a: add_ln_train_backward(a[0], a[1], scale, seed, a[2], rate) for a in sets])}
    del sets
    emit({"phase": "w2v2_train_add_ln_shape", "rows": rows, "D": h, "rate": rate,
          "fwd_cold_ms": n_cold["fwd"]["ms"], "bwd_cold_ms": n_cold["bwd"]["ms"],
          "fwd_ms_host_paced": nf_ms, "bwd_ms_host_paced": nb_ms,
          "fwd_busy_ms": n_busy["fwd"], "bwd_busy_ms": n_busy["bwd"], "cold": n_cold,
          "plain_fwd_ms": nf_plain, "plain_bwd_ms": nb_plain, "library_fwd_ms": nlib_f, "library_fwd_bwd_ms": nlib,
          "ulp": n_ulp, "rel": n_rel, "max_abs_want": n_max, "ulp_of_zeros": n_zero_ulp,
          "max_abs_cotangent": n_dout.float().abs().max().item(),
          "max_abs_cotangent_of_the_step": raw_n_dout.float().abs().max().item(), "card": card})
    check(max(n_ulp.values()) <= TRAIN_KERNEL_ULP and max(n_rel.values()) <= 0.01,
          f"add + dropout + LayerNorm at the step's shape off by {n_ulp} bf16 ULP, {n_rel} relative")

    # ---- the keep mask at that shape: a check's helper, never launched by the step
    reset_launch_counts()
    keep = dropout_keep_mask(x.shape, seed, rate)
    mask_launches = dropout_keep_mask.launches
    keep_p = dropout_keep_mask_reference(x.shape, seed, rate)
    kept = keep.mean().item()
    m_ms, m_plain = paired_ms(lambda: dropout_keep_mask(x.shape, seed, rate),
                              lambda: dropout_keep_mask_reference(x.shape, seed, rate), 20)
    m_lib = cuda_ms(lambda: (torch.rand(x.shape, device="cuda") >= rate).float(), 20)
    emit({"phase": "w2v2_train_keep_mask_shape", "rows": rows, "D": h, "rate": rate, "kept": kept, "ms": m_ms,
          "plain_ms": m_plain, "library_ms": m_lib, "equal_to_plain": torch.equal(keep, keep_p)})
    check(torch.equal(keep, keep_p) and mask_launches == 1
          and abs(kept - (1 - rate)) < 5 * (rate * (1 - rate) / keep.numel()) ** 0.5,
          f"dropout_keep_mask at the step's shape: equal to plain {torch.equal(keep, keep_p)}, kept {kept}")

    categories = profile.get("categories_ms", {})
    new_ms = categories.get("attention_train", 0.0) + categories.get("add_layer_norm_train", 0.0)
    share = new_ms / profile["busy_ms"] if "busy_ms" in profile else None
    emit({"phase": "w2v2_train_kernel_share", "attention_train_ms": categories.get("attention_train"),
          "add_layer_norm_train_ms": categories.get("add_layer_norm_train"), "share_of_busy": share})
    a_fwd_bound, a_bwd_bound = attention_train_bounds(b, frames, heads)
    n_fwd_bound, n_bwd_bound = add_ln_train_bounds(rows, h)
    pallas = "thunder_tpu/kernels/add_ln_train.py"
    return [
        {"name": "mha_train", "route": "cuda", "source": "thunder_tpu_torch/csrc/mha_train.cu",
         "replaces": "thunder_tpu/kernels/attn_train.py:394",
         "launches": counts["mha_train_forward"] + counts["mha_train_backward"],
         "launches_is": f"{layers} forward + {2 * layers} backward (dq, then dk/dv) in one train step",
         "max_abs_err": a_err, "max_ulp": max(a_ulp.values()), "ms": af_ms + ab_ms, "fwd_ms": af_ms, "bwd_ms": ab_ms,
         "plain_ms": af_plain + ab_plain, "plain_fwd_ms": af_plain, "plain_bwd_ms": ab_plain,
         "ms_is": f"forward + backward at B={b}, T={frames}, {heads} heads of 64, rate {rate} (layer 0's qkv and "
                  f"cotangent); medians of {SPREAD_REPEATS} timings taken in turns with the library call's",
         "fwd_ms_min_max": [a_spread["fwd"]["min"], a_spread["fwd"]["max"]],
         "bwd_ms_min_max": [a_spread["bwd"]["min"], a_spread["bwd"]["max"]], "bwd_rate0_ms": ab0_ms,
         **sum_bounds(a_fwd_bound, a_bwd_bound), "bound_fwd_ms": a_fwd_bound["bound_ms"],
         "bound_bwd_ms": a_bwd_bound["bound_ms"], "library_ms": alib, "library_fwd_ms": alib_f,
         "library_bwd_ms": alib_b, "library_bwd_ms_min_max": [a_spread["library_bwd"]["min"],
                                                                a_spread["library_bwd"]["max"]],
         "library_bwd_kernels": lib_bwd_kernels,
         "library_ms_min_max": [a_spread["library_fwd_bwd"]["min"], a_spread["library_fwd_bwd"]["max"]],
         "library_fwd_ms_min_max": [a_spread["library_fwd"]["min"], a_spread["library_fwd"]["max"]],
         "library": "split into (B, heads, T, 64) + F.scaled_dot_product_attention with the key mask and dropout_p, "
                    "forward + backward; library_bwd_ms its backward alone (autograd.grad on a retained graph, the "
                    "same cotangent), run by library_bwd_kernels"},
        {"name": "add_ln_dropout_train", "route": "cuda", "source": "thunder_tpu_torch/csrc/add_ln_train.cu",
         "replaces": f"{pallas}:178",
         "launches": counts["add_ln_train_forward"] + counts["add_ln_train_backward"],
         "launches_is": f"{2 * layers + 1} forward + {2 * (2 * layers + 1)} backward (the backward, then the sum of "
                        "its partial dscale/dbias rows) in one train step",
         "max_abs_err": n_err, "max_ulp": max(n_ulp.values()), "max_rel_dscale_dbias": max(n_rel.values()),
         "ms": n_cold["fwd"]["ms"] + n_cold["bwd"]["ms"], "fwd_ms": n_cold["fwd"]["ms"], "bwd_ms": n_cold["bwd"]["ms"],
         "host_paced_ms": nf_ms + nb_ms, "host_paced_fwd_ms": nf_ms, "host_paced_bwd_ms": nb_ms,
         "plain_ms": nf_plain + nb_plain, "plain_fwd_ms": nf_plain, "plain_bwd_ms": nb_plain,
         "ms_is": f"forward + backward (with its partial sum) at {rows} rows x {h}, rate {rate} (layer 0's first add "
                  f"+ LayerNorm), device time a call with the inputs in device memory (L2-cold: {COLD_SETS} input sets "
                  "in turns); host_paced_*: back-to-back calls at the host's pace",
         **sum_bounds(n_fwd_bound, n_bwd_bound), "bound_fwd_ms": n_fwd_bound["bound_ms"],
         "bound_bwd_ms": n_bwd_bound["bound_ms"], "library_ms": nlib, "library_fwd_ms": nlib_f,
         "library": "F.layer_norm(x.float() + F.dropout(y).float()).to(bf16), forward + backward"},
        {"name": "dropout_keep_mask", "route": "cuda", "source": "thunder_tpu_torch/csrc/add_ln_train.cu",
         "replaces": f"{pallas}:215", "launches": counts["dropout_keep_mask"], "own_call_launches": mask_launches,
         "launches_is": "a check's helper, which no train step launches; own_call_launches is of one call at the "
                        "step's add + LayerNorm shape",
         "max_abs_err": (keep - keep_p).abs().max().item(), "ms": m_ms, "plain_ms": m_plain,
         "ms_is": f"one launch at {rows} rows x {h}, rate {rate}", **bound(4 * rows * h, f32_flop=12.0 * rows * h),
         "library_ms": m_lib, "library": "(torch.rand(shape) >= rate).float(): other bits, the same distribution"},
    ]


def beam_phase(card: str, engine, audio: np.ndarray, lengths: np.ndarray, total_tol: float) -> list:
    """Beam serving on the phase-4 engine (phase 9 of the module docstring); returns the scan's and
    the backtrace's entries of the kernels line."""
    import torch

    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.kernels.beam import (
        beam_backtrace,
        beam_backtrace_reference,
        beam_scan,
        beam_scan_reference,
        scan_plan,
    )
    from thunder_tpu_torch.kernels.selftest import beam_case
    from thunder_tpu_torch.ops.ctc_beam import beam_search_decode
    from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device

    width = 16
    tt = engine.module.text_transform
    blank = engine.module.blank_idx
    beam = dict(beam_width=width, beam_backend="device")
    engine.predict(audio, lengths, **beam)  # builds nothing new; warms the beam path

    reset_launch_counts()
    texts = engine.predict(audio, lengths, **beam)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    emit({"phase": "beam_launches_per_predict", **counts})
    want = expected_counts(fused_log_mel=1, fused_separable_repeat=77, beam_scan=1, beam_backtrace=1)
    check(counts == want, f"one beam predict must launch {want}, got {counts}")
    check(len(texts) == BATCH and all(isinstance(t, str) and set(t) <= set(VOCAB) for t in texts),
          f"beam transcripts outside the vocabulary: {texts[:4]}")
    with plain_beam():
        plain_texts = engine.predict(audio, lengths, **beam)
    agree = sum(a == b for a, b in zip(texts, plain_texts))
    emit({"phase": "beam_vs_plain", "rows": BATCH, "equal_rows": agree})
    check(agree == BATCH, f"beam transcripts differ from the plain versions' on {BATCH - agree} of {BATCH} rows")

    # host clock of the whole predict, greedy and beam
    timings = {}
    for name, kw in (("greedy", {}), ("beam", beam)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict(audio, lengths, **kw)
        timings[f"predict_{name}_ms_host_clock"] = (time.perf_counter() - t0) * 1e3

    # the decode alone, on the forward's own logits
    audio_d, lengths_d = torch.as_tensor(audio, device="cuda"), torch.as_tensor(lengths, device="cuda")
    logits, _, out_lengths = engine.infer(audio_d, lengths_d)
    batch, frames, vocab = logits.shape
    decode = lambda: beam_search_device(logits, out_lengths, blank=blank, beam_width=width)  # noqa: E731
    decode_ms = cuda_ms(decode, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    decode_host_ms = (time.perf_counter() - t0) * 1e3
    with plain_beam():
        decode_plain_ms = cuda_ms(decode, 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    kw = dict(blank=blank, beam_width=width, k_tokens=50)
    scan = lambda: beam_scan(logp, out_lengths, -12.0, **kw)  # noqa: E731
    scan_plain = lambda: beam_scan_reference(logp, out_lengths, -12.0, **kw)  # noqa: E731
    (p1, e1, t1, s1), (p0, e0, t0_, s0) = scan(), scan_plain()
    slots0 = torch.argsort(-t1, dim=1, stable=True)[:, :1].to(torch.int32)
    walk = lambda: beam_backtrace(p1, e1, slots0)  # noqa: E731
    walk_plain = lambda: beam_backtrace_reference(p1, e1, slots0)  # noqa: E731
    (k1, o1), (k0, o0) = walk(), walk_plain()
    finite = torch.isfinite(t0_)
    scan_err = (t1[finite] - t0_[finite]).abs().max().item()
    exact = (torch.equal(p1, p0) and torch.equal(e1, e0) and torch.equal(finite, torch.isfinite(t1))
             and all(torch.equal(a, b) for a, b in zip(s1[2:], s0[2:])) and torch.equal(k1, k0) and torch.equal(o1, o0))
    check(exact and scan_err <= total_tol,
          f"beam kernels at the forward's logits differ from the plain versions (exact {exact}, total {scan_err})")
    p_a, k_a = cuda_ms(scan_plain, 1), cuda_ms(scan, 10)
    k_b, p_b = cuda_ms(scan, 10), cuda_ms(scan_plain, 1)
    scan_ms, scan_plain_ms = (k_a + k_b) / 2, (p_a + p_b) / 2
    walk_ms, walk_plain_ms = paired_ms(walk, walk_plain, 10)
    emit({"phase": "beam_decode", "B": batch, "T": frames, "V": vocab, "W": width, "decode_ms": decode_ms,
          "decode_ms_host_clock": decode_host_ms, "decode_plain_ms": decode_plain_ms, "scan_ms": scan_ms,
          "scan_plain_ms": scan_plain_ms, "backtrace_ms": walk_ms, "backtrace_plain_ms": walk_plain_ms,
          "forward_ms": cuda_ms(lambda: engine.infer(audio_d, lengths_d), 5), **timings, "card": card})
    emit({"phase": "beam_profile", **device_profile(lambda: engine.predict(audio, lengths, **beam))})

    # against the numpy host search: exact on peaked logits, the share that agrees on the served ones
    peaked = peaked_logits(np.random.default_rng(0), BATCH, frames, vocab, blank)
    t0 = time.perf_counter()
    host = beam_search_decode(peaked[:2], blank=blank, beam_width=width, max_tokens_per_step=None)
    host_s = time.perf_counter() - t0
    card_rows = beam_search_device(torch.as_tensor(peaked, device="cuda"), blank=blank, beam_width=width,
                                   max_tokens_per_step=None)[:2]
    peaked_equal = [h.tolist() == d.tolist() for h, d in zip(host, card_rows)]
    served = logits[:2].float().cpu().numpy()
    served_host = beam_search_decode(served, out_lengths[:2].cpu().numpy(), blank=blank, beam_width=width)
    served_card = beam_search_device(logits[:2], out_lengths[:2], blank=blank, beam_width=width)
    served_share = sum(h.tolist() == d.tolist() for h, d in zip(served_host, served_card)) / 2
    emit({"phase": "beam_vs_host", "peaked_rows_equal": peaked_equal, "served_rows_agree_share": served_share,
          "host_seconds_two_rows": host_s})
    check(all(peaked_equal), f"device beam differs from the host search on peaked rows 0-1: {peaked_equal}")

    # long audio: one launch of each beam kernel per window, the same text as the plain versions
    clip = speech_like(60 * SAMPLE_RATE, np.random.default_rng(2))
    chunk, overlap = 20 * SAMPLE_RATE, 2 * SAMPLE_RATE
    windows = len(range(0, max(clip.shape[0] - overlap, 1), chunk - overlap))
    reset_launch_counts()
    t0 = time.perf_counter()
    long_text = engine.predict_long(clip, beam_width=width, beam_backend="device")
    long_ms = (time.perf_counter() - t0) * 1e3
    long_counts = (beam_scan.launches, beam_backtrace.launches)
    with plain_beam():
        long_plain = engine.predict_long(clip, beam_width=width, beam_backend="device")
    # the scan of one window alone (B = 1), on the first window's own logits
    first = torch.as_tensor(clip[None, :chunk], device="cuda")
    w_logits, _, w_lengths = engine.infer(first, torch.full((1,), chunk, dtype=torch.int32, device="cuda"))
    w_logp = torch.log_softmax(w_logits.float(), dim=-1)
    window_scan_ms = cuda_ms(lambda: beam_scan(w_logp, w_lengths, -12.0, **kw), 10)
    emit({"phase": "beam_predict_long", "seconds": 60, "windows": windows, "beam_launches": long_counts,
          "ms_host_clock": long_ms, "chars": len(long_text), "equal_to_plain": long_text == long_plain,
          "scan_ms_per_window": window_scan_ms, "window_frames": w_logits.shape[1], "card": card})
    check(long_counts == (windows, windows), f"predict_long over {windows} windows launched {long_counts}")
    check(long_text == long_plain and set(long_text) <= set(VOCAB), "predict_long's text differs from the plain versions'")

    # past one block of shared memory: every token a step at V = 3000 (the chunked scan), against the plain version
    c_logits, _ = beam_case(3, 16, 188, 3000, "cuda")
    c_logp = torch.log_softmax(c_logits, dim=-1).contiguous()
    c_lens = torch.full((16,), 188, dtype=torch.int32, device="cuda")
    c_kw = dict(blank=0, beam_width=width, k_tokens=3000)
    c_scan = lambda: beam_scan(c_logp, c_lens, -12.0, **c_kw)  # noqa: E731
    c_plain = lambda: beam_scan_reference(c_logp, c_lens, -12.0, **c_kw)  # noqa: E731
    (cp1, ce1, ct1, cs1), (cp0, ce0, ct0, cs0) = c_scan(), c_plain()
    c_finite = torch.isfinite(ct0)
    c_err = (ct1[c_finite] - ct0[c_finite]).abs().max().item()
    c_exact = (torch.equal(cp1, cp0) and torch.equal(ce1, ce0) and torch.equal(c_finite, torch.isfinite(ct1))
               and all(torch.equal(a, b) for a, b in zip(cs1[2:], cs0[2:])))
    c_ms, c_plain_ms = paired_ms(c_scan, c_plain, 2)
    emit({"phase": "beam_chunked_shape", "B": 16, "T": 188, "V": 3000, "K": 3000, "W": width,
          "plan": scan_plan(width, 3000), "ms": c_ms, "plain_ms": c_plain_ms, "exact": c_exact, "max_abs_err": c_err,
          "card": card})
    check(c_exact and c_err <= total_tol, f"the chunked beam scan differs from the plain version (exact {c_exact}, "
                                          f"total {c_err})")
    source, pallas = "thunder_tpu_torch/csrc/beam_search.cu", "thunder_tpu/kernels/beam_pallas.py"
    shape = f"B={batch}, T={frames}, V=K={vocab}, W={width}"
    return [
        {"name": "beam_scan", "route": "cuda", "source": source, "replaces": f"{pallas}:214",
         "launches": counts["beam_scan"], "max_abs_err": scan_err, "ms": scan_ms, "plain_ms": scan_plain_ms,
         "ms_is": f"one launch at the forward's logits, {shape}", **beam_scan_bound(batch, frames, vocab, width),
         "chunked_ms": c_ms, "chunked_plain_ms": c_plain_ms, "chunked_is": "B=16, T=188, V=K=3000, W=16",
         "library_ms": None, "library": "none (no single PyTorch call computes a prefix beam search)"},
        {"name": "beam_backtrace", "route": "cuda", "source": source, "replaces": f"{pallas}:374",
         "launches": counts["beam_backtrace"], "max_abs_err": 0.0, "ms": walk_ms, "plain_ms": walk_plain_ms,
         "ms_is": f"one launch, one path a row, {shape}", **beam_backtrace_bound(batch, frames, 1),
         "library_ms": None, "library": "none (no single PyTorch call walks beam pointers)"},
    ]


if __name__ == "__main__":
    sys.exit(main())
