"""Smoke run of the PyTorch/CUDA port (``thunder_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a Hopper card (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which fails the run:

1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
2. build the CUDA kernels from ``thunder_tpu_torch/csrc`` (nvcc), then the
   native host runtime from ``thunder_tpu_torch/csrc/thunder_native.cpp``
   (g++; ``lm_native_build``: its seconds and the machine's cores);
3. each kernel against its plain PyTorch version on the card
   (``thunder_tpu_torch.kernels.selftest``), one JSON line per check (the
   log-mel also at the ``frontend_log_mel_edge_*`` sizes: 44.1 and 48 kHz,
   hop 161, n_fft 4096, the dense path's n_fft 400, a row of zeros, one
   frame, 66,536 rows, the wide path's n_fft 32,768; the separable repeat at
   the ``separable_edge_*`` shapes, tap slices among them);
4. QuartzNet15x5 greedy serving through ``CTCModule.create`` and
   ``InferenceEngine.predict`` at 64 rows x 15 s of speech-like audio, with
   random weights (seed 0) and BN by ``fit_bn`` (random affines, statistics
   fitted to 8 rows of the batch, so that the logits follow the input): the
   launch counts of one forward must be 1 log-mel and 77 separable repeats;
   rows 0-1 are held against the port's float32 CPU path (bf16-vs-f32 bound
   0.1 of the logits' scale; row 0's variation over time and its argmax
   tokens printed); RTF = audio seconds per second of device time; one forward under
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
   the port never calls it), each kernel alone (and in nanoseconds a frame),
   and the chain floor: the latency of a step's arithmetic alone (one thread,
   100,000 dependent lse3 steps, nothing loaded, stored or exchanged), times T,
   for each kernel;
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
   the float32 sum), timed here only (the add + LayerNorm's ``ms`` its device
   time a call, six input sets in turns under a sleep kernel's hold); the attention kernel and its PyTorch
   call are timed ``SPREAD_REPEATS`` times in turns (minimum, median and
   maximum printed; the median goes to the kernels line);
9. beam serving on the QuartzNet15x5 engine of phase 4, same 64 x 15 s batch:
   one ``InferenceEngine.predict(audio, beam_width=16, beam_backend="device")``
   must make exactly 1 log-mel, 77 separable-repeat, 1 ``beam_scan`` and 1
   ``beam_backtrace`` launch, and its transcripts must equal the same predict
   through the plain versions on the card, for all 64 rows; the beam decode
   is timed with CUDA events on the forward's own logits (the whole
   ``beam_search_device`` call, the scan and the backtrace apart, each beside
   its plain version; the backtrace's device time with its pointers in device
   memory, copies of them in turns under a sleep kernel's hold, and by the
   profiler's kernel durations with the L2 flushed; beside it the chain
   floor: ``thunder_beam_walk_chain``, one thread's dependent walk steps,
   times T and times the composed walk's 2 ceil(T / 32) + 31), and the whole
   predict on the host clock; on peaked
   logits (``scripts/bench_beam_device.py::peaked_logits``: 70 % blank
   frames, peak 6, numpy seed 0) rows 0-1 must equal the port's numpy host
   search, and so must rows 0-1 of the served logits; ``predict_long`` on a 60 s speech-like clip with the device
   beam must make one launch of each beam kernel per window and give the
   text of the same windows through the plain versions; the scan alone is
   timed on the first window's logits (B = 1, one 20 s window), and the
   window's backtrace of every slot's path is held to its plain version
   exactly and timed by the profiler (L2 flushed); and the scan
   past one block of shared memory (phase ``beam_chunked_shape``: B = 16, T =
   188, V = K = 3000, W = 16, the ``beam_device`` inputs of numpy seed 3, the
   chunked kernel) must equal its plain version exactly, both timed; and both
   beam kernels past the beam's state in shared memory (phase ``beam_wide``:
   W = 3,000 at B = 2, T = 10, V = K = 29, the workspace plan; W = 7,000 at B
   = 1, T = 20, V = K = 5, every slot's path walked from device memory), on
   the ``beam_device_w3000`` and ``beam_backtrace_w7000`` checks' inputs, must
   equal their plain versions exactly, all four timed;
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
    version (equal) and ``torch.rand`` (timed only), its ``ms`` the device
    time a call (six seeds in turns under a sleep kernel's hold), beside the
    profiler's kernel duration with the L2 flushed. The train step never
    launches ``dropout_keep_mask``: its ``launches`` is 0 and the count of
    that one call stands under ``own_call_launches``;
12. Citrinet-256 greedy serving (the published widths: an 80-mel
    ``FilterbankFeatures``, the stem, 21 squeeze-excite blocks with the
    stride on the last repeat, the 640-channel tail, a ``Conv1dDecoder``
    over 1,024 single-character tokens and the blank; random weights, seed
    0; BN by ``fit_bn``: random affines, statistics fitted to 8 rows of
    the batch) through ``CTCModule.create`` and
    ``InferenceEngine.predict`` at 64 rows x 15 s of speech-like audio (T =
    1501 -> 751 -> 376 -> 188): one predict must make exactly 1 log-mel and
    107 separable-repeat launches; forward ms (mean of ``CITRINET_TIMED``,
    CUDA events) and RTF; one profiled forward; rows 0-1 against the port's
    float32 CPU path (``LOGIT_BOUND``, argmax agreement printed); the
    log-mel kernel against its plain version on this batch at 80 mels
    (2e-3); the separable repeat at every shape of the plan against its
    plain version (8 bf16 ULP), four of them (the 80-channel stem, a
    stride-2 repeat at T 1501, a k 39 repeat at T 188, the 640-channel
    tail) timed beside it and the chain of PyTorch calls;
13. the device beam on that engine (W = 16) at K = 50 and with
    ``max_tokens_per_step=None`` (K = 1025): each predict must add exactly 1
    ``beam_scan`` and 1 ``beam_backtrace`` launch, and its 64 transcripts
    must equal the plain versions'; decode ms on the forward's logits; a 60
    s ``predict_long``, greedy (1 log-mel and 107 separable launches a
    window; each window's logits within ``LOGIT_BOUND`` of the same
    window's through the plain log-mel and separable repeat, over its valid
    frames) and with the device beam (one launch of each beam kernel a
    window, the plain versions' text);
14. Citrinet-256 CTC training at 16 rows x 15 s (``bench_train.py --model
    citrinet``: SpecAugment 2 + 2 masks, dither, dropout 0.1, bf16 compute,
    AdamW lr 1e-4, the 29-token character vocabulary and the fixed text of
    phase 6), as phase 6 runs QuartzNet: one ``Trainer.fit`` step must make
    exactly 1 log-mel, 1 ``ctc_alpha`` and 1 ``ctc_beta`` launch, the timed
    steps, a profile, every loss finite and the last below ``1 -
    CITRINET_LOSS_FALL`` times the first, and the train-mode loss without
    dropout or augmentation within ``TRAIN_LOSS_BOUND`` of float32 on the
    CPU; then the CTC pair against its plain version at the step's shape
    (B 16, T 188), at phase 7's tolerance. Each kernel's entry of the
    kernels line gives its launches on the Citrinet paths under
    ``citrinet_launches``, and its deviation from its plain version at
    Citrinet's shapes under ``citrinet_max_abs_err``;
15. wav2vec2-base at 16 x 15 s in each of the engine's modes (``W2V_MODES``:
    float, ``posconv_dense``, ``int8_weights``, ``int8_compute`` and both
    int8 modes): one predict must make exactly the 12 attention and 25 add +
    LayerNorm launches and, with ``int8_compute``, 54 int8 products (4 a
    layer and extractor convs 1-6); forward ms (CUDA events, the modes in
    turns, median of 5), ``weight_bytes``; rows 0-1 of each mode but float
    (phase 8 holds it) against the same mode in float32 on the CPU
    (``LOGIT_BOUND``); a profile of two modes; one 40 s predict in
    ``int8_weights`` + ``int8_compute`` with the same launches and the text
    of the same predict through the plain versions;
16. ``int8_products``: ``dynamic_int8_matmul`` at the four GEMM kinds (16 x
    749 rows) and ``dynamic_int8_conv`` at extractor convs 1-6, through
    ``torch._int_mm``, equal to the plain version (the float64 product) on the
    same card inputs, exactly; times beside the bf16 ``torch.matmul`` and
    ``conv1d`` they replace and their bounds (int8 operations at 1,979 TOP/s or
    bytes at 3.35 TB/s), and the convs also as a sum over taps (timed only);
17. ``conv_int8_serving``: QuartzNet15x5 (phase 4's module) and Citrinet-256
    (phase 12's) with ``int8_weights`` at 64 x 15 s: one predict must make 1
    log-mel and 77 (107) separable launches; forward ms beside the float
    engine's, in turns; ``weight_bytes`` of both; rows 0-1 against the same
    int8 engine in float32 on the CPU;
18. ``pos_conv_fold``: wav2vec2's positional conv (k 128, 768 channels, 16
    groups) at the train step's shape (bf16 8 x 749 from a float32
    parameter): the grouped conv forward and forward + backward against its
    block-diagonal dense fold built in the graph (the weight gradient read
    back as the diagonal blocks), times and the profiler's kernels of each,
    the fold's output and gradients within ``FOLD_GRAD_BOUND`` of the grouped
    conv's; the serving shape (16 x 749), forward only (timing only: no path
    changes);
19. ``c16_shapes``: the separable repeat at the smallest k that its taps
    take two launches at dilation 2 and C 256 (561, B 16, T 751) against its
    plain version, timed; the log-mel at 66,536 rows of 0.1 s clips (two
    launches over slices of rows) and at n_fft 32,768 (the wide path, two
    launches), timed, beside their ``frontend_log_mel_edge_*`` checks. The
    kernels line's log-mel, separable, attention and add + LayerNorm entries
    give their launches in phases 15 and 17 (``w2v2_mode_launches``,
    ``int8_weights_launches``) and at C16's shapes (``c16``).
20. ``loading``: real checkpoints through the user's entry points. QuartzNet15x5
    (phase 4's configuration and ``fit_bn`` weights) and Citrinet-256
    (phase 12's widths, a 1,024-piece unigram ``tokenizer.model`` trained by
    ``train_sentencepiece_model`` on ``SPM_LINES`` seeded lines, V = 1,025)
    written as ``.nemo`` archives in NeMo's raw layout (``write_nemo``:
    torch-layout weights under NeMo's keys, BN statistics, a
    ``model_config.yaml`` in NeMo's schema) and loaded by ``load_pretrained``
    (load seconds on the host clock, the archive's bytes): one forward at 64 x
    15 s must launch 1 log-mel and 77 (107) separable repeats and give logits
    bit-equal (SHA-256) to an engine built from the source module, with the
    same transcripts; the loaded Citrinet's device beam (W 16, K 50) must
    equal the source engine's and its text transform round-trip the seed
    text; both repo fixtures (``tests/fixtures/tiny_*.nemo``) on the card
    within ``LOGIT_BOUND`` of the float32 CPU path; ``save_inference_bundle``
    then ``load_inference_bundle`` of the loaded QuartzNet, the loaded
    Citrinet (with its ``tokenizer.model``) and a random wav2vec2-base (16 x
    15 s) must give bit-equal logits with the same launches;
    ``finetune_ctc_module`` on the QuartzNet archive with a new 30-token head
    (the archive's encoder exactly) and one ``Trainer.fit`` step at 16 x 15 s
    must launch 1 log-mel, 1 ``ctc_alpha`` and 1 ``ctc_beta`` with a finite
    loss; one step of a random wav2vec2-base at 8 x 15 s, dropout 0.1, with
    ``frozen_paths`` on its extractor must leave every extractor tensor
    bit-equal and move every other parameter. The kernels line's entries give
    their launches in each of these runs (``loading_launches``).
21. ``training_remat``: QuartzNet15x5 and Citrinet-256 at 16 x 15 s and
    wav2vec2-base at 8 x 15 s (``bench_train.py``'s configurations,
    wav2vec2 with ``--remat``), each through two forward + backward steps
    without ``remat`` and one with it from the same weights and generator
    state: loss, running statistics and generator state bit-equal, the
    gradients within ``REMAT_GRAD_FLOOR`` or ``REMAT_GRAD_SPREADS`` times
    the spread of the two steps without it, the remat step's launches as
    derived (wav2vec2: 24 + 24 attention, 49 + 50 add + dropout + LN); a
    CUDA generator's ``get_state``/``set_state`` under the sync debug mode
    "error"; then ``TrainStep`` with and without remat in turns: peak memory
    and step ms;
22. ``trainer_features``: QuartzNet15x5 at 16 x 15 s through ``Trainer.fit``
    with ``onecycle`` (``total_steps_arg``), ``FinetuneEncoderDecoder``,
    best-only checkpoints, ``eval_beam_width=16`` and a ``JsonlLogger`` (the
    rates equal the schedule's, 1 log-mel and 1 + 1 CTC launches a step);
    the frozen epoch alone (encoder bit-equal, decoder moved), its
    checkpoint restored bit for bit and resumed (the first loss within
    ``RESUME_LOSS_TOL`` of the uninterrupted run's); a plateau run and an
    early-stopping run;
23. ``learning_gate``: ``examples/synthetic_learning_demo.py``'s task on
    the port (2,048 tone-coded WAV items through ``ManifestDatamodule``, 6
    epochs) must end at a held-out WER of at most ``GATE_WER``; its WER
    curve, wall seconds and the loader's wait. The kernels line's entries
    give their launches in phases 21-23 (``training_launches``).
24. ``lm_native``: the native host runtime (``thunder_tpu_torch/native.py``)
    builds with g++ (its seconds and the machine's cores printed); 64 FLAC
    files of 15 s (phase 4's rows quantized to 16 bits, written by
    ``flac_bytes``) read back through ``data.load_audio`` bit-equal to the
    PCM written (the decode rate in audio seconds per host second); QuartzNet15x5
    (``fit_bn`` weights) serves them greedily with 1 log-mel and 77 separable
    launches and the in-memory rows' transcripts; a 4-gram ``NGramLM`` and a
    ``WordFusionLM`` over a word 3-gram, fitted on ``LM_LINES`` seeded lines,
    each with a native mirror; ``predict(beam_width=16, beam_backend="host",
    lm=NGramLM, lm_weight=0.5)`` launches nothing past the forward and runs the
    C++ beam, and ``beam_search_decode`` on ``peaked_logits`` at 64 × 751 × 29
    with and without the LM: on rows 0-7 of each the C++ beam's ids equal the
    numpy search's (``use_native=False``, one spawned process a row), and its
    host milliseconds are printed beside the numpy search's;
    ``predict(beam_width=16, beam_backend="device", lm=WordFusionLM)`` launches
    1 log-mel, 77 separable repeats, 1 ``beam_scan`` and 1 ``beam_backtrace``,
    and its 64 transcripts equal the same decode through the plain versions on
    the card and on the port's CPU path, where each hypothesis both keep (the
    16-best of each row) scores within the rounding of a float32 chain of T
    steps (T 2^-24 of its magnitude) and a row whose best differs must be a
    rounding tie: of the LM ranking when both paths kept the same 16
    survivors, else of the scan's top-16 cut or its pruning threshold at the
    frame where the survivors first part (``lm_ranked_rows``,
    ``lm_parting``; such a row's logits and both ranked lists are written
    under ``smoke_out/lm_ties``, and ``python3 chip_smoke.py --lm-ties N``
    runs only this comparison, on the rows of seeds 0 to N - 1); the host
    ranking's milliseconds beside the device decode's
    and its kernels'. The kernels line's entries
    give their launches in this phase's runs (``lm_native_launches``).

Every profile (``device_profile``) must hold each launch of the port's
kernels that the launch counters saw during the profiled call; a trace that
misses some is taken again (``records_complete``, ``attempts``).

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
# Citrinet-256 (phases 12-14): a 1,024-token vocabulary of single characters, so the char tokenizer encodes them
CITRINET_VOCAB = [chr(0x4E00 + i) for i in range(1024)]
CITRINET_SEPARABLE = 107  # separable-repeat launches a forward: the stem, 21 blocks x 5 repeats, the tail
CITRINET_TIMED = 10
# the last of the 14 Citrinet training losses must be below (1 - CITRINET_LOSS_FALL) x the first; on the port's
# float32 CPU path the same configuration (full depth and width; ``citrinet_cpu_loss_fall``) at 2 x 6 s and
# 4 x 8 s ended at 0.922 and 0.923 of the first loss (AdamW at lr 1e-4 moves it slowly)
CITRINET_LOSS_FALL = 0.05
TRAIN_KERNEL_ULP = 8.0  # the training kernels against their plain versions, bf16 ULP (dscale, dbias: 1 %)
HBM_BYTES_PER_MS = 3.35e9  # 3.35 TB/s
BF16_FLOP_PER_MS, F32_FLOP_PER_MS = 989e9, 67e9  # dense tensor-core bf16, float32 outside the tensor cores


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets ``t_s``, the seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
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


def fit_bn(module, audio: np.ndarray, lengths: np.ndarray) -> None:
    """BN for a deep random network whose output follows its input: every affine drawn with scale U(0.2, 0.5)
    and bias U(0.5, 1.0), so that the ReLUs mostly pass, and every running mean and variance set to those of the
    BN's input on ``audio`` (full-length rows), layer by layer in one eval forward. ``randomize_bn``'s
    statistics fit no activations: their offsets swamp Citrinet-256's signal, whose logits then hardly vary
    over time and whose transcripts are one character long. Fitted statistics with ``randomize_bn``'s centred
    affines make it chaotic instead: bf16 rounding then moves its logits by nearly ``LOGIT_BOUND``."""
    import torch

    from thunder_tpu_torch.models.layers import TorchBatchNorm

    def fit(bn, args) -> None:
        x = args[0].float().flatten(0, -2)
        bn.mean.copy_(x.mean(0))
        bn.var.copy_(x.var(0))

    rng = np.random.default_rng(0)
    norms = [m for m in module.model.modules() if isinstance(m, TorchBatchNorm)]
    device = next(module.model.parameters()).device
    with torch.no_grad():
        for bn in norms:
            bn.scale.copy_(torch.as_tensor(rng.uniform(0.2, 0.5, bn.scale.shape).astype(np.float32)))
            bn.bias.copy_(torch.as_tensor(rng.uniform(0.5, 1.0, bn.bias.shape).astype(np.float32)))
    hooks = [bn.register_forward_pre_hook(fit) for bn in norms]
    try:
        with torch.no_grad():
            module.model(torch.as_tensor(audio, device=device), torch.as_tensor(lengths, device=device))
    finally:
        for hook in hooks:
            hook.remove()


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


#: the name patterns of the port's own kernels, which the launch counters count one for one
OWN_KERNELS = ("log_mel_", "separable_repeat_kernel", "ctc_alpha_kernel", "ctc_beta_kernel", "mha_forward_kernel",
               "mha_train_d", "add_ln_", "beam_scan", "beam_backtrace", "dropout_keep_mask_kernel")


def device_profile(fn, attempts: int = 3) -> dict:
    """Device activity of one call of ``fn`` under torch.profiler: busy and idle
    time between its first and last device event, the top kernels by time, and
    the time per category of ``PROFILE_CATEGORIES`` (the rest is "elementwise_and_other").

    The trace must hold every launch of the port's kernels that the launch counters saw during the call
    (``own_kernel_events`` against ``own_kernel_launches``): CUPTI can drop kernel records (a Citrinet serving
    profile once listed 656 of its 662 events, no log-mel and 104 of 107 separable repeats, while the counters
    saw 1 and 107). A trace that misses some is taken again, up to ``attempts`` calls; ``records_complete``
    says whether the kept one holds them all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launched = sum(launch_counts().values()) - sum(before.values())
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        own = sum(any(p in e.name for p in OWN_KERNELS) for e in events)
        if own == launched:
            break
    completeness = {"own_kernel_launches": launched, "own_kernel_events": own, "records_complete": own == launched,
                    "attempts": attempt}
    if not events:
        return {"device_events": 0, "idle_share": "not measured", **completeness}
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
        **completeness,
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


def ctc_chain_floor(t: int, steps: int = 100000) -> dict:
    """The least time of the CTC pair's two chains of ``t`` steps on this card: the latency of one step's
    arithmetic alone (``thunder_ctc_lse3_chain``: one thread runs ``steps`` dependent lse3 and adds on two
    states, with no neighbour to fetch and nothing loaded or stored), times ``t``, for each of the two kernels."""
    import torch

    from thunder_tpu_torch.kernels import _build

    lib, out = _build.load(), torch.zeros(2, device="cuda")

    def chain():
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.thunder_ctc_lse3_chain(out.data_ptr(), steps, -0.5, -2.0, stream), "thunder_ctc_lse3_chain")

    step = cuda_ms(chain, 3) / steps
    check(bool(torch.isfinite(out).all()), f"the lse3 chain ended on {out.tolist()}")
    return {"chain_floor_ms": 2 * t * step, "lse3_step_ns": step * 1e6}


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


def beam_backtrace_bound(parents, slots0) -> dict:
    """The bytes the function must move on this run's pointers: each 32-byte sector (the least the card's memory
    moves) of the two (B, T, W) int32 pointer fields that the walk reads, once however many paths read it (a path
    reads parents[t][slot] and exts[t][slot] at each frame whose slot is in [0, W); the fields start on a sector),
    the start slots read, the tokens (B, n_out, T) and origins written. ``staging_ms``: both fields read whole
    once, what staging them in shared memory costs at the memory rate."""
    p, slot = parents.cpu().numpy().astype(np.int64), slots0.cpu().numpy().astype(np.int64)
    batch, t, width = p.shape
    n_out = slot.shape[1]
    rows, sectors = np.arange(batch)[:, None], []
    for f in range(t - 1, -1, -1):
        inside = (slot >= 0) & (slot < width)
        sectors.append((((rows * t + f) * width + slot) >> 3)[inside])
        slot = np.where(inside, p[rows, f, np.where(inside, slot, 0)], 0)
    n_sectors = int(np.unique(np.concatenate(sectors)).size) if sectors else 0
    return {**bound(2 * 32 * n_sectors + 4 * batch * n_out * (t + 2)), "walk_sectors": 2 * n_sectors,
            "staging_ms": 8 * batch * t * width / HBM_BYTES_PER_MS}


def backtrace_chain_floor(t: int, steps: int = 100000) -> dict:
    """The least time of the backtrace's dependent chain on this card: the latency of one step of the walk alone
    (``thunder_beam_walk_chain``: one thread runs ``steps`` dependent shared-memory loads of a slot's parent, each
    made canonical, with nothing else on the chain), times the serial walk's ``t`` steps and times the composed
    walk's ``2 ceil(t / 32) + 31``."""
    import torch

    from thunder_tpu_torch.kernels import _build

    lib, out = _build.load(), torch.zeros(1, dtype=torch.int32, device="cuda")

    def chain():
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.thunder_beam_walk_chain(out.data_ptr(), steps, 16, stream), "thunder_beam_walk_chain")

    step = cuda_ms(chain, 3) / steps
    check(0 <= int(out.item()) < 16, f"the walk chain ended on slot {out.item()}")
    return {"chain_floor_serial_ms": t * step, "chain_floor_composed_ms": (2 * -(-t // 32) + 31) * step,
            "walk_step_ns": step * 1e6}


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


def logits_vs_cpu_f32(phase: str, module, logits, out_lengths, audio, lengths, card: str = None, **modes) -> dict:
    """Rows 0-1 of the card's bf16 logits against the port's float32 CPU path (plain versions of every
    kernel) on the same module's weights, in the same serving ``modes`` of the engine: equal lengths, and the
    largest deviation over valid frames within ``LOGIT_BOUND`` of the CPU logits' scale; the argmax agreement,
    row 0's variation over time and its argmax tokens are printed and returned."""
    import torch

    from thunder_tpu_torch.engine import InferenceEngine

    torch.set_num_threads(8)
    t0 = time.perf_counter()
    ref_logits, ref_lengths = InferenceEngine(module.to("cpu"), **modes)(audio[:2], lengths[:2])
    cpu_seconds = time.perf_counter() - t0
    check(torch.equal(ref_lengths, out_lengths[:2].cpu()), f"lengths differ from the CPU path: {ref_lengths} vs {out_lengths[:2]}")
    got = logits[:2].float().cpu()
    valid = torch.arange(got.shape[1])[None, :] < ref_lengths[:, None]
    rel = ((got - ref_logits).abs()[valid].max() / ref_logits.abs()[valid].max()).item()
    agree = (got.argmax(-1) == ref_logits.argmax(-1))[valid].float().mean().item()
    row0 = ref_logits[0, : int(ref_lengths[0])]  # how much the logits follow the input: a flat row checks little
    line = {"phase": phase, "rows": 2, "max_rel_dev": rel, "bound": LOGIT_BOUND, "argmax_agreement": agree,
            "row0_time_std_over_scale": (row0.std(0).mean() / ref_logits.abs()[valid].max()).item(),
            "row0_argmax_tokens": int(row0.argmax(-1).unique().numel()), "cpu_seconds": cpu_seconds}
    emit({**line, "card": card} if card else line)
    check(rel < LOGIT_BOUND, f"{phase}: bf16 card vs f32 CPU deviation {rel} >= {LOGIT_BOUND}")
    return line


def separable_shapes(engine, audio, lengths) -> dict:
    """The separable repeats of a conv engine's plan by shape: ``(t_in, c_in, c_out, k, stride, dilation)`` ->
    ``[one repeat's plan, launches a forward]``, from the frontend's output on ``audio``."""
    feats, _ = engine.frontend(audio, lengths)
    shapes = {}
    t_in, c_in = feats.shape[1], feats.shape[2]
    for block in engine._plan:
        for rp in block.repeats:
            if rp.kind == "separable":
                key = (t_in, c_in, rp.pw.shape[1], rp.kernel_size, rp.stride, rp.dilation)
                shapes.setdefault(key, [rp, 0])[1] += 1
            c_in = rp.pw.shape[1]
            t_in = -(-t_in // rp.stride)
    return shapes


def separable_shape_error(key: tuple, rp, gen) -> tuple:
    """One separable shape of a plan (``separable_shapes``) at B = BATCH on random bf16 input: the kernel's
    largest deviation from its plain version, absolute and in bf16 ULP. Returns both, and the two calls'
    arguments and keywords."""
    import torch

    from thunder_tpu_torch.kernels.separable_conv import fused_separable_repeat, separable_repeat_reference
    from thunder_tpu_torch.kernels.selftest import ulp_bf16_error

    t, c, co, k, s, d = key
    x = torch.randn((BATCH, t, c), device="cuda", generator=gen).to(torch.bfloat16)
    out_len = torch.full((BATCH,), -(-t // s), dtype=torch.int32, device="cuda")
    args = (x, out_len, rp.dw, rp.pw, rp.bias, k)
    kw = dict(stride=s, dilation=d, relu=rp.relu)
    got, want = fused_separable_repeat(*args, **kw), separable_repeat_reference(*args, **kw)
    return (got.float() - want.float()).abs().max().item(), ulp_bf16_error(got, want), args, kw


def time_separable_shape(phase: str, key: tuple, rp, count: int, gen) -> dict:
    """One separable shape of a plan (``separable_shapes``) at B = BATCH on random bf16 input: the kernel
    against its plain version (8 bf16 ULP), both timed in turns, and the chain of PyTorch calls; prints and
    returns the line, with the shape's ``work`` for ``bound``."""
    from thunder_tpu_torch.kernels.separable_conv import (
        fused_separable_repeat,
        separable_plan,
        separable_repeat_reference,
    )

    t, c, co, k, s, d = key
    e_abs, e_ulp, args, kw = separable_shape_error(key, rp, gen)
    km, pm = paired_ms(lambda: fused_separable_repeat(*args, **kw), lambda: separable_repeat_reference(*args, **kw), 10)
    _, chain_ms = paired_ms(lambda: fused_separable_repeat(*args, **kw), lambda: separable_chain(*args, **kw), 10)
    work = separable_bound(BATCH, t, -(-t // s), c, co, k)
    line = {"t_in": t, "c_in": c, "c_out": co, "k": k, "stride": s, "dilation": d, "relu": rp.relu, "count": count,
            "ms": km, "plain_ms": pm, "chain_ms": chain_ms, "max_abs_err": e_abs, "ulp": e_ulp,
            "plan": separable_plan(c, k, s, d), **bound(work["bytes"], work["bf16_flop"], work["f32_flop"])}
    emit({phase: line})
    check(e_ulp <= 8.0, f"separable repeat at {key} off by {e_ulp} bf16 ULP")
    return {**line, "work": work}


def gpu_line() -> str:
    cmd = ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


class Failed(Exception):
    """A phase failed; the run prints why and exits 1."""


def check(ok: bool, message: str) -> None:
    if not ok:
        raise Failed(message)


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lm-ties", type=int, default=0, metavar="N",
                        help="run only lm_tie_search over N seeds (phase 24's CPU-path comparison)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device", file=sys.stderr)
        return 1
    try:
        if args.lm_ties:
            card = gpu_line()
            print(card, flush=True)
            return lm_tie_search(card, args.lm_ties)
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
    from thunder_tpu_torch.kernels.selftest import KERNEL_CHECKS, exact_float32, run_selftests
    from thunder_tpu_torch.ops.masking import lengths_to_mask, normalize_tensor
    from thunder_tpu_torch.kernels.separable_conv import fused_separable_repeat
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    card = gpu_line()
    print(card, flush=True)
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    exact_float32()

    # ---- build: the CUDA kernels (nvcc), then the native host runtime (g++), which later phases use before 24
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": _build.library_path().name})
    lm_native_build()

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
    rng = np.random.default_rng(0)
    samples = int(SECONDS * SAMPLE_RATE)
    base = speech_like(samples, rng)
    audio = np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(BATCH)])
    lengths = np.full((BATCH,), samples, dtype=np.int32)
    fit_bn(module, audio[:8], lengths[:8])
    engine = InferenceEngine(module)
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

    logits_vs_cpu_f32("vs_cpu_f32", module, logits, out_lengths, audio, lengths)

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

    shapes = separable_shapes(engine, audio_d, lengths_d)
    total_k = total_p = total_chain = max_err = max_ulp = 0.0
    work = {"bytes": 0.0, "f32_flop": 0.0, "bf16_flop": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for key, (rp, count) in shapes.items():
        line = time_separable_shape("separable_shape", key, rp, count, gen)
        km, pm, chain_ms = line["ms"], line["plain_ms"], line["chain_ms"]
        total_k, total_p, total_chain = total_k + count * km, total_p + count * pm, total_chain + count * chain_ms
        max_err, max_ulp = max(max_err, line["max_abs_err"]), max(max_ulp, line["ulp"])
        for name in work:
            work[name] += count * line["work"][name]
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
    # ---- the same QuartzNet served from int8 weights
    int8_launches = {"quartznet": conv_int8_phase(card, "quartznet", engine, module, audio, lengths, 77)}
    del engine, module, logits

    # ---- wav2vec2-base training, then its kernels at the step's shapes
    kernels.extend(wav2vec2_training_phase(card))

    # ---- Citrinet-256: greedy serving, the device beam (K = 50 and every token), predict_long, training
    citrinet_engine, c_audio, c_lengths, c_serving, c_serving_checks = citrinet_serving_phase(card)
    c_beam = citrinet_beam_phase(card, citrinet_engine, c_audio, c_lengths)
    int8_launches["citrinet"] = conv_int8_phase(card, "citrinet", citrinet_engine, citrinet_engine.module, c_audio,
                                                c_lengths, CITRINET_SEPARABLE)
    del citrinet_engine
    c_training, c_training_checks = citrinet_training_phase(card, KERNEL_CHECKS["ctc_recursion"][1])
    add_citrinet_launches(kernels, c_serving, c_beam, c_training)
    for entry in kernels:
        entry.update({**c_serving_checks, **c_training_checks}.get(entry["name"], {}))

    # ---- the engine's serving modes: wav2vec2's five, the int8 products, the positional conv's fold, C16's shapes
    mode_launches = wav2vec2_modes_phase(card)
    int8_products_phase(card)
    pos_conv_fold_phase(card)
    c16 = c16_shapes_phase(card, checks)
    add_mode_launches(kernels, int8_launches, mode_launches, c16)

    # ---- loading real checkpoints: NeMo archives, the fixtures, bundles, fine-tuning, frozen_paths
    add_loading_launches(kernels, loading_phase(card))

    # ---- the rest of training: remat on the three encoders, the trainer's features, the learning gate
    training_runs = {f"remat_{name}": counts for name, counts in training_remat_phase(card).items()}
    training_runs["trainer_features_run_a"] = trainer_features_phase(card)
    training_runs["learning_gate"] = learning_gate_phase(card)
    add_training_launches(kernels, training_runs)

    # ---- language-model decoding and the native host runtime: FLAC files, the C++ beam, word fusion
    add_lm_native_launches(kernels, lm_native_phase(card))

    print(gpu_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def train_path(card: str, prefix: str, create, loss_fall: float) -> tuple:
    """Train a conv CTC model at TRAIN_BATCH x TRAIN_SECONDS on the card (``bench_train.py``'s configuration,
    ``create(device, dtype, train_config)`` the model; phases ``{prefix}train_launches_per_step``,
    ``{prefix}training``, ``{prefix}train_profile``, ``{prefix}train_vs_cpu_f32``): one ``Trainer.fit`` step
    must make exactly 1 log-mel, 1 ``ctc_alpha`` and 1 ``ctc_beta`` launch; then the timed steps, every loss
    finite and the last below ``1 - loss_fall`` times the first; then the train-mode loss without dropout or
    augmentation, bf16 on the card against float32 on the CPU. Returns the launch counts and the batch on the
    card (audio, lengths, targets, target lengths)."""
    import torch

    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.optim import adamw
    from thunder_tpu_torch.training.trainer import Trainer, TrainStep, _encode_targets

    tt = BatchTextTransformer(VOCAB)
    bf16 = torch.bfloat16
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
    emit({"phase": f"{prefix}train_launches_per_step", **counts})
    check(counts == expected_counts(fused_log_mel=1, ctc_alpha=1, ctc_beta=1),
          f"one {prefix}train step must launch 1 log-mel, 1 ctc_alpha and 1 ctc_beta, got {counts}")
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
    emit({"phase": f"{prefix}training", "batch": TRAIN_BATCH, "seconds": TRAIN_SECONDS, "step_ms": step_ms,
          "step_ms_host_clock": host_ms, "audio_s_per_s": TRAIN_BATCH * TRAIN_SECONDS / (step_ms / 1e3),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses, "card": card})
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] < (1 - loss_fall) * losses[0],
          f"loss did not fall by {loss_fall:.0%} over {len(losses)} steps: {losses[0]} -> {losses[-1]}")
    emit({"phase": f"{prefix}train_profile", **device_profile(lambda: step(*batch, generator))})

    # bf16 on the card against float32 on the CPU: one train-mode forward, dropout and augmentation off
    with torch.no_grad():
        card_loss, _ = create("cuda", bf16, False).loss(audio[:2], lengths[:2], targets[:2], target_lengths[:2],
                                                        train=True)
        t0 = time.perf_counter()
        cpu_loss, _ = create("cpu", torch.float32, False).loss(audio[:2], lengths[:2], targets[:2],
                                                               target_lengths[:2], train=True)
    rel = abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    emit({"phase": f"{prefix}train_vs_cpu_f32", "rows": 2, "card_loss": card_loss.item(), "cpu_loss": cpu_loss.item(),
          "rel_dev": rel, "bound": TRAIN_LOSS_BOUND, "cpu_seconds": time.perf_counter() - t0})
    check(rel < TRAIN_LOSS_BOUND, f"bf16 card loss vs f32 CPU loss off by {rel} >= {TRAIN_LOSS_BOUND}")
    return counts, batch


def ctc_pair_check(t: int, targets, target_lengths, seed: int) -> dict:
    """The CTC kernel pair (``ctc_alpha``, then ``ctc_beta``) against its plain version at ``len(targets)`` x
    ``t`` frames over VOCAB and the blank, on the log-softmax of random logits (generator ``seed``): returns
    ``loss_delta`` (the summed |loss difference| per target length), ``grad_rel`` (the gradient's largest
    deviation over its scale) and ``max_abs_err``, with the two calls and their inputs for timing."""
    import torch

    from thunder_tpu_torch.kernels.ctc import alpha_reference, beta_reference, ctc_alpha, ctc_beta, ll_from_alpha
    from thunder_tpu_torch.ops.ctc import extended_emissions

    batch = targets.shape[0]
    logits = torch.randn((batch, t, len(VOCAB) + 1), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(seed))
    log_probs = torch.log_softmax(logits, dim=-1)
    lens = torch.full((batch,), t, dtype=torch.int32, device="cuda")
    lp_z, skip_ok = extended_emissions(log_probs, targets, blank=0)
    tl = target_lengths
    ghat = 1.0 / tl.float()

    def kernel_pair():
        alpha = ctc_alpha(lp_z, skip_ok, lens, tl)
        return alpha, ctc_beta(lp_z, alpha, skip_ok, lens, tl, ll_from_alpha(alpha, lens, tl), ghat)

    def plain_pair():
        alpha = alpha_reference(lp_z, skip_ok, lens, tl)
        return alpha, beta_reference(lp_z, alpha, skip_ok, lens, tl, ll_from_alpha(alpha, lens, tl), ghat)

    (a_k, d_k), (a_p, d_p) = kernel_pair(), plain_pair()
    ll_k, ll_p = ll_from_alpha(a_k, lens, tl), ll_from_alpha(a_p, lens, tl)
    return {"log_probs": log_probs, "lp_z": lp_z, "skip_ok": skip_ok, "lens": lens, "tl": tl, "ghat": ghat,
            "alpha": a_k, "kernel_pair": kernel_pair, "plain_pair": plain_pair,
            "loss_delta": ((ll_k - ll_p) / tl).abs().sum().item(),
            "grad_rel": ((d_k - d_p).abs().max() / d_p.abs().max()).item(),
            "max_abs_err": max((ll_k - ll_p).abs().max().item(), (d_k - d_p).abs().max().item())}


def training_phase(card: str, ctc_tol: float) -> dict:
    """Train QuartzNet15x5 at TRAIN_BATCH x TRAIN_SECONDS on the card (phases 6 and 7 of the
    module docstring); returns the CTC kernel pair's entry of the kernels line."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.kernels.ctc import ctc_alpha, ctc_beta, ll_from_alpha
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    tt = BatchTextTransformer(VOCAB)

    def create(device, dtype, train_config: bool) -> CTCModule:
        """The same weights (generator seed 0) in either configuration."""
        frontend = FilterbankFeatures(num_time_masks=2, num_freq_masks=2) if train_config else FilterbankFeatures(dither=0.0)
        encoder = QuartznetEncoder(repeat_blocks=3, dropout=0.1 if train_config else 0.0, dtype=dtype)
        return CTCModule.create(torch.Generator().manual_seed(0), frontend, encoder, Conv1dDecoder(29, dtype=dtype), tt,
                                device=device)

    counts, batch = train_path(card, "", create, LOSS_FALL)

    # the CTC pair at the training shape: kernel, plain version and F.ctc_loss on the same inputs
    pair = ctc_pair_check(751, batch[2], batch[3], seed=2)
    lp_z, skip_ok, lens, tl, ghat, a_k = (pair[name] for name in ("lp_z", "skip_ok", "lens", "tl", "ghat", "alpha"))
    kernel_pair, plain_pair = pair["kernel_pair"], pair["plain_pair"]
    loss_delta, grad_rel, err = pair["loss_delta"], pair["grad_rel"], pair["max_abs_err"]
    lp_t = pair["log_probs"].detach().transpose(0, 1).contiguous().requires_grad_(True)

    def library():
        loss = F.ctc_loss(lp_t, batch[2], lens, tl, blank=0, reduction="sum", zero_infinity=True)
        return torch.autograd.grad(loss, lp_t)

    k_ms, p_ms = paired_ms(kernel_pair, plain_pair, 3)
    lib_ms = cuda_ms(library, 20)
    ll = ll_from_alpha(a_k, lens, tl)
    alpha_ms = cuda_ms(lambda: ctc_alpha(lp_z, skip_ok, lens, tl), 20)
    beta_ms = cuda_ms(lambda: ctc_beta(lp_z, a_k, skip_ok, lens, tl, ll, ghat), 20)
    floor = ctc_chain_floor(751)
    emit({"phase": "ctc_training_shape", "T": 751, "B": TRAIN_BATCH, "S": int(lp_z.shape[2]),
          "kernel_ms": k_ms, "alpha_ms": alpha_ms, "beta_ms": beta_ms, "alpha_ns_per_frame": alpha_ms * 1e6 / 751,
          "beta_ns_per_frame": beta_ms * 1e6 / 751, "plain_ms": p_ms, "library_ms": lib_ms, **floor,
          "loss_delta": loss_delta, "grad_rel_delta": grad_rel, "card": card})
    check(max(loss_delta, grad_rel) <= ctc_tol,
          f"CTC pair at the training shape off by {max(loss_delta, grad_rel)} > {ctc_tol}")
    return {"name": "ctc_recursion", "route": "cuda", "source": "thunder_tpu_torch/csrc/ctc_recursion.cu",
            "replaces": "thunder_tpu/kernels/ctc_pallas.py:264", "launches": counts["ctc_alpha"] + counts["ctc_beta"],
            "launches_is": "ctc_alpha + ctc_beta in one train step", "max_abs_err": err, "ms": k_ms,
            "ms_is": f"ctc_alpha + ctc_beta at T=751, B={TRAIN_BATCH}, S={lp_z.shape[2]}", "alpha_ms": alpha_ms,
            "beta_ms": beta_ms, "plain_ms": p_ms, **ctc_bound(751, TRAIN_BATCH, int(lp_z.shape[2])),
            "chain_floor_ms": floor["chain_floor_ms"], "library_ms": lib_ms,
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
    from thunder_tpu_torch.kernels.compare_builds import COLD_SETS, cold_ms
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
    # the device time a call with the inputs in device memory: the forward's x and y and COLD_SETS - 1 more sets of
    # their shape, in turns, the card held while the host queues
    gen = torch.Generator(device="cuda").manual_seed(4)
    sets = [(x, y)] + [tuple(torch.randn(x.shape, device="cuda", generator=gen).to(x.dtype) for _ in range(2))
                       for _ in range(COLD_SETS - 1)]
    n_cold = cold_ms([lambda a=a: add_layer_norm(a[0], a[1], ln.scale, ln.bias) for a in sets])["ms"]
    del sets
    emit({"phase": "w2v2_add_ln_shape", "rows": rows, "D": h, "cold_ms": n_cold, "host_paced_ms": n_ms,
          "plain_ms": n_plain, "library_ms": n_lib, "ulp": n_ulp})
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
         "max_abs_err": n_err, "max_ulp": n_ulp, "ms": n_cold, "plain_ms": n_plain, "host_paced_ms": n_ms,
         "ms_is": f"one launch at {rows} rows x {h} (layer 0's first add + LayerNorm): device time a call with the "
                  f"inputs in device memory ({COLD_SETS} input sets in turns, the card held while the host queues); "
                  "host_paced_ms: back-to-back calls",
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
    from thunder_tpu_torch.kernels.compare_builds import COLD_SETS, cold_ms, device_ms_by_kernel, flushed_kernel_ms
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
    m_host_ms, m_plain = paired_ms(lambda: dropout_keep_mask(x.shape, seed, rate),
                                   lambda: dropout_keep_mask_reference(x.shape, seed, rate), 20)
    # the device time a call: six seeds in turns, the card held while the host queues; and the kernel's duration by
    # the profiler with the L2 flushed before each call
    seeds = [seed + i for i in range(COLD_SETS)]
    m_ms = cold_ms([lambda s=s: dropout_keep_mask(x.shape, s, rate) for s in seeds])["ms"]
    m_flushed = flushed_kernel_ms(lambda: dropout_keep_mask(x.shape, seed, rate), ("dropout_keep_mask",))
    m_lib = cuda_ms(lambda: (torch.rand(x.shape, device="cuda") >= rate).float(), 20)
    emit({"phase": "w2v2_train_keep_mask_shape", "rows": rows, "D": h, "rate": rate, "kept": kept, "cold_ms": m_ms,
          "flushed_ms": m_flushed, "host_paced_ms": m_host_ms, "plain_ms": m_plain, "library_ms": m_lib,
          "equal_to_plain": torch.equal(keep, keep_p)})
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
         "flushed_ms": m_flushed, "host_paced_ms": m_host_ms,
         "ms_is": f"one launch at {rows} rows x {h}, rate {rate}: device time a call, {COLD_SETS} seeds in turns, the "
                  "card held while the host queues; flushed_ms: the kernel's duration by the profiler, the L2 flushed "
                  "before each call; host_paced_ms: back-to-back calls",
         **bound(4 * rows * h, f32_flop=12.0 * rows * h),
         "library_ms": m_lib, "library": "(torch.rand(shape) >= rate).float(): other bits, the same distribution"},
    ]


def beam_phase(card: str, engine, audio: np.ndarray, lengths: np.ndarray, total_tol: float) -> list:
    """Beam serving on the phase-4 engine (phase 9 of the module docstring); returns the scan's and
    the backtrace's entries of the kernels line."""
    import torch

    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.kernels.beam import (
        backtrace_plan,
        beam_backtrace,
        beam_backtrace_reference,
        beam_scan,
        beam_scan_reference,
        scan_plan,
    )
    from thunder_tpu_torch.kernels.compare_builds import cold_ms, flushed_kernel_ms
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
    walk_host_ms, walk_plain_ms = paired_ms(walk, walk_plain, 10)
    # the backtrace's device time: its pointers in device memory (copies of them in turns, over 100 MB, the card
    # held while the host queues), and by the profiler's kernel durations with the L2 flushed before each call
    sets = [(p1.clone(), e1.clone()) for _ in range(-(-100_000_000 // (2 * p1.numel() * 4)))]
    walk_ms = cold_ms([lambda p=p, e=e: beam_backtrace(p, e, slots0) for p, e in sets], 2 * len(sets))["ms"]
    del sets
    walk_flushed_ms = flushed_kernel_ms(walk, ("beam_backtrace",))
    emit({"phase": "beam_decode", "B": batch, "T": frames, "V": vocab, "W": width, "decode_ms": decode_ms,
          "decode_ms_host_clock": decode_host_ms, "decode_plain_ms": decode_plain_ms, "scan_ms": scan_ms,
          "scan_plain_ms": scan_plain_ms, "backtrace_cold_ms": walk_ms, "backtrace_flushed_ms": walk_flushed_ms,
          "backtrace_host_paced_ms": walk_host_ms, "backtrace_plain_ms": walk_plain_ms,
          "backtrace_plan": backtrace_plan(width, 1, frames),
          "forward_ms": cuda_ms(lambda: engine.infer(audio_d, lengths_d), 5), **timings, "card": card})
    emit({"phase": "beam_profile", **device_profile(lambda: engine.predict(audio, lengths, **beam))})

    # against the numpy host search: exact on peaked logits, the share that agrees on the served ones
    peaked = peaked_logits(np.random.default_rng(0), BATCH, frames, vocab, blank)
    t0 = time.perf_counter()
    host = beam_search_decode(peaked[:2], blank=blank, beam_width=width, max_tokens_per_step=None, use_native=False)
    host_s = time.perf_counter() - t0
    card_rows = beam_search_device(torch.as_tensor(peaked, device="cuda"), blank=blank, beam_width=width,
                                   max_tokens_per_step=None)[:2]
    peaked_equal = [h.tolist() == d.tolist() for h, d in zip(host, card_rows)]
    served = logits[:2].float().cpu().numpy()
    served_host = beam_search_decode(served, out_lengths[:2].cpu().numpy(), blank=blank, beam_width=width,
                                     use_native=False)
    served_card = beam_search_device(logits[:2], out_lengths[:2], blank=blank, beam_width=width)
    served_share = sum(h.tolist() == d.tolist() for h, d in zip(served_host, served_card)) / 2
    emit({"phase": "beam_vs_host", "peaked_rows_equal": peaked_equal, "served_rows_agree_share": served_share,
          "host_seconds_two_rows": host_s})
    check(all(peaked_equal), f"device beam differs from the host search on peaked rows 0-1: {peaked_equal}")
    check(served_share == 1.0, f"device beam differs from the host search on served rows 0-1: share {served_share}")

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
    # the scan of one window alone (B = 1), on the first window's own logits, and the window's backtrace of every
    # slot's path (n_out = W) against its plain version, exactly, by the profiler's kernel durations (L2 flushed)
    first = torch.as_tensor(clip[None, :chunk], device="cuda")
    w_logits, _, w_lengths = engine.infer(first, torch.full((1,), chunk, dtype=torch.int32, device="cuda"))
    w_logp = torch.log_softmax(w_logits.float(), dim=-1)
    window_scan_ms = cuda_ms(lambda: beam_scan(w_logp, w_lengths, -12.0, **kw), 10)
    wp, we, _, _ = beam_scan(w_logp, w_lengths, -12.0, **kw)
    w_slots = torch.arange(width, dtype=torch.int32, device="cuda").expand(1, width).contiguous()
    window_walk = lambda: beam_backtrace(wp, we, w_slots)  # noqa: E731
    window_exact = all(torch.equal(a, b) for a, b in zip(window_walk(), beam_backtrace_reference(wp, we, w_slots)))
    window_walk_ms = flushed_kernel_ms(window_walk, ("beam_backtrace",))
    emit({"phase": "beam_predict_long", "seconds": 60, "windows": windows, "beam_launches": long_counts,
          "ms_host_clock": long_ms, "chars": len(long_text), "equal_to_plain": long_text == long_plain,
          "scan_ms_per_window": window_scan_ms, "window_frames": w_logits.shape[1],
          "backtrace_flushed_ms_per_window": window_walk_ms, "backtrace_window_exact": window_exact,
          "backtrace_window_plan": backtrace_plan(width, width, w_logits.shape[1]), "card": card})
    check(window_exact, "the window's backtrace of every slot differs from its plain version")
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

    # past the state that fits in shared memory (the workspace plan) at W = 3,000, and past one frame of pointers in
    # the backtrace's 48 KB at W = 7,000: both kernels against their plain versions on the check's inputs, exactly,
    # every slot's path walked, and timed
    wide = {}
    for seed, b, t, v, w in ((10, 2, 10, 29, 3000), (11, 1, 20, 5, 7000)):
        w_logits, w_lens = beam_case(seed, b, t, v, "cuda")
        w_logp = torch.log_softmax(w_logits, dim=-1).contiguous()
        w_kw = dict(blank=0, beam_width=w, k_tokens=v)
        w_scan = lambda: beam_scan(w_logp, w_lens, -12.0, **w_kw)  # noqa: E731
        w_plain = lambda: beam_scan_reference(w_logp, w_lens, -12.0, **w_kw)  # noqa: E731
        (wp1, we1, wt1, ws1), (wp0, we0, wt0, ws0) = w_scan(), w_plain()
        slots = torch.argsort(-wt0, dim=1, stable=True).to(torch.int32)
        w_walk = lambda: beam_backtrace(wp0, we0, slots)  # noqa: E731
        w_walk_plain = lambda: beam_backtrace_reference(wp0, we0, slots)  # noqa: E731
        (wk1, wo1), (wk0, wo0) = w_walk(), w_walk_plain()
        w_finite = torch.isfinite(wt0)
        w_err = (wt1[w_finite] - wt0[w_finite]).abs().max().item()
        w_exact = (torch.equal(wp1, wp0) and torch.equal(we1, we0) and torch.equal(w_finite, torch.isfinite(wt1))
                   and all(torch.equal(a, b) for a, b in zip(ws1[2:], ws0[2:])) and torch.equal(wk1, wk0)
                   and torch.equal(wo1, wo0))
        wide[w] = {"B": b, "T": t, "V": v, "K": v, "W": w, "plan": scan_plan(w, v), "scan_ms": cuda_ms(w_scan, 2),
                   "scan_plain_ms": cuda_ms(w_plain, 1), "backtrace_ms": cuda_ms(w_walk, 10),
                   "backtrace_plain_ms": cuda_ms(w_walk_plain, 2), "paths": int(slots.numel()),
                   "live_slots": int(w_finite.sum().item()), "exact": w_exact, "max_abs_err": w_err}
        emit({"phase": "beam_wide", **wide[w], "card": card})
        check(w_exact and w_err <= total_tol, f"the beam kernels at W = {w} differ from the plain versions "
                                              f"(exact {w_exact}, total {w_err})")
    source, pallas = "thunder_tpu_torch/csrc/beam_search.cu", "thunder_tpu/kernels/beam_pallas.py"
    shape = f"B={batch}, T={frames}, V=K={vocab}, W={width}"
    return [
        {"name": "beam_scan", "route": "cuda", "source": source, "replaces": f"{pallas}:214",
         "launches": counts["beam_scan"], "max_abs_err": scan_err, "ms": scan_ms, "plain_ms": scan_plain_ms,
         "ms_is": f"one launch at the forward's logits, {shape}", **beam_scan_bound(batch, frames, vocab, width),
         "chunked_ms": c_ms, "chunked_plain_ms": c_plain_ms, "chunked_is": "B=16, T=188, V=K=3000, W=16",
         "workspace_ms": wide[3000]["scan_ms"], "workspace_plain_ms": wide[3000]["scan_plain_ms"],
         "workspace_is": "B=2, T=10, V=K=29, W=3000",
         "library_ms": None, "library": "none (no single PyTorch call computes a prefix beam search)"},
        {"name": "beam_backtrace", "route": "cuda", "source": source, "replaces": f"{pallas}:374",
         "launches": counts["beam_backtrace"], "max_abs_err": 0.0, "ms": walk_ms, "plain_ms": walk_plain_ms,
         "ms_is": f"one launch, one path a row, {shape}: device time a call with the pointers in device memory "
                  "(copies in turns, over 100 MB, the card held while the host queues); flushed_ms: the kernel's "
                  "duration by the profiler, the L2 flushed before each call; host_paced_ms: back-to-back calls",
         "flushed_ms": walk_flushed_ms, "host_paced_ms": walk_host_ms, **beam_backtrace_bound(p1, slots0),
         "bound_is": "the 32-byte sectors of both pointer fields that this run's walk reads, the start slots, the "
                     "tokens and origins; staging_ms: both fields read whole",
         **backtrace_chain_floor(frames), "window_flushed_ms": window_walk_ms,
         "window_is": f"one predict_long window, B=1, T={wp.shape[1]}, W={width}, every slot's path",
         "window_bound_ms": beam_backtrace_bound(wp, w_slots)["bound_ms"],
         "walk_ms": wide[7000]["backtrace_ms"], "walk_plain_ms": wide[7000]["backtrace_plain_ms"],
         "walk_is": "B=1, T=20, W=7000, every slot's path, its loads from device memory",
         "library_ms": None, "library": "none (no single PyTorch call walks beam pointers)"},
    ]


def citrinet_create(device, dtype=None, vocab=CITRINET_VOCAB, train_config: bool = False, dropout: float = 0.0):
    """Citrinet-256 (the published widths, 21 blocks, random weights from generator seed 0) with an 80-mel
    frontend and a ``Conv1dDecoder`` over ``vocab`` and the blank; ``train_config`` adds SpecAugment's 2 + 2
    masks and the default dither (``bench_train.py --model citrinet``)."""
    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.models import CitrinetEncoder, Conv1dDecoder
    from thunder_tpu_torch.models.citrinet import CITRINET_256_FILTERS, CITRINET_256_KERNELS, CITRINET_256_STRIDES
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    dtype = dtype or torch.float32
    frontend = (FilterbankFeatures(nfilt=80, num_time_masks=2, num_freq_masks=2) if train_config
                else FilterbankFeatures(nfilt=80, dither=0.0))
    encoder = CitrinetEncoder(CITRINET_256_FILTERS, CITRINET_256_KERNELS, CITRINET_256_STRIDES, feat_in=80,
                              dropout=dropout, dtype=dtype)
    return CTCModule.create(torch.Generator().manual_seed(0), frontend, encoder,
                            Conv1dDecoder(len(vocab) + 1, dtype=dtype), BatchTextTransformer(vocab), device=device)


@contextlib.contextmanager
def plain_conv_serving():
    """Route the conv engine's log-mel and separable repeats through their plain versions, on the same device."""
    import thunder_tpu_torch.audio.frontend as frontend
    import thunder_tpu_torch.engine as engine
    from thunder_tpu_torch.kernels.frontend import log_mel_reference
    from thunder_tpu_torch.kernels.separable_conv import separable_repeat_reference

    saved = frontend.fused_log_mel, engine.fused_separable_repeat
    frontend.fused_log_mel, engine.fused_separable_repeat = log_mel_reference, separable_repeat_reference
    try:
        yield
    finally:
        frontend.fused_log_mel, engine.fused_separable_repeat = saved


@contextlib.contextmanager
def recorded_forwards(engine):
    """Record every ``engine.infer`` call's ``(logits, argmax ids, out_lengths)`` in the list it yields."""
    calls, infer = [], engine.infer

    def recording(padded, lengths):
        calls.append(infer(padded, lengths))
        return calls[-1]

    engine.infer = recording
    try:
        yield calls
    finally:
        del engine.infer


def citrinet_serving_phase(card: str) -> tuple:
    """Citrinet-256 greedy serving at BATCH x SECONDS (phase 12 of the module docstring), then the log-mel and
    every separable shape of the plan against their plain versions. Returns the engine, the batch, the launch
    counts of one predict and, by kernel, the deviations and timed shapes for the kernels line."""
    import torch

    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_reference
    from thunder_tpu_torch.kernels.selftest import KERNEL_CHECKS

    rng = np.random.default_rng(0)
    samples = int(SECONDS * SAMPLE_RATE)
    base = speech_like(samples, rng)
    audio = np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(BATCH)])
    lengths = np.full((BATCH,), samples, dtype=np.int32)
    module = citrinet_create("cuda")
    fit_bn(module, audio[:8], lengths[:8])
    engine = InferenceEngine(module)
    engine.warmup([BATCH], [SECONDS])

    reset_launch_counts()
    texts = engine.predict(audio, lengths)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    emit({"phase": "citrinet_launches_per_forward", **counts})
    want = expected_counts(fused_log_mel=1, fused_separable_repeat=CITRINET_SEPARABLE)
    check(counts == want, f"one Citrinet predict must launch {want}, got {counts}")
    check(len(texts) == BATCH and all(isinstance(t, str) and set(t) <= set(CITRINET_VOCAB) for t in texts),
          f"Citrinet transcripts outside the vocabulary: {texts[:4]}")

    audio_d, lengths_d = torch.as_tensor(audio, device="cuda"), torch.as_tensor(lengths, device="cuda")
    logits, _, out_lengths = engine.infer(audio_d, lengths_d)
    frames = (int(SECONDS * SAMPLE_RATE) // 160 + 1 + 7) // 8  # 1501 -> 751 -> 376 -> 188
    check(bool(torch.isfinite(logits).all()) and logits.shape == (BATCH, frames, len(CITRINET_VOCAB) + 1),
          f"Citrinet logits not finite or of shape {tuple(logits.shape)}")
    forward_ms = cuda_ms(lambda: engine.infer(audio_d, lengths_d), CITRINET_TIMED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.predict(audio, lengths)
    predict_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "citrinet_serving", "batch": BATCH, "seconds": SECONDS, "frames": frames, "forward_ms": forward_ms,
          "rtf": BATCH * SECONDS / (forward_ms / 1e3), "predict_ms_host_clock": predict_ms,
          "transcript_chars": [min(map(len, texts)), max(map(len, texts))],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})
    emit({"phase": "citrinet_profile", **device_profile(lambda: engine.infer(audio_d, lengths_d))})
    logits_vs_cpu_f32("citrinet_vs_cpu_f32", module, logits, out_lengths, audio, lengths)

    # the log-mel kernel against its plain version on this batch, at 80 mels
    fe = engine.frontend
    mel_kw = dict(sample_rate=fe.sample_rate, n_fft=fe.fft_size, hop_length=fe.n_window_stride,
                  win_length=fe.n_window_size, n_mels=fe.nfilt, preemph=fe.preemph)
    mel_err = (fused_log_mel(audio_d, **mel_kw) - log_mel_reference(audio_d, **mel_kw)).abs().max().item()
    mel_tol = KERNEL_CHECKS["frontend_log_mel"][1]
    emit({"phase": "citrinet_log_mel", "batch": BATCH, "seconds": SECONDS, **mel_kw, "max_abs_err": mel_err,
          "tol": mel_tol})
    check(mel_err <= mel_tol, f"log-mel at Citrinet's 80 mels off by {mel_err} > {mel_tol}")

    # every separable shape of the plan against its plain version; timed beside it and the chain: the
    # 80-channel stem, a stride-2 last repeat at T 1501 (no ReLU), a k 39 repeat at T 188 and the 640-channel tail
    shapes = separable_shapes(engine, audio_d, lengths_d)
    check(sum(count for _, count in shapes.values()) == CITRINET_SEPARABLE, f"Citrinet plan shapes {list(shapes)}")
    wanted = [(1501, 80, 256, 5, 1, 1), (1501, 256, 256, 11, 2, 1), (188, 256, 256, 39, 1, 1),
              (188, 256, 640, 41, 1, 1)]
    gen = torch.Generator(device="cuda").manual_seed(3)
    timed, errors = [], {}
    for key in wanted:
        check(key in shapes, f"no Citrinet repeat of shape {key}: {list(shapes)}")
        line = time_separable_shape("citrinet_separable_shape", key, *shapes[key], gen)
        line.pop("work")
        timed.append(line)
        errors[key] = line["max_abs_err"], line["ulp"]
    for key, (rp, _) in shapes.items():
        if key not in errors:
            errors[key] = separable_shape_error(key, rp, gen)[:2]
    worst = max(errors, key=lambda key: errors[key][1])
    emit({"phase": "citrinet_separable_checked", "shapes": len(errors), "launches": CITRINET_SEPARABLE,
          "max_abs_err": max(e for e, _ in errors.values()), "max_ulp": errors[worst][1], "worst": list(worst),
          "ulp_by_shape": [[*key, ulp] for key, (_, ulp) in errors.items()]})
    check(errors[worst][1] <= 8.0, f"separable repeat at Citrinet's {worst} off by {errors[worst][1]} bf16 ULP")
    deviations = {"log_mel": {"citrinet_max_abs_err": mel_err},
                  "separable_repeat": {"citrinet_shapes": timed, "citrinet_shapes_checked": len(errors),
                                       "citrinet_max_abs_err": max(e for e, _ in errors.values()),
                                       "citrinet_max_ulp": errors[worst][1]}}
    return engine, audio, lengths, counts, deviations


def citrinet_beam_phase(card: str, engine, audio: np.ndarray, lengths: np.ndarray) -> dict:
    """The device beam on the Citrinet-256 engine (phase 13 of the module docstring): K = 50 and every token a
    step, then ``predict_long`` greedy and beam. Returns the launch counts of one beam predict and of each
    ``predict_long`` run."""
    import torch

    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device

    width, blank = 16, engine.module.blank_idx
    audio_d, lengths_d = torch.as_tensor(audio, device="cuda"), torch.as_tensor(lengths, device="cuda")
    logits, _, out_lengths = engine.infer(audio_d, lengths_d)
    counts = {}
    for k in (50, None):
        beam = dict(beam_width=width, beam_backend="device", max_tokens_per_step=k)
        engine.predict(audio, lengths, **beam)  # warms the beam path
        reset_launch_counts()
        texts = engine.predict(audio, lengths, **beam)
        torch.cuda.synchronize()
        counts[k] = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
        want = expected_counts(fused_log_mel=1, fused_separable_repeat=CITRINET_SEPARABLE, beam_scan=1,
                               beam_backtrace=1)
        check(counts[k] == want, f"one Citrinet beam predict (K = {k}) must launch {want}, got {counts[k]}")
        with plain_beam():
            plain_texts = engine.predict(audio, lengths, **beam)
        agree = sum(a == b for a, b in zip(texts, plain_texts))
        decode = lambda: beam_search_device(logits, out_lengths, blank=blank, beam_width=width,  # noqa: E731
                                            max_tokens_per_step=k)
        decode_ms = cuda_ms(decode, 3)
        with plain_beam():
            decode_plain_ms = cuda_ms(decode, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict(audio, lengths, **beam)
        emit({"phase": "citrinet_beam", "B": BATCH, "T": logits.shape[1], "V": logits.shape[2],
              "K": logits.shape[2] if k is None else k, "W": width, "launches": counts[k], "rows": BATCH,
              "equal_rows": agree, "decode_ms": decode_ms, "decode_plain_ms": decode_plain_ms,
              "predict_ms_host_clock": (time.perf_counter() - t0) * 1e3, "card": card})
        check(len(texts) == BATCH and all(set(t) <= set(CITRINET_VOCAB) for t in texts),
              f"Citrinet beam transcripts outside the vocabulary: {texts[:4]}")
        check(agree == BATCH, f"Citrinet beam (K = {k}) differs from the plain versions on {BATCH - agree} rows")

    # long audio at the 8x frame stride: 1 log-mel + 107 separable a window, and one launch of each beam kernel a
    # window with the beam; greedy, each window's logits against the same window's through the plain log-mel and
    # separable repeat, within LOGIT_BOUND of their scale over its valid frames; beam, the text of the plain
    # beam kernels on the same logits
    clip = speech_like(60 * SAMPLE_RATE, np.random.default_rng(2))
    chunk, overlap = 20 * SAMPLE_RATE, 2 * SAMPLE_RATE
    windows = len(range(0, max(clip.shape[0] - overlap, 1), chunk - overlap))
    long = {}
    for name, beam in (("greedy", {}), ("beam", dict(beam_width=width, beam_backend="device"))):
        reset_launch_counts()
        t0 = time.perf_counter()
        with recorded_forwards(engine) as forwards:
            text = engine.predict_long(clip, **beam)
        long_ms = (time.perf_counter() - t0) * 1e3
        long[name] = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
        with plain_beam() if beam else plain_conv_serving(), recorded_forwards(engine) as plain_forwards:
            plain = engine.predict_long(clip, **beam)
        per_window = dict(fused_log_mel=windows, fused_separable_repeat=windows * CITRINET_SEPARABLE)
        if beam:
            per_window.update(beam_scan=windows, beam_backtrace=windows)
        line = {"phase": "citrinet_predict_long", "decode": name, "seconds": 60, "windows": windows,
                "launches": long[name], "ms_host_clock": long_ms, "chars": len(text), "equal_to_plain": text == plain}
        if not beam:
            check(len(forwards) == len(plain_forwards) == windows, f"Citrinet predict_long ran {len(forwards)} and "
                                                                   f"{len(plain_forwards)} forwards, not {windows}")
            rels = []
            for (got, _, got_len), (want, _, want_len) in zip(forwards, plain_forwards):
                check(torch.equal(got_len, want_len), f"window lengths {got_len} vs the plain versions' {want_len}")
                valid = torch.arange(got.shape[1], device=got.device)[None, :] < want_len[:, None]
                rels.append(((got.float() - want.float()).abs()[valid].max() / want.float().abs()[valid].max()).item())
            line.update(window_max_rel_dev=rels, bound=LOGIT_BOUND)
        emit({**line, "card": card})
        check(long[name] == expected_counts(**per_window), f"Citrinet predict_long ({name}) over {windows} windows "
                                                           f"launched {long[name]}")
        check(len(text) > 0 and set(text) <= set(CITRINET_VOCAB), f"Citrinet predict_long ({name}) text {text[:20]!r}")
        if beam:  # the same forward's logits: the search is exact
            check(text == plain, "Citrinet predict_long's beam text differs from the plain versions'")
        else:
            check(max(rels) < LOGIT_BOUND, f"Citrinet predict_long's window logits off the plain versions' by "
                                           f"{max(rels)} >= {LOGIT_BOUND} of their scale")
    return {"beam_k50": counts[50], "beam_all_tokens": counts[None], "long_greedy": long["greedy"],
            "long_beam": long["beam"]}


def citrinet_training_phase(card: str, ctc_tol: float) -> tuple:
    """Train Citrinet-256 at TRAIN_BATCH x TRAIN_SECONDS (phase 14 of the module docstring; ``bench_train.py
    --model citrinet``: SpecAugment 2 + 2 masks, dither, dropout 0.1, bf16 compute, AdamW lr 1e-4, the 29-token
    character vocabulary), then the CTC pair against its plain version at the step's shape. Returns the launch
    counts of one step and the pair's deviation for the kernels line."""
    def create(device, dtype, train_config: bool):
        return citrinet_create(device, dtype, VOCAB, train_config, dropout=0.1 if train_config else 0.0)

    counts, batch = train_path(card, "citrinet_", create, CITRINET_LOSS_FALL)
    frames = (int(TRAIN_SECONDS * SAMPLE_RATE) // 160 + 1 + 7) // 8  # 1501 -> 751 -> 376 -> 188
    pair = ctc_pair_check(frames, batch[2], batch[3], seed=4)
    emit({"phase": "citrinet_ctc_training_shape", "T": frames, "B": TRAIN_BATCH, "S": int(pair["lp_z"].shape[2]),
          "loss_delta": pair["loss_delta"], "grad_rel_delta": pair["grad_rel"], "max_abs_err": pair["max_abs_err"],
          "tol": ctc_tol, "card": card})
    worst = max(pair["loss_delta"], pair["grad_rel"])
    check(worst <= ctc_tol, f"CTC pair at Citrinet's training shape off by {worst} > {ctc_tol}")
    return counts, {"ctc_recursion": {"citrinet_max_abs_err": pair["max_abs_err"], "citrinet_T": frames}}


def citrinet_cpu_loss_fall(batch: int, seconds: float) -> dict:
    """The Citrinet training phase's losses on the port's float32 CPU path (plain versions of every kernel) at
    ``batch`` x ``seconds``, from which ``CITRINET_LOSS_FALL`` is set; needs no card:
    ``python3 -c "import chip_smoke; print(chip_smoke.citrinet_cpu_loss_fall(2, 6.0))"``."""
    import torch

    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.optim import adamw
    from thunder_tpu_torch.training.trainer import TrainStep, _encode_targets

    module = citrinet_create("cpu", torch.float32, VOCAB, train_config=True, dropout=0.1)
    samples = int(seconds * SAMPLE_RATE)
    audio = torch.as_tensor((np.random.default_rng(0).standard_normal((batch, samples)) * 0.1).astype(np.float32))
    lengths = torch.full((batch,), samples, dtype=torch.int32)
    targets, target_lengths = _encode_targets(BatchTextTransformer(VOCAB), [TRAIN_TEXT] * batch)
    step = TrainStep(module.model, adamw(module.model.parameters(), learning_rate=1e-4), module.blank_idx)
    generator = torch.Generator().manual_seed(0)
    losses = [step(audio, lengths, torch.as_tensor(targets), torch.as_tensor(target_lengths), generator).item()
              for _ in range(1 + TRAIN_WARMUP + TRAIN_TIMED)]
    return {"batch": batch, "seconds": seconds, "losses": losses, "last_over_first": losses[-1] / losses[0]}


def add_citrinet_launches(kernels: list, serving: dict, beam: dict, training: dict) -> None:
    """Each kernel's launches on the Citrinet paths (0 for those they do not reach), beside its entry's
    ``launches`` on its own main path."""
    runs = {"forward": serving, "beam_predict_k50": beam["beam_k50"],
            "beam_predict_all_tokens": beam["beam_all_tokens"], "predict_long_greedy": beam["long_greedy"],
            "predict_long_beam": beam["long_beam"], "train_step": training}
    for entry in kernels:
        entry["citrinet_launches"] = {run: sum(c[w] for w in ENTRY_WRAPPERS[entry["name"]]) for run, c in runs.items()}


def add_mode_launches(kernels: list, int8_launches: dict, mode_launches: dict, c16: dict) -> None:
    """Each kernel's launches in the serving-mode phases: the conv models' ``int8_weights`` predicts (log-mel and
    separable repeat), wav2vec2's modes (attention and add + LayerNorm), and the C16 shapes' launches a call."""
    wrappers = {"log_mel": "fused_log_mel", "separable_repeat": "fused_separable_repeat",
                "mha_from_qkv": "mha_from_qkv", "add_layer_norm": "add_layer_norm"}
    for entry in kernels:
        wrapper = wrappers.get(entry["name"])
        if wrapper is None:
            continue
        entry["int8_weights_launches"] = {model: c[wrapper] for model, c in int8_launches.items()}
        entry["w2v2_mode_launches"] = {mode: c[wrapper] for mode, c in mode_launches.items()}
    for entry in kernels:
        if entry["name"] == "separable_repeat":
            entry["c16"] = {k: c16["separable"][k] for k in ("k", "dilation", "C", "launches", "ulp", "ms", "plain_ms",
                                                             "bound_ms")}
        elif entry["name"] == "log_mel":
            entry["c16"] = {name: {k: v[k] for k in ("batch", "launches", "ms", "check_max_abs_err")}
                            for name, v in c16["log_mel"].items()}


# ---- the engine's serving modes (phases 15-19)

#: the wav2vec2 engine's modes: name -> InferenceEngine keywords
W2V_MODES = {
    "float": {},
    "posconv_dense": dict(posconv_dense=True),
    "int8_weights": dict(int8_weights=True),
    "int8_compute": dict(int8_compute=True),
    "int8_both": dict(int8_weights=True, int8_compute=True),
}
INT8_MODE_FOR_LONG_CLIP = "int8_both"
#: the fold's output and its input and weight gradients against the same conv in float32 on the same bf16 values
#: (max |difference| / max |float32|): bf16 products, float32 sums over 128 x 48 terms (grouped) or 128 x 768
#: (dense, 720 of them zeros), outputs rounded to bf16; against the grouped conv's, that bound plus the grouped
#: conv's own distance from float32
FOLD_GRAD_BOUND = 0.02
INT8_TOPS_PER_MS = 1979e9  # dense int8 tensor-core operations


def int8_bound(n_bytes: float, int8_ops: float) -> dict:
    """``bound`` for an int8 product: its bytes over the memory rate, its int8 operations over the int8 peak."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_MS, int8_ops / INT8_TOPS_PER_MS
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


@contextlib.contextmanager
def plain_int8():
    """Route the int8 products (``quantization.int8_mm``) through their plain version, on the same device."""
    from thunder_tpu_torch import quantization

    saved = quantization.int8_mm
    quantization.int8_mm = quantization.int8_mm_reference
    try:
        yield
    finally:
        quantization.int8_mm = saved


def wav2vec2_modes_phase(card: str) -> dict:
    """wav2vec2-base at W2V_BATCH x W2V_SECONDS in each of ``W2V_MODES`` (phase 15 of the module docstring): per
    mode the launches of one predict (the serving kernels, 12 + 25) and its int8 products, forward ms (CUDA
    events, mean of 5, the modes timed in turns), ``weight_bytes`` and, but for float mode (phase 8 holds it),
    rows 0-1 against the same mode in float32 on the CPU; then a 40 s predict in ``INT8_MODE_FOR_LONG_CLIP``
    against the same predict through the plain versions. Returns each mode's launch counts, for the kernels
    line."""
    import torch

    from thunder_tpu_torch import quantization
    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    tt = BatchTextTransformer(W2V_VOCAB)
    module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                              Wav2Vec2Encoder(Wav2Vec2Config()), LinearDecoder(tt.num_tokens), tt, device="cuda")
    cfg = module.model.encoder.config
    rng = np.random.default_rng(1)  # phase 8's batch
    samples = int(W2V_SECONDS * SAMPLE_RATE)
    base = speech_like(samples, rng)
    audio = np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(W2V_BATCH)])
    lengths = np.full((W2V_BATCH,), samples, dtype=np.int32)
    audio_d, lengths_d = torch.as_tensor(audio, device="cuda"), torch.as_tensor(lengths, device="cuda")
    layers = cfg.num_hidden_layers
    want = expected_counts(mha_from_qkv=layers, add_layer_norm=2 * layers + 1)
    engines, counts, lines = {}, {}, {}
    for name, modes in W2V_MODES.items():
        t0 = time.perf_counter()
        engine = engines[name] = InferenceEngine(module, **modes)
        create_s = time.perf_counter() - t0
        engine.warmup([W2V_BATCH], [W2V_SECONDS])
        reset_launch_counts()
        products = quantization.int8_mm.launches
        texts = engine.predict(audio, lengths)
        torch.cuda.synchronize()
        counts[name] = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
        int8_products = quantization.int8_mm.launches - products
        want_products = 4 * layers + sum(d >= 64 for d in cfg.conv_dim[:-1]) if modes.get("int8_compute") else 0
        check(counts[name] == want, f"one wav2vec2 predict in mode {name} must launch {want}, got {counts[name]}")
        check(int8_products == want_products,
              f"mode {name}: {int8_products} int8 products a predict, expected {want_products}")
        check(len(texts) == W2V_BATCH and all(set(t) <= set(W2V_VOCAB) for t in texts),
              f"mode {name}: transcripts outside the vocabulary")
        logits, _, out_lengths = engine.infer(audio_d, lengths_d)
        check(bool(torch.isfinite(logits).all()), f"mode {name}: logits not finite")
        lines[name] = {"weight_bytes": engine.weight_bytes(), "int8_products_per_forward": int8_products,
                       "create_s": create_s}
        if name != "float":
            lines[name]["vs_cpu_f32"] = logits_vs_cpu_f32(f"w2v2_mode_{name}_vs_cpu_f32", module, logits,
                                                          out_lengths, audio, lengths, **modes)
    # forward ms, the modes in turns (all once, then again, ...), so that drift falls on each
    runs = spread_ms({name: (lambda e=engine: e.infer(audio_d, lengths_d)) for name, engine in engines.items()}, 3)
    for name in W2V_MODES:
        lines[name].update(forward_ms=runs[name]["median"], forward_ms_runs=runs[name]["runs"])
        emit({"phase": "w2v2_serving_mode", "mode": name, "batch": W2V_BATCH, "seconds": W2V_SECONDS,
              "launches": {k: v for k, v in counts[name].items() if v}, **lines[name], "card": card})
    emit({"phase": "w2v2_mode_profile", "mode": INT8_MODE_FOR_LONG_CLIP,
          **device_profile(lambda: engines[INT8_MODE_FOR_LONG_CLIP].infer(audio_d, lengths_d))})
    emit({"phase": "w2v2_mode_profile", "mode": "posconv_dense",
          **device_profile(lambda: engines["posconv_dense"].infer(audio_d, lengths_d))})

    # a 40 s clip (T = 1999) in an int8 mode, against the same predict through the plain versions
    engine = engines[INT8_MODE_FOR_LONG_CLIP]
    clip = speech_like(LONG_CLIP_SECONDS * SAMPLE_RATE, np.random.default_rng(3))
    clip_args = (clip[None], np.array([clip.shape[0]], np.int32))
    reset_launch_counts()
    clip_text = engine.predict(clip)[0]
    torch.cuda.synchronize()
    clip_counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    clip_logits, _, clip_lengths = engine.infer(*clip_args)
    with plain_wav2vec2(), plain_int8():
        plain_logits, _, _ = engine.infer(*clip_args)
        clip_plain = engine.predict(clip)[0]
    rel = ((clip_logits - plain_logits).abs().max() / plain_logits.abs().max()).item()
    emit({"phase": "w2v2_mode_predict_40s", "mode": INT8_MODE_FOR_LONG_CLIP, "frames": int(clip_lengths[0]),
          "launches": {k: v for k, v in clip_counts.items() if v}, "equal_to_plain": clip_text == clip_plain,
          "logits_max_rel_dev_vs_plain": rel, "chars": len(clip_text)})
    check(clip_counts == want, f"the 40 s predict in {INT8_MODE_FOR_LONG_CLIP} must launch {want}, got {clip_counts}")
    check(clip_text == clip_plain and rel < LOGIT_BOUND,
          f"the 40 s int8 predict differs from the plain versions': text equal {clip_text == clip_plain}, {rel}")
    counts["predict_40s_" + INT8_MODE_FOR_LONG_CLIP] = clip_counts
    return counts


def conv_taps_int8(x, kernel_q8, kernel_scale, stride: int):
    """``dynamic_int8_conv`` as a sum over the taps of one int8 product each on the strided rows of the input
    (the alternative to the port's im2col, timed here only)."""
    import torch

    from thunder_tpu_torch.quantization import _quantize_rows, int8_mm

    batch, t_in, c_in = x.shape
    taps = kernel_q8.shape[0]
    t_out = (t_in - taps) // stride + 1
    xq, s = _quantize_rows(x, (1, 2))
    acc = None
    for j in range(taps):
        rows = xq[:, j: j + stride * (t_out - 1) + 1: stride].reshape(batch * t_out, c_in)
        part = int8_mm(rows, kernel_q8[j])
        acc = part if acc is None else acc.add_(part)
    return acc.float().reshape(batch, t_out, -1) * s * kernel_scale


def int8_products_phase(card: str) -> dict:
    """The int8 products at wav2vec2-base's serving shapes (phase 16 of the module docstring): the four GEMM kinds
    at 16 x 749 rows and extractor convs 1-6 at 16 x 15 s, each through ``torch._int_mm`` against its plain
    version (the float64 product) on the same card inputs, exactly; its time beside the bf16 product it replaces
    and its bound. For the convs also the sum over taps (``conv_taps_int8``), the formulation the port does not
    take, and which is faster."""
    import torch

    from thunder_tpu_torch import quantization
    from thunder_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from thunder_tpu_torch.ops.conv import conv1d

    cfg = Wav2Vec2Config()
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = W2V_BATCH * 749
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    lines = []

    def weights(shape):  # int8 in the layout the engine keeps (column-major), its scale, and the bf16 weight
        w = torch.randn(shape, device="cuda", generator=gen) * 0.05
        q, scale = quantization.quantize_array(w)
        q = quantization.column_major(torch.as_tensor(q, device="cuda"))
        return q, torch.as_tensor(scale.reshape(-1), device="cuda"), w.to(torch.bfloat16)

    for name, k, n in (("qkv_proj", h, 3 * h), ("out_proj", h, h), ("intermediate_dense", h, ffn),
                       ("output_dense", ffn, h)):
        x = torch.randn((rows, k), device="cuda", generator=gen).to(torch.bfloat16)
        q, scale, w = weights((k, n))
        got = quantization.dynamic_int8_matmul(x, q, scale)
        with plain_int8():
            want = quantization.dynamic_int8_matmul(x, q, scale)
        dev = (got - want).abs().max().item()
        ms, bf16_ms = paired_ms(lambda: quantization.dynamic_int8_matmul(x, q, scale), lambda: torch.matmul(x, w), 20)
        xq = torch.randint(-127, 128, (rows, k), generator=gen, device="cuda", dtype=torch.int8)
        int_mm_ms = cuda_ms(lambda: torch._int_mm(xq, q), 20)
        q_rows = q.contiguous()  # row-major: the layout the card takes slower
        int_mm_row_major_ms = cuda_ms(lambda: torch._int_mm(xq, q_rows), 20)
        lines.append({"product": name, "M": rows, "K": k, "N": n, "max_abs_dev_vs_plain": dev, "bound_dev": 0.0,
                      "ms": ms, "int_mm_ms": int_mm_ms, "int_mm_row_major_weight_ms": int_mm_row_major_ms,
                      "bf16_matmul_ms": bf16_ms,
                      **int8_bound(2 * rows * k + k * n + 4 * n + 4 * rows * n, 2.0 * rows * k * n)})
    t = int(W2V_SECONDS * SAMPLE_RATE)
    t = (t - cfg.conv_kernel[0]) // cfg.conv_stride[0] + 1
    for i, (c_in, c_out, k, stride) in enumerate(zip(cfg.conv_dim[:-1], cfg.conv_dim[1:], cfg.conv_kernel[1:],
                                                     cfg.conv_stride[1:]), start=1):
        t_out = (t - k) // stride + 1
        x = torch.randn((W2V_BATCH, t, c_in), device="cuda", generator=gen).to(torch.bfloat16)
        q, scale, w = weights((k, c_in, c_out))
        got = quantization.dynamic_int8_conv(x, q, scale, stride)
        taps = conv_taps_int8(x, q, scale, stride)
        with plain_int8():
            want = quantization.dynamic_int8_conv(x, q, scale, stride)
        dev = max((got - want).abs().max().item(), (taps - want).abs().max().item())
        ms, bf16_ms = paired_ms(lambda: quantization.dynamic_int8_conv(x, q, scale, stride),
                                lambda: conv1d(x, w, stride=stride), 10)
        taps_ms, _ = paired_ms(lambda: conv_taps_int8(x, q, scale, stride), lambda: conv1d(x, w, stride=stride), 10)
        lines.append({"product": f"extractor_conv{i}", "B": W2V_BATCH, "T_in": t, "T_out": t_out, "k": k,
                      "stride": stride, "C_in": c_in, "C_out": c_out, "max_abs_dev_vs_plain": dev, "bound_dev": 0.0,
                      "ms": ms, "taps_ms": taps_ms, "bf16_conv_ms": bf16_ms,
                      **int8_bound(2 * W2V_BATCH * t * c_in + k * c_in * c_out + 4 * c_out
                                   + 4 * W2V_BATCH * t_out * c_out, 2.0 * W2V_BATCH * t_out * k * c_in * c_out)})
        t = t_out
    line = {"phase": "int8_products", "route": "torch._int_mm (cuBLASLt int8 GEMM, int32 sums) after the float32 "
                                                "quantize passes; not a kernel of this repository",
            "plain": "the same quantize passes, then the float64 product (exact)", "products": lines,
            "im2col_faster_than_taps": sum(p["ms"] for p in lines if "taps_ms" in p)
                                       <= sum(p["taps_ms"] for p in lines if "taps_ms" in p), "card": card}
    emit(line)
    worst = max(p["max_abs_dev_vs_plain"] for p in lines)
    check(worst == 0.0, f"an int8 product differs from its plain version by {worst}")
    return line


def conv_int8_phase(card: str, name: str, engine, module, audio: np.ndarray, lengths: np.ndarray,
                    separable: int) -> dict:
    """A conv model's ``int8_weights`` engine beside its float engine ``engine`` on the same module (phase 17 of
    the module docstring): one predict's launches (1 log-mel and ``separable`` separable repeats), forward ms of
    both in turns, ``weight_bytes`` of both, rows 0-1 against the same int8 engine in float32 on the CPU. Returns
    the launch counts."""
    import torch

    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts

    q8 = InferenceEngine(module, int8_weights=True)
    q8.warmup([BATCH], [SECONDS])
    reset_launch_counts()
    texts = q8.predict(audio, lengths)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    want = expected_counts(fused_log_mel=1, fused_separable_repeat=separable)
    check(counts == want, f"one {name} int8_weights predict must launch {want}, got {counts}")
    check(len(texts) == BATCH, f"{name} int8: {len(texts)} transcripts")
    audio_d, lengths_d = torch.as_tensor(audio, device="cuda"), torch.as_tensor(lengths, device="cuda")
    logits, _, out_lengths = q8.infer(audio_d, lengths_d)
    check(bool(torch.isfinite(logits).all()), f"{name} int8 logits not finite")
    runs = spread_ms({"float": lambda: engine.infer(audio_d, lengths_d), "int8_weights": lambda: q8.infer(audio_d,
                                                                                                        lengths_d)}, 10)
    line = {"phase": "conv_int8_serving", "model": name, "batch": BATCH, "seconds": SECONDS,
            "forward_ms": runs["int8_weights"]["median"], "float_forward_ms": runs["float"]["median"],
            "forward_ms_runs": runs["int8_weights"]["runs"], "float_forward_ms_runs": runs["float"]["runs"],
            "weight_bytes": q8.weight_bytes(), "float_weight_bytes": engine.weight_bytes(),
            "launches": {k: v for k, v in counts.items() if v}, "card": card}
    line["weight_bytes_ratio"] = line["weight_bytes"] / line["float_weight_bytes"]
    emit(line)
    logits_vs_cpu_f32(f"{name}_int8_vs_cpu_f32", module, logits, out_lengths, audio, lengths, int8_weights=True)
    return counts


def pos_conv_fold_phase(card: str) -> dict:
    """The wav2vec2 positional conv (k 128, 768 channels, 16 groups) at the train step's shape, bf16 (8, 749,
    768) from a float32 parameter, as the step runs it: the grouped conv forward, and forward + backward (input
    and weight gradients); its block-diagonal dense fold built from the grouped parameter inside the graph,
    forward, and forward + backward (the weight gradient reaches the grouped parameter as the diagonal blocks);
    both against the grouped conv in float32 on the same bf16 values, the fold within ``FOLD_GRAD_BOUND`` of
    it, and of the grouped conv within that plus the grouped conv's own deviation; each timed with CUDA events
    and its kernels named by the profiler. Then the serving shape (16, 749), forward only, both ways. Timing only:
    the training path does not change (phase 18 of the module docstring)."""
    import torch

    from thunder_tpu_torch.kernels.compare_builds import device_ms_by_kernel
    from thunder_tpu_torch.ops.conv import conv1d

    taps, h, groups = 128, 768, 16
    gs = h // groups
    gen = torch.Generator(device="cuda").manual_seed(18)
    kernel = (torch.randn((taps, gs, h), device="cuda", generator=gen) * gs ** -0.5 / taps ** 0.5).requires_grad_()
    bias = torch.zeros(h, device="cuda", requires_grad=True)

    def grouped(x):
        return conv1d(x, kernel.to(torch.bfloat16), bias.to(torch.bfloat16), padding=taps // 2, groups=groups)[
            :, : x.shape[1]]

    def folded(x):
        w = kernel.to(torch.bfloat16).reshape(taps, gs, groups, gs)
        eye = torch.eye(groups, device="cuda", dtype=torch.bfloat16)
        dense = torch.einsum("kigj,gh->kgihj", w, eye).reshape(taps, h, h)  # block g: w[:, :, g gs:(g+1) gs]
        return conv1d(x, dense, bias.to(torch.bfloat16), padding=taps // 2)[:, : x.shape[1]]

    out = {}
    for shape_name, batch, train in (("train_step", W2V_TRAIN_BATCH, True), ("serving", W2V_BATCH, False)):
        x = torch.randn((batch, 749, h), device="cuda", generator=gen).to(torch.bfloat16)
        cot = torch.randn((batch, 749, h), device="cuda", generator=gen).to(torch.bfloat16)
        xg = x.clone().requires_grad_(train)
        line = {"B": batch, "T": 749}
        for name, conv in (("grouped", grouped), ("fold", folded)):
            def forward(conv=conv):
                with torch.set_grad_enabled(train):
                    return conv(xg)

            line[f"{name}_forward_ms"] = cuda_ms(forward, 10)
            line[f"{name}_forward_kernels"] = device_ms_by_kernel(forward, 2)
            if train:
                def step(conv=conv):
                    kernel.grad = bias.grad = xg.grad = None
                    conv(xg).backward(cot)

                line[f"{name}_forward_backward_ms"] = cuda_ms(step, 5)
                line[f"{name}_forward_backward_kernels"] = device_ms_by_kernel(step, 1)
                step()
                line[f"{name}_grads"] = (xg.grad.float().clone(), kernel.grad.clone())
        # the same conv in float32 (TF32 off) on the same bf16 input, weights and cotangent
        x32 = x.float().requires_grad_(train)
        k32 = kernel.detach().to(torch.bfloat16).float().requires_grad_(train)
        with torch.set_grad_enabled(train):
            y32 = conv1d(x32, k32, bias.detach().to(torch.bfloat16).float(), padding=taps // 2, groups=groups)[
                :, : x.shape[1]]
            if train:
                y32.backward(cot.float())
        rel = lambda a, b: ((a.float() - b).abs().max() / b.abs().max()).item()  # noqa: E731
        with torch.no_grad():
            y_grouped, y_fold = (conv(xg) for conv in (grouped, folded))
        y32 = y32.detach()
        line.update(forward_fold_vs_grouped=rel(y_fold, y_grouped.float()), forward_fold_vs_f32=rel(y_fold, y32),
                    forward_grouped_vs_f32=rel(y_grouped, y32), bound=FOLD_GRAD_BOUND)
        devs = [line["forward_fold_vs_f32"]]
        limits = [FOLD_GRAD_BOUND]
        if train:
            (dx_g, dw_g), (dx_f, dw_f) = line.pop("grouped_grads"), line.pop("fold_grads")
            for name, g, f, ref in (("dx", dx_g, dx_f, x32.grad), ("dw", dw_g, dw_f, k32.grad)):
                line[f"{name}_fold_vs_grouped"] = rel(f, g)
                line[f"{name}_fold_vs_f32"] = rel(f, ref)
                line[f"{name}_grouped_vs_f32"] = rel(g, ref)
                devs += [line[f"{name}_fold_vs_f32"], line[f"{name}_fold_vs_grouped"]]
                limits += [FOLD_GRAD_BOUND, line[f"{name}_grouped_vs_f32"] + FOLD_GRAD_BOUND]
        out[shape_name] = line
        emit({"phase": "pos_conv_fold", "shape": shape_name, **line, "card": card})
        check(all(d <= limit for d, limit in zip(devs, limits)),
              f"pos_conv_fold at {shape_name}: the fold's deviations {devs} over their bounds {limits}")
    return out


def c16_shapes_phase(card: str, checks: list) -> dict:
    """C16 (phase 19 of the module docstring): the shapes the kernels refused before they ran over slices. The
    separable repeat at the smallest k whose span does not fit beside 64 channels at dilation 2 and C 256 (the
    ``separable_edge_taps561`` check holds it to its plain version), timed at B 16, T 751 against its plain
    version; the log-mel at 65,536 + 1,000 rows of 0.1 s clips and at n_fft 32,768 (the ``frontend_log_mel_edge_*``
    checks hold them to their plain versions), timed, with the launches a call."""
    import torch

    from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_plan
    from thunder_tpu_torch.kernels.selftest import KERNEL_CHECKS, _separable_case, ulp_bf16_error
    from thunder_tpu_torch.kernels.separable_conv import (
        fused_separable_repeat,
        separable_plan,
        separable_repeat_reference,
    )

    by_name = {c["name"]: c for c in checks}
    k_min = next(k for k in range(400, 2000) if separable_plan(256, k, 1, 2)["tap_slices"] > 1)
    check(k_min == 561, f"the smallest k taken over tap slices at dilation 2 is {k_min}, not the checks' 561")
    case = _separable_case(58, 16, 751, 256, 256, k_min, dilation=2, device="cuda")
    before = fused_separable_repeat.launches
    got = fused_separable_repeat(**case)
    launches = fused_separable_repeat.launches - before
    ulp = ulp_bf16_error(got, separable_repeat_reference(**case))
    ms, plain_ms = paired_ms(lambda: fused_separable_repeat(**case), lambda: separable_repeat_reference(**case), 5)
    work = separable_bound(16, 751, 751, 256, 256, k_min)
    separable = {"k": k_min, "dilation": 2, "C": 256, "B": 16, "T": 751, "plan": separable_plan(256, k_min, 1, 2),
                 "launches": launches, "ulp": ulp, "ms": ms, "plain_ms": plain_ms,
                 **bound(work["bytes"], work["bf16_flop"], work["f32_flop"])}
    check(ulp <= 8.0 and launches == separable["plan"]["launches"], f"separable at k {k_min}: {separable}")
    log_mel = {}
    for name, batch, samples, kw in (("rows66536", 65536 + 1000, 1600, {}),
                                     ("n_fft32768", 2, 48000, dict(n_fft=32768, hop_length=4096, win_length=16384,
                                                                   n_mels=128))):
        audio = torch.randn((batch, samples), device="cuda").mul_(0.2)
        before = fused_log_mel.launches
        fused_log_mel(audio, **kw)
        launches = fused_log_mel.launches - before
        ms = cuda_ms(lambda: fused_log_mel(audio, **kw), 3)
        result = by_name[f"frontend_log_mel_edge_{'rows66536' if name == 'rows66536' else 'wide32768'}"]
        log_mel[name] = {"batch": batch, "samples": samples, **kw, "launches": launches, "ms": ms,
                         "plan": log_mel_plan(kw.get("n_fft", 512), kw.get("hop_length", 160),
                                              kw.get("win_length", 320), kw.get("n_mels", 64)),
                         "check_max_abs_err": result["max_abs_err"], "tol": KERNEL_CHECKS[result["name"]][1]}
        check(result["ok"] and launches == 2, f"log-mel at {name}: {log_mel[name]}")
        del audio
    line = {"phase": "c16_shapes", "separable": separable, "log_mel": log_mel, "card": card}
    emit(line)
    return line


# ---- loading real checkpoints (phase 20)

QN15X5 = dict(repeat_blocks=3)  # QuartzNet15x5: the encoder's default five (filters, kernel) pairs, each 3 times
QN_SEPARABLE = 77  # separable-repeat launches a QuartzNet15x5 forward: the stem, 15 blocks x 5 repeats, k 87
FINETUNE_VOCAB = list("abcdefghijklmnopqrstuvwxyz '.,")  # 30 tokens: the fine-tuning phase's new head
SPM_LINES, SPM_PIECES = 4000, 1024  # the Citrinet archive's tokenizer: 1,024 unigram pieces, so V = 1,025
# the unigram trainer (the JAX package's algorithm) ends with fewer pieces than it is asked for: a piece whose
# expected count vanishes in the last EM round drops out. On ``seeded_lines(SPM_LINES)`` a vocab_size of 1,056
# leaves exactly SPM_PIECES (1,024 asks leave 995)
SPM_VOCAB_SIZE = 1056
LOADING_BEAM = dict(beam_width=16, beam_backend="device", max_tokens_per_step=50)
FIXTURES = ("tests/fixtures/tiny_quartznet.nemo", "tests/fixtures/tiny_citrinet.nemo")
#: the kernels line's entries and the wrappers whose launches each counts
ENTRY_WRAPPERS = {"log_mel": ("fused_log_mel",), "separable_repeat": ("fused_separable_repeat",),
                  "ctc_recursion": ("ctc_alpha", "ctc_beta"), "mha_from_qkv": ("mha_from_qkv",),
                  "add_layer_norm": ("add_layer_norm",), "beam_scan": ("beam_scan",),
                  "beam_backtrace": ("beam_backtrace",), "mha_train": ("mha_train_forward", "mha_train_backward"),
                  "add_ln_dropout_train": ("add_ln_train_forward", "add_ln_train_backward"),
                  "dropout_keep_mask": ("dropout_keep_mask",)}


def _jasper_block(filters: int, kernel: int, repeat: int = 1, stride: int = 1, dilation: int = 1,
                  residual: bool = True, separable: bool = True, **extra) -> dict:
    return {"filters": filters, "repeat": repeat, "kernel": [kernel], "stride": [stride], "dilation": [dilation],
            "dropout": 0.0, "residual": residual, "separable": separable, **extra}


def _nemo_preprocessor(frontend) -> dict:
    return {"_target_": "nemo.collections.asr.modules.AudioToMelSpectrogramPreprocessor",
            "sample_rate": frontend.sample_rate, "window_size": frontend.n_window_size / frontend.sample_rate,
            "window_stride": frontend.n_window_stride / frontend.sample_rate, "n_fft": frontend.fft_size,
            "features": frontend.nfilt, "dither": frontend.dither, "normalize": "per_feature", "window": "hann"}


def nemo_quartznet_config(module) -> dict:
    """NeMo's ``model_config.yaml`` schema for a port QuartzNet module: ``labels``, ``preprocessor``, the
    ``encoder.jasper`` list (stem, every body block, the k 87 and 1x1 blocks) and ``decoder``."""
    enc, vocab = module.model.encoder, module.text_transform.vocab
    labels = [t for t in vocab.itos if t != vocab.blank_token]
    jasper = [_jasper_block(256, 33, stride=2, residual=False)]
    for f, k in zip(enc.filters, enc.kernel_sizes):
        jasper += [_jasper_block(f, k, repeat=enc.repeat)] * enc.repeat_blocks
    jasper += [_jasper_block(512, 87, dilation=2, residual=False), _jasper_block(1024, 1, residual=False,
                                                                                 separable=False)]
    return {"sample_rate": SAMPLE_RATE, "labels": labels, "preprocessor": _nemo_preprocessor(module.model.audio_transform),
            "encoder": {"_target_": "nemo.collections.asr.modules.ConvASREncoder", "feat_in": enc.feat_in,
                        "activation": "relu", "conv_mask": True, "jasper": jasper},
            "decoder": {"_target_": "nemo.collections.asr.modules.ConvASRDecoder", "feat_in": enc.final_dimension,
                        "num_classes": len(labels), "vocabulary": labels}}


def nemo_citrinet_config(module, pieces) -> dict:
    """NeMo's ``model_config.yaml`` schema for a port Citrinet module whose tokenizer has ``pieces``: the
    vocabulary in NeMo's wordpiece style (``▁x`` -> ``x``, ``x`` -> ``##x``) under ``decoder.vocabulary`` only,
    and squeeze-excite blocks with the stride on the last repeat."""
    enc = module.model.encoder
    labels = [p[1:] if p.startswith("▁") else "##" + p for p in pieces]
    se = dict(se=True, se_context_size=-1)
    jasper = [_jasper_block(256, 5, residual=False, **se)]
    jasper += [_jasper_block(f, k, repeat=enc.repeat, stride=s, stride_last=True, residual_mode="stride_add", **se)
               for f, k, s in zip(enc.filters, enc.kernel_sizes, enc.strides)]
    jasper.append(_jasper_block(640, 41, residual=False, **se))
    return {"sample_rate": SAMPLE_RATE, "preprocessor": _nemo_preprocessor(module.model.audio_transform),
            "encoder": {"_target_": "nemo.collections.asr.modules.ConvASREncoder", "feat_in": enc.feat_in,
                        "activation": "relu", "conv_mask": True, "jasper": jasper},
            "decoder": {"_target_": "nemo.collections.asr.modules.ConvASRDecoder", "feat_in": enc.final_dimension,
                        "num_classes": len(labels), "vocabulary": labels}}


def write_nemo(path, module, config: dict, tokenizer_model: bytes = None) -> None:
    """Write a port QuartzNet or Citrinet module as a ``.nemo`` archive in NeMo's raw layout: the keys of
    ``nemo_key_map``'s table, torch-layout ``(out, in, k)`` conv weights, the BN running statistics (and a
    ``num_batches_tracked`` each), the squeeze-excite weights as ``mconv.<after the last repeat>.fc.{0,2}.weight``,
    ``config`` as ``model_config.yaml`` and any ``tokenizer.model``."""
    import io
    import tarfile

    import torch
    import yaml

    from thunder_tpu_torch.compat.nemo import _block_layout

    encoder = module.model.encoder
    separable = _block_layout(encoder)
    bn_names = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    state = {}
    for key, value in module.model.state_dict().items():
        w = value.detach().cpu().clone()
        parts = key.split(".")
        if parts[0] == "decoder":
            kernel = parts[1] == "kernel"
            state["decoder.decoder_layers.0." + ("weight" if kernel else "bias")] = (
                w.permute(2, 1, 0).contiguous() if kernel else w)
            continue
        block = int(parts[1].removeprefix("block"))
        prefix = f"encoder.encoder.{block}."
        group = 5 if separable[block] else 4
        if parts[2] == "se":
            last = getattr(encoder, parts[1]).repeat - 1
            state[prefix + f"mconv.{last * group + 3}.fc.{0 if parts[3] == 'fc1' else 2}.weight"] = w.t().contiguous()
        elif parts[2] == "res":
            if parts[3] == "conv":
                state[prefix + "res.0.0.conv.weight"] = w.permute(2, 1, 0).contiguous()
            else:
                state[prefix + f"res.0.1.{bn_names[parts[4]]}"] = w
        else:
            rep = int(parts[2].removeprefix("rep"))
            if parts[3] == "bn":
                idx = rep * group + (2 if separable[block] else 1)
                state[prefix + f"mconv.{idx}.{bn_names[parts[4]]}"] = w
                if parts[4] == "var":
                    state[prefix + f"mconv.{idx}.num_batches_tracked"] = torch.tensor(7)
            else:
                idx = rep * group + (1 if parts[3] == "pointwise" else 0)
                state[prefix + f"mconv.{idx}.conv.weight"] = w.permute(2, 1, 0).contiguous()
    weights = io.BytesIO()
    torch.save(state, weights)
    files = {"model_config.yaml": yaml.safe_dump(config).encode(), "model_weights.ckpt": weights.getvalue()}
    if tokenizer_model is not None:
        files["tokenizer.model"] = tokenizer_model
    with tarfile.open(path, "w") as tar:
        for name, payload in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))


def seeded_lines(n_lines: int, seed: int = 0, n_words: int = 3000) -> list:
    """``n_lines`` lines of 4-14 words drawn with Zipf-like frequencies from ``n_words`` random lowercase words
    (numpy ``seed``): the Citrinet archive's tokenizer corpus."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lexicon = ["".join(rng.choice(letters, rng.integers(2, 11))) for _ in range(n_words)]
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    return [" ".join(rng.choice(lexicon, rng.integers(4, 15), p=p)) for _ in range(n_lines)]


def logits_sha256(logits) -> str:
    import hashlib

    return hashlib.sha256(logits.detach().float().cpu().numpy().tobytes()).hexdigest()


def launch_counts() -> dict:
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS

    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_loaded(card: str, phase: str, path, source, audio, lengths, want: dict, device) -> tuple:
    """``load_pretrained(path)`` on ``device``, timed on the host clock; one ``InferenceEngine.infer`` of the
    batch must launch ``want`` and give logits bit-equal (SHA-256) to an engine built from ``source``; its
    ``predict`` the same transcripts. Returns the loaded module, both engines and the launches."""
    import os

    import torch

    from thunder_tpu_torch import load_pretrained
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import reset_launch_counts

    sync(device)
    t0 = time.perf_counter()
    loaded = load_pretrained(str(path), device=device)
    sync(device)
    load_s = time.perf_counter() - t0
    check(loaded.device == torch.device(device) and next(loaded.model.parameters()).device.type == torch.device(device).type,
          f"{phase}: the loaded module is not on {device}")
    engine, source_engine = InferenceEngine(loaded), InferenceEngine(source)
    audio_d, lengths_d = torch.as_tensor(audio, device=device), torch.as_tensor(lengths, device=device)
    source_logits, _, _ = source_engine.infer(audio_d, lengths_d)
    reset_launch_counts()
    logits, _, out_lengths = engine.infer(audio_d, lengths_d)
    sync(device)
    counts = launch_counts()
    texts, source_texts = engine.predict(audio, lengths), source_engine.predict(audio, lengths)
    line = {"phase": phase, "load_s_host_clock": load_s, "archive_bytes": os.path.getsize(path),
            "batch": int(audio.shape[0]), "seconds": audio.shape[1] / SAMPLE_RATE, "frames": int(logits.shape[1]),
            "V": int(logits.shape[2]), "launches": counts, "logits_sha256": logits_sha256(logits),
            "source_logits_sha256": logits_sha256(source_logits), "equal_transcripts": texts == source_texts,
            "transcript_chars": [min(map(len, texts)), max(map(len, texts))], "card": card}
    emit(line)
    check(counts == want, f"{phase}: one forward must launch {want}, got {counts}")
    check(bool(torch.isfinite(logits).all()), f"{phase}: logits not finite")
    check(line["logits_sha256"] == line["source_logits_sha256"], f"{phase}: logits differ from the source module's")
    check(texts == source_texts, f"{phase}: transcripts differ from the source module's")
    return loaded, engine, source_engine, counts, line


def bundle_round_trip(card: str, name: str, module, engine, audio, lengths, tmp, device) -> dict:
    """``save_inference_bundle`` then ``load_inference_bundle``: the restored engine's logits bit-equal to
    ``engine``'s, with the same launches. Returns the launches."""
    import torch

    from thunder_tpu_torch import load_inference_bundle, save_inference_bundle
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import reset_launch_counts

    audio_d, lengths_d = torch.as_tensor(audio, device=device), torch.as_tensor(lengths, device=device)
    reset_launch_counts()
    logits, _, _ = engine.infer(audio_d, lengths_d)
    sync(device)
    want = launch_counts()
    t0 = time.perf_counter()
    directory = save_inference_bundle(str(tmp / f"bundle_{name}"), module)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = load_inference_bundle(directory, device=device)
    sync(device)
    load_s = time.perf_counter() - t0
    restored_engine = InferenceEngine(restored)
    reset_launch_counts()
    again, _, _ = restored_engine.infer(audio_d, lengths_d)
    sync(device)
    counts = launch_counts()
    line = {"phase": f"loading_bundle_{name}", "save_s_host_clock": save_s, "load_s_host_clock": load_s,
            "files": sorted(p.name for p in tmp.joinpath(f"bundle_{name}").iterdir()), "launches": counts,
            "logits_sha256": logits_sha256(again), "before_sha256": logits_sha256(logits), "card": card}
    emit(line)
    check(counts == want, f"bundle {name}: the restored engine launches {counts}, the original {want}")
    check(line["logits_sha256"] == line["before_sha256"], f"bundle {name}: logits differ after the round trip")
    return counts


def loading_phase(card: str, device="cuda") -> dict:
    """Phase 20 of the module docstring: full-width QuartzNet15x5 and Citrinet-256 written as ``.nemo``
    archives, loaded through ``load_pretrained`` and served; the repo's fixtures on the card; the inference
    bundle round trip; ``finetune_ctc_module`` and one step; a ``frozen_paths`` step. Returns the launches of
    each run, by run, for the kernels line."""
    import tempfile
    from pathlib import Path

    import torch

    from thunder_tpu_torch import finetune_ctc_module, load_pretrained
    from thunder_tpu_torch.audio import FilterbankFeatures, Wav2Vec2Preprocess
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.models import Conv1dDecoder, LinearDecoder, QuartznetEncoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer, train_sentencepiece_model
    from thunder_tpu_torch.text.sentencepiece_model import SentencePieceModel
    from thunder_tpu_torch.training.trainer import Trainer

    runs = {}
    rng = np.random.default_rng(0)
    samples = int(SECONDS * SAMPLE_RATE)
    base = speech_like(samples, rng)
    audio = np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(BATCH)])
    lengths = np.full((BATCH,), samples, dtype=np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        # ---- 1. QuartzNet15x5 from a .nemo archive
        source = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(), QuartznetEncoder(**QN15X5),
                                  Conv1dDecoder(len(VOCAB) + 1), BatchTextTransformer(VOCAB), device=device)
        fit_bn(source, audio[:8], lengths[:8])
        qn_path = tmp / "quartznet15x5.nemo"
        write_nemo(qn_path, source, nemo_quartznet_config(source))
        qn, qn_engine, _, runs["quartznet_forward"], _ = serve_loaded(
            card, "loading_quartznet", qn_path, source, audio, lengths,
            expected_counts(fused_log_mel=1, fused_separable_repeat=QN_SEPARABLE), device)
        del source

        # ---- 2. Citrinet-256 from a .nemo archive with a 1,024-piece sentencepiece tokenizer
        lines = seeded_lines(SPM_LINES)
        (tmp / "text.txt").write_text("\n".join(lines) + "\n")
        t0 = time.perf_counter()
        train_sentencepiece_model(str(tmp / "text.txt"), SPM_VOCAB_SIZE, str(tmp / "spm"))
        train_s = time.perf_counter() - t0
        sp_path = tmp / "spm" / "tokenizer.model"
        pieces = SentencePieceModel.load(str(sp_path)).pieces
        check(len(pieces) == SPM_PIECES, f"the tokenizer has {len(pieces)} pieces, not {SPM_PIECES}")
        source = citrinet_create(device, vocab=pieces)
        source.text_transform = BatchTextTransformer(pieces, sentencepiece_model=str(sp_path))
        fit_bn(source, audio[:8], lengths[:8])
        cn_path = tmp / "citrinet256.nemo"
        write_nemo(cn_path, source, nemo_citrinet_config(source, pieces), tokenizer_model=sp_path.read_bytes())
        cn, cn_engine, cn_source_engine, runs["citrinet_forward"], cn_line = serve_loaded(
            card, "loading_citrinet", cn_path, source, audio, lengths,
            expected_counts(fused_log_mel=1, fused_separable_repeat=CITRINET_SEPARABLE), device)
        check(cn.text_transform.vocab.itos == source.text_transform.vocab.itos and cn_line["V"] == SPM_PIECES + 1,
              "the loaded Citrinet's vocabulary differs from its tokenizer's pieces")
        cn_engine.predict(audio, lengths, **LOADING_BEAM)  # warms the beam path
        reset_launch_counts()
        beam_texts = cn_engine.predict(audio, lengths, **LOADING_BEAM)
        sync(device)
        runs["citrinet_beam"] = launch_counts()
        source_beam = cn_source_engine.predict(audio, lengths, **LOADING_BEAM)
        sample = lines[:64]
        ids, _ = cn.text_transform.encode(sample)
        decoded = [t.strip() for t in cn.text_transform.decode_prediction(ids, remove_repeated=False)]
        emit({"phase": "loading_citrinet_beam_and_text", "W": LOADING_BEAM["beam_width"],
              "K": LOADING_BEAM["max_tokens_per_step"], "launches": runs["citrinet_beam"],
              "equal_rows": sum(a == b for a, b in zip(beam_texts, source_beam)), "rows": len(beam_texts),
              "tokenizer_train_s_host_clock": train_s, "tokenizer_lines": SPM_LINES, "pieces": len(pieces),
              "text_rows": len(sample), "text_round_trip_equal": sum(a == b for a, b in zip(decoded, sample)),
              "pieces_per_line": float(np.mean([len(cn.text_transform.tokenizer(t)) for t in sample])), "card": card})
        check(runs["citrinet_beam"] == expected_counts(fused_log_mel=1, fused_separable_repeat=CITRINET_SEPARABLE,
                                                       beam_scan=1, beam_backtrace=1),
              f"one loaded Citrinet beam predict launched {runs['citrinet_beam']}")
        check(beam_texts == source_beam, "the loaded Citrinet's device beam differs from the source engine's")
        check(decoded == sample, "the Citrinet text transform does not round-trip the seed text")
        del source, cn_source_engine

        # ---- 3. the repo's fixtures on the card against the float32 CPU path
        clip = np.arange(SAMPLE_RATE) / SAMPLE_RATE
        fixture_audio = np.stack([(0.4 * np.sin(2 * np.pi * 220 * clip) + 0.3 * np.sin(2 * np.pi * 521 * clip)),
                                  speech_like(SAMPLE_RATE, np.random.default_rng(5))]).astype(np.float32)
        fixture_lengths = np.array([SAMPLE_RATE, SAMPLE_RATE * 3 // 4], np.int32)
        for fixture in FIXTURES:
            name = Path(fixture).stem.removeprefix("tiny_")
            module = load_pretrained(fixture, device=device)
            engine = InferenceEngine(module)
            repeats = sum(rp.kind == "separable" for block in engine._plan for rp in block.repeats)
            reset_launch_counts()
            logits, _, out_lengths = engine.infer(torch.as_tensor(fixture_audio, device=device),
                                                  torch.as_tensor(fixture_lengths, device=device))
            sync(device)
            runs[f"fixture_{name}"] = launch_counts()
            emit({"phase": f"loading_fixture_{name}", "launches": runs[f"fixture_{name}"], "card": card})
            check(runs[f"fixture_{name}"] == expected_counts(fused_log_mel=1, fused_separable_repeat=repeats),
                  f"fixture {name}: {runs[f'fixture_{name}']}")
            logits_vs_cpu_f32(f"loading_fixture_{name}_vs_cpu_f32", module, logits, out_lengths, fixture_audio,
                              fixture_lengths, card=card)

        # ---- 4. the inference bundle round trip: QuartzNet, Citrinet (with its tokenizer.model), wav2vec2-base
        runs["bundle_quartznet"] = bundle_round_trip(card, "quartznet", qn, qn_engine, audio, lengths, tmp, device)
        runs["bundle_citrinet"] = bundle_round_trip(card, "citrinet", cn, cn_engine, audio, lengths, tmp, device)
        check((tmp / "bundle_citrinet" / "tokenizer.model").exists(), "the Citrinet bundle has no tokenizer.model")
        del cn, cn_engine
        w2v_tt = BatchTextTransformer(W2V_VOCAB)
        w2v = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                               Wav2Vec2Encoder(Wav2Vec2Config()), LinearDecoder(w2v_tt.num_tokens), w2v_tt,
                               device=device)
        w2v_samples = int(W2V_SECONDS * SAMPLE_RATE)
        w2v_audio = np.stack([speech_like(w2v_samples, np.random.default_rng(1 + i)) for i in range(W2V_BATCH)])
        w2v_lengths = np.full((W2V_BATCH,), w2v_samples, dtype=np.int32)
        runs["bundle_wav2vec2"] = bundle_round_trip(card, "wav2vec2", w2v, InferenceEngine(w2v), w2v_audio,
                                                    w2v_lengths, tmp, device)
        layers = w2v.model.encoder.config.num_hidden_layers
        check(runs["bundle_wav2vec2"] == expected_counts(mha_from_qkv=layers, add_layer_norm=2 * layers + 1),
              f"wav2vec2 bundle launches {runs['bundle_wav2vec2']}")
        del w2v, qn_engine

        # ---- 5. fine-tuning: a new 30-token head on the QuartzNet archive, one Trainer.fit step
        t0 = time.perf_counter()
        tuned = finetune_ctc_module(str(qn_path), checkpoint_kwargs={"device": device}, tokens=FINETUNE_VOCAB,
                                    decoder_builder=Conv1dDecoder)
        finetune_s = time.perf_counter() - t0
        archive_state = qn.model.state_dict()
        encoder_equal = all(torch.equal(v, archive_state[k]) for k, v in tuned.model.state_dict().items()
                            if k.startswith("encoder."))
        train_samples = int(TRAIN_SECONDS * SAMPLE_RATE)
        train_audio = (np.random.default_rng(0).standard_normal((TRAIN_BATCH, train_samples)) * 0.1).astype(np.float32)
        train_lengths = np.full((TRAIN_BATCH,), train_samples, dtype=np.int32)
        batch = [(train_audio, train_lengths, [TRAIN_TEXT] * TRAIN_BATCH)]
        reset_launch_counts()
        trainer = Trainer(seed=0, log_every=1, device=device)
        trainer.fit(tuned, batch)
        sync(device)
        runs["finetune_step"] = launch_counts()
        loss = trainer.logs[-1]["loss/train_loss"]
        emit({"phase": "loading_finetune", "finetune_s_host_clock": finetune_s, "V": tuned.text_transform.num_tokens,
              "encoder_equal_to_archive": encoder_equal, "batch": TRAIN_BATCH, "seconds": TRAIN_SECONDS,
              "loss": loss, "launches": runs["finetune_step"], "card": card})
        check(encoder_equal, "the fine-tuning module's encoder differs from the archive's")
        check(tuned.text_transform.num_tokens == len(FINETUNE_VOCAB) + 1, "the new head's vocabulary")
        check(runs["finetune_step"] == expected_counts(fused_log_mel=1, ctc_alpha=1, ctc_beta=1),
              f"one fine-tuning step launched {runs['finetune_step']}")
        check(bool(np.isfinite(loss)), f"fine-tuning loss {loss}")
        del tuned, qn, trainer

        # ---- 6. frozen_paths (C4): one wav2vec2-base step at 8 x 15 s, dropout 0.1, the extractor untouched
        cfg = Wav2Vec2Config(hidden_dropout=0.1, attention_dropout=0.1, feat_proj_dropout=0.1)
        module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=False),
                                  Wav2Vec2Encoder(cfg, dtype=torch.bfloat16, freeze_feature_extractor=True),
                                  LinearDecoder(len(VOCAB) + 1, dtype=torch.bfloat16), BatchTextTransformer(VOCAB),
                                  device=device)
        module.frozen_paths = [("encoder", "feature_extractor")]
        before = {k: v.clone() for k, v in module.model.state_dict().items()}
        b = W2V_TRAIN_BATCH
        reset_launch_counts()
        trained = Trainer(seed=0, device=device).fit(module, [(train_audio[:b], train_lengths[:b], [TRAIN_TEXT] * b)])
        sync(device)
        runs["frozen_paths_step"] = launch_counts()
        after = trained.model.state_dict()
        frozen = [k for k in before if k.startswith("encoder.feature_extractor.")]
        params = {n for n, _ in trained.model.named_parameters()}
        others = [k for k in before if k in params and k not in frozen]
        frozen_equal = sum(torch.equal(after[k], before[k]) for k in frozen)
        moved = sum(not torch.equal(after[k], before[k]) for k in others)
        emit({"phase": "loading_frozen_paths_step", "batch": b, "seconds": W2V_SECONDS, "frozen_tensors": len(frozen),
              "frozen_bit_equal": frozen_equal, "other_parameters": len(others), "moved": moved,
              "launches": runs["frozen_paths_step"], "card": card})
        check(frozen and frozen_equal == len(frozen), f"{len(frozen) - frozen_equal} frozen extractor tensors moved")
        check(moved == len(others), f"{len(others) - moved} trainable parameters did not move")
    return runs


def add_loading_launches(kernels: list, runs: dict) -> None:
    """Each kernel's launches in the loading phase's runs (0 for those they do not reach)."""
    for entry in kernels:
        entry["loading_launches"] = {run: sum(c[w] for w in ENTRY_WRAPPERS[entry["name"]]) for run, c in runs.items()}



# ---- phases 21-23: the rest of training (remat, the trainer's features, the learning gate)

#: |grad remat on - grad remat off| / |grad remat off| over each tensor's largest magnitude, at most this or
#: REMAT_GRAD_SPREADS times the same measure between two remat-off steps: cuDNN's convolution backward (weight
#: gradients accumulated by atomics) is not deterministic, so two steps without remat differ too
REMAT_GRAD_FLOOR = 1e-3
REMAT_GRAD_SPREADS = 4.0
REMAT_TIMED = 3
#: the first loss of the resumed run against the uninterrupted run's loss at that step, relative: the two
#: start from bit-equal states, and cuDNN's nondeterministic backward moves the weights apart by its spread
RESUME_LOSS_TOL = 1e-2
#: the synthetic learning gate (``examples/synthetic_learning_demo.py``; ``bench.py``'s bound)
GATE_CHARS = "abcdefgh"
GATE_ITEMS, GATE_EPOCHS, GATE_BATCH, GATE_WER = 2048, 6, 32, 0.15


def step_state(model, generator) -> dict:
    """The parts of a train step that remat must leave unchanged: the running statistics and the generator."""
    return {"buffers": {k: v.detach().clone() for k, v in model.named_buffers()}, "generator": generator.get_state()}


def grad_deviation(grads: dict, reference: dict) -> float:
    """The largest of ``max|g - ref| / max|ref|`` over the tensors (a tensor of zeros counts its max |g|)."""
    worst = 0.0
    for name, ref in reference.items():
        scale = ref.abs().max().item()
        diff = (grads[name] - ref).abs().max().item()
        worst = max(worst, diff / scale if scale > 0 else diff)
    return worst


def remat_generator_syncs(device) -> dict:
    """A CUDA generator's get_state and set_state, as ``checkpointed`` calls them once a block, under the sync
    debug mode "error": a device synchronisation raises. Also their host time."""
    import torch

    generator = torch.Generator(device=device).manual_seed(0)
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for _ in range(100):
            generator.set_state(generator.get_state())
        us = (time.perf_counter() - t0) * 1e4
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    return {"get_set_state_us": us, "syncs": 0}


def training_remat_phase(card: str, device="cuda") -> dict:
    """Phase ``training_remat``: QuartzNet15x5 and Citrinet-256 at TRAIN_BATCH x TRAIN_SECONDS and wav2vec2-base
    at W2V_TRAIN_BATCH x W2V_SECONDS (``bench_train.py``'s configurations, wav2vec2 with ``--remat``), each
    from the same weights and generator state: two forward + backward steps with remat off and one with it
    on. The loss, the running statistics and the generator's state after the step must be bit-equal; the
    gradients within REMAT_GRAD_FLOOR, or REMAT_GRAD_SPREADS times the spread of the two remat-off steps; the
    launches of the remat step as derived (QuartzNet and Citrinet: 1 log-mel, 1 + 1 CTC, the frontend and
    the loss being outside the blocks; wav2vec2: each layer's attention and its two add + dropout + LayerNorm
    forwards once more in the recompute, the encoder's own add + LayerNorm not, so 12 + 12 and 25 + 24 forward
    launches, the backward's 24 and 50 unchanged). Then ``TrainStep`` with AdamW, remat off and on in turns:
    ``torch.cuda.max_memory_allocated`` of a step and its ms (CUDA events, mean of REMAT_TIMED). Returns each
    model's launches of the remat step."""
    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures, Wav2Vec2Preprocess
    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.models import Conv1dDecoder, LinearDecoder, QuartznetEncoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.ops.ctc import calculate_ctc
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.optim import adamw
    from thunder_tpu_torch.training.trainer import TrainStep, _encode_targets

    tt = BatchTextTransformer(VOCAB)
    bf16 = torch.bfloat16
    if torch.device(device).type == "cuda":
        syncs = remat_generator_syncs(device)
        emit({"phase": "remat_generator_state", **syncs, "card": card})

    def quartznet():
        return CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(num_time_masks=2, num_freq_masks=2),
                                QuartznetEncoder(repeat_blocks=3, dropout=0.1, dtype=bf16), Conv1dDecoder(29, dtype=bf16),
                                tt, device=device)

    def citrinet():
        return citrinet_create(device, bf16, VOCAB, train_config=True, dropout=0.1)

    def wav2vec2():
        cfg = Wav2Vec2Config(hidden_dropout=0.1, attention_dropout=0.1, feat_proj_dropout=0.1)
        return CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=False),
                                Wav2Vec2Encoder(cfg, dtype=bf16, freeze_feature_extractor=True),
                                LinearDecoder(tt.num_tokens, dtype=bf16), tt, device=device)

    layers = Wav2Vec2Config().num_hidden_layers
    conv = expected_counts(fused_log_mel=1, ctc_alpha=1, ctc_beta=1)
    models = [("quartznet15x5", quartznet, TRAIN_BATCH, TRAIN_SECONDS, conv),
              ("citrinet256", citrinet, TRAIN_BATCH, TRAIN_SECONDS, conv),
              ("wav2vec2_base", wav2vec2, W2V_TRAIN_BATCH, W2V_SECONDS,
               expected_counts(mha_train_forward=2 * layers, mha_train_backward=2 * layers,
                               add_ln_train_forward=(2 * layers + 1) + 2 * layers,
                               add_ln_train_backward=2 * (2 * layers + 1), ctc_alpha=1, ctc_beta=1))]
    runs = {}
    for name, create, b, seconds, want in models:
        samples = int(seconds * SAMPLE_RATE)
        audio = torch.as_tensor((np.random.default_rng(0).standard_normal((b, samples)) * 0.1).astype(np.float32),
                                device=device)
        lengths = torch.full((b,), samples, dtype=torch.int32, device=device)
        targets, target_lengths = (torch.as_tensor(a, device=device) for a in _encode_targets(tt, [TRAIN_TEXT] * b))
        module = create()
        model = module.model
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        generator = torch.Generator(device=device).manual_seed(0)
        entry_state = generator.get_state()

        def forward_backward(remat: bool):
            model.load_state_dict(start)
            model.encoder.remat = remat
            model.zero_grad(set_to_none=True)
            generator.set_state(entry_state)
            reset_launch_counts()
            logits, out_lengths = model(audio, lengths, train=True, generator=generator)
            loss = calculate_ctc(logits, targets, out_lengths, target_lengths, module.blank_idx)
            loss.backward()
            sync(device)
            grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters() if p.grad is not None}
            return loss.detach(), grads, step_state(model, generator), launch_counts()

        off, grads_off, state_off, _ = forward_backward(False)
        off2, grads_off2, state_off2, _ = forward_backward(False)
        on, grads_on, state_on, counts = forward_backward(True)
        spread = grad_deviation(grads_off2, grads_off)
        dev = grad_deviation(grads_on, grads_off)
        buffers_equal = all(torch.equal(state_on["buffers"][k], v) for k, v in state_off["buffers"].items())
        generator_equal = torch.equal(state_on["generator"], state_off["generator"])
        line = {"phase": "training_remat", "model": name, "batch": b, "seconds": seconds,
                "loss_off": off.item(), "loss_off_again": off2.item(), "loss_on": on.item(),
                "loss_bit_equal": bool(torch.equal(on, off)), "buffers_bit_equal": buffers_equal,
                "generator_state_equal": generator_equal, "grad_rel_dev": dev, "grad_rel_spread_off_off": spread,
                "grad_tol": max(REMAT_GRAD_FLOOR, REMAT_GRAD_SPREADS * spread), "launches_remat_step": counts}

        # the whole step (TrainStep with AdamW) in turns: peak memory and device time, remat off and on
        timing = {}
        for remat in (False, True, False, True):
            model.load_state_dict(start)
            model.encoder.remat = remat
            step = TrainStep(model, adamw(model.parameters(), learning_rate=1e-4), module.blank_idx)
            step(audio, lengths, targets, target_lengths, generator)  # warm-up, the optimizer's state allocated
            sync(device)
            if torch.device(device).type == "cuda":
                line["allocated_before_step_gb"] = torch.cuda.memory_allocated() / 1e9
                torch.cuda.reset_peak_memory_stats()
                begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                begin.record()
                for _ in range(REMAT_TIMED):
                    step(audio, lengths, targets, target_lengths, generator)
                end.record()
                torch.cuda.synchronize()
                timing.setdefault(remat, []).append((begin.elapsed_time(end) / REMAT_TIMED,
                                                     torch.cuda.max_memory_allocated() / 1e9))
            del step
        model.encoder.remat = False
        if name == "wav2vec2_base" and torch.device(device).type == "cuda":
            # the frozen extractor runs without a graph, remat or not: its transient peak above what is allocated
            with torch.no_grad():
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                model.encoder.feature_extractor(model.audio_transform(audio, lengths)[0], lengths)
                line["frozen_extractor_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        for remat, label in ((False, "off"), (True, "on")):
            if remat in timing:
                line[f"step_ms_{label}"] = [t for t, _ in timing[remat]]
                line[f"peak_mem_gb_{label}"] = max(m for _, m in timing[remat])
        emit({**line, "card": card})
        check(line["loss_bit_equal"], f"{name}: the remat step's loss {on.item()} != {off.item()} without remat")
        check(buffers_equal, f"{name}: the running statistics after a remat step differ from those without it")
        check(generator_equal, f"{name}: the generator's state after a remat step differs from that without it")
        check(dev <= line["grad_tol"], f"{name}: remat gradients off by {dev} > {line['grad_tol']} (spread {spread})")
        if torch.device(device).type == "cuda":
            check(counts == want, f"{name}: a remat step must launch {want}, got {counts}")
        runs[name] = counts
        del module, model, start, grads_off, grads_off2, grads_on
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return runs


class TimedLoader:
    """A loader that adds up the host time its consumer waits for each batch (``wait_s``)."""

    def __init__(self, loader):
        self.loader, self.wait_s, self.batches = loader, 0.0, 0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.wait_s += time.perf_counter() - t0
            self.batches += 1
            yield batch


def trainer_features_phase(card: str, device="cuda") -> dict:
    """Phase ``trainer_features``: QuartzNet15x5 (``bench_train.py --model quartznet``'s configuration) at
    TRAIN_BATCH x TRAIN_SECONDS through ``Trainer.fit``, two batches an epoch and a validation batch of 2 rows:

    - run A, 2 epochs: AdamW under ``onecycle`` through ``total_steps_arg``, ``FinetuneEncoderDecoder(
      unfreeze_encoder_at_epoch=1)``, ``checkpoint_dir`` with ``checkpoint_monitor``, ``eval_beam_width=16``
      (the host beam), a ``JsonlLogger``: each step's learning rate equals the schedule's, each train step
      launches 1 log-mel and 1 + 1 CTC kernels and each validation batch 1 log-mel and 1 ``ctc_alpha``;
    - run B, epoch 0 of the same run alone: the encoder's parameters bit-equal while the decoder's moved;
      its checkpoint restored into a fresh ``TrainStep`` gives back the saved parameters, optimizer state,
      generator state and step bit for bit, and ``resume_from`` it, its first loss within RESUME_LOSS_TOL of
      run A's third;
    - a ``reduce_on_plateau`` run (3 epochs, one batch each): ``lr_scale/plateau`` each epoch equals the rule
      replayed on the logged validation losses, and the next epoch's learning rate carries it;
    - an ``EarlyStopping(patience=0, min_delta=1e9)`` run: it stops after epoch 1 and saves a checkpoint there.
    Returns the launches of run A."""
    import os
    import tempfile

    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training import checkpointing
    from thunder_tpu_torch.training.loggers import JsonlLogger
    from thunder_tpu_torch.training.optim import onecycle, plateau_update, reduce_on_plateau
    from thunder_tpu_torch.training.trainer import EarlyStopping, FinetuneEncoderDecoder, Trainer

    tt = BatchTextTransformer(VOCAB)
    dtype = torch.bfloat16
    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(num_time_masks=2, num_freq_masks=2),
                              QuartznetEncoder(repeat_blocks=3, dropout=0.1, dtype=dtype), Conv1dDecoder(29, dtype=dtype),
                              tt, device=device)
    samples = int(TRAIN_SECONDS * SAMPLE_RATE)
    rng = np.random.default_rng(0)

    def batch(n):
        audio = (rng.standard_normal((n, samples)) * 0.1).astype(np.float32)
        return audio, np.full((n,), samples, dtype=np.int32), [TRAIN_TEXT] * n

    train, val = [batch(TRAIN_BATCH), batch(TRAIN_BATCH)], [batch(2)]
    common = dict(optimizer_kwargs={"learning_rate": 1e-3}, lr_scheduler_builder=onecycle, seed=0, log_every=1,
                  device=device)
    monitor = dict(checkpoint_monitor="loss/val_loss")

    def finetune():
        return [FinetuneEncoderDecoder(unfreeze_encoder_at_epoch=1)]

    def train_losses(trainer):
        return [e["loss/train_loss"] for e in trainer.logs if "loss/train_loss" in e]

    params = [n for n, _ in module.model.named_parameters()]
    start = {k: v.detach().clone() for k, v in module.model.state_dict().items()}
    with tempfile.TemporaryDirectory() as d:
        # ---- run A: 2 epochs, the schedule through total_steps_arg, the freeze, best-only checkpoints, beam eval
        run_a = Trainer(max_epochs=2, lr_scheduler_kwargs={"max_lr": 1e-3, "total_steps_arg": "total_steps"},
                        callbacks=finetune(), checkpoint_dir=f"{d}/a", eval_beam_width=16,
                        logger=JsonlLogger(f"{d}/a.jsonl"), **monitor, **common)
        reset_launch_counts()
        t0 = time.perf_counter()
        run_a.fit(module, train, val_loader=val)
        sync(device)
        a_s = time.perf_counter() - t0
        counts = launch_counts()
        steps = len(train) * 2
        lrs = [e["lr"] for e in run_a.logs if "lr" in e]
        schedule = [onecycle(1e-3, steps)(s) for s in range(steps)]
        vals_a = [e for e in run_a.logs if "loss/val_loss" in e]
        with open(f"{d}/a.jsonl") as f:
            logged = sum(1 for _ in f)
        emit({"phase": "trainer_features_run_a", "train_losses": train_losses(run_a), "lrs": lrs, "schedule": schedule,
              "val": vals_a, "checkpoints": sorted(os.listdir(f"{d}/a")), "jsonl_lines": logged, "launches": counts,
              "seconds": a_s, "card": card})
        check(lrs == schedule, f"run A's learning rates {lrs} are not onecycle's {schedule}")
        check(logged == len(run_a.logs), f"the JsonlLogger wrote {logged} lines for {len(run_a.logs)} log entries")
        check(len(vals_a) == 2 and all(np.isfinite(e["loss/val_loss"]) for e in vals_a), f"run A's validation {vals_a}")
        if torch.device(device).type == "cuda":
            want = expected_counts(fused_log_mel=steps + 2, ctc_alpha=steps + 2, ctc_beta=steps)
            check(counts == want, f"run A ({steps} steps, 2 validation batches) must launch {want}, got {counts}")

        # ---- run B: epoch 0 alone; the encoder frozen; its checkpoint restored; a run resumed from it
        fixed = {"max_lr": 1e-3, "total_steps": steps}
        run_b = Trainer(max_epochs=1, lr_scheduler_kwargs=fixed, callbacks=finetune(), checkpoint_dir=f"{d}/b",
                        **monitor, **common)
        trained = run_b.fit(module, train, val_loader=val)
        after = trained.model.state_dict()
        encoder_equal = all(torch.equal(after[n], start[n]) for n in params if n.startswith("encoder."))
        decoder_moved = all(not torch.equal(after[n], start[n]) for n in params if n.startswith("decoder."))
        (folder,) = os.listdir(f"{d}/b")
        payload = checkpointing.restore_checkpoint(f"{d}/b/{folder}")
        saved_equal = all(torch.equal(payload["model"][k], v.cpu()) for k, v in after.items())
        resume = dict(lr_scheduler_kwargs=fixed, callbacks=finetune(), resume_from=f"{d}/b/{folder}", **common)
        train_step, generator, _ = Trainer(max_epochs=1, **resume).train_step_for(module.to(device), train)
        checkpointing.load_train_state(payload, train_step, generator)
        restored_equal = same_tree(checkpointing.train_state(train_step, generator), payload)
        resumed = Trainer(max_epochs=1, **resume)
        resumed.fit(module, train, val_loader=val)
        first, want_loss = train_losses(resumed)[0], train_losses(run_a)[len(train)]
        emit({"phase": "trainer_features_resume", "checkpoint": folder, "encoder_bit_equal": encoder_equal,
              "decoder_moved": decoder_moved, "saved_equals_trained": saved_equal, "restored_equals_saved": restored_equal,
              "step": payload["step"], "resumed_first_loss": first, "run_a_loss_at_that_step": want_loss,
              "rel_dev": abs(first - want_loss) / abs(want_loss), "tol": RESUME_LOSS_TOL, "card": card})
        check(encoder_equal and decoder_moved, "epoch 0 under the freeze must keep the encoder and move the decoder")
        check(folder == f"step_{len(train)}" and saved_equal and restored_equal,
              f"checkpoint {folder}: saved {saved_equal}, restored {restored_equal}")
        check(abs(first - want_loss) <= RESUME_LOSS_TOL * abs(want_loss),
              f"the resumed run's first loss {first} is not run A's {want_loss}")

        # ---- the plateau: the scale replayed on the logged validation losses, and carried into the next epoch
        kw = {"factor": 0.5, "patience": 0}
        plateau = Trainer(max_epochs=3, optimizer_kwargs={"learning_rate": 1e-3}, lr_scheduler_builder=reduce_on_plateau,
                          lr_scheduler_kwargs=dict(kw), seed=0, log_every=1, device=device)
        plateau.fit(module, train[:1], val_loader=val)
        state, scales, replayed = reduce_on_plateau(**kw).init(), [], []
        for e in plateau.logs:
            if "lr_scale/plateau" in e:
                state = plateau_update(state, e["loss/val_loss"], **kw)
                scales.append(e["lr_scale/plateau"])
                replayed.append(float(state.scale))
        plateau_lrs = [e["lr"] for e in plateau.logs if "lr" in e]
        emit({"phase": "trainer_features_plateau", "scales": scales, "replayed": replayed, "lrs": plateau_lrs,
              "val_losses": [e["loss/val_loss"] for e in plateau.logs if "loss/val_loss" in e], "card": card})
        check(scales == replayed and len(scales) == 3, f"plateau scales {scales} are not the rule's {replayed}")
        check(plateau_lrs == [1e-3] + [1e-3 * s for s in scales[:-1]], f"plateau learning rates {plateau_lrs}")

        # ---- early stopping: epoch 0 sets the best, epoch 1 cannot beat it by 1e9 and stops, with a checkpoint
        stopping = Trainer(max_epochs=4, optimizer_kwargs={"learning_rate": 1e-3},
                           callbacks=[EarlyStopping(patience=0, min_delta=1e9)], checkpoint_dir=f"{d}/e", seed=0,
                           log_every=1, device=device)
        stopping.fit(module, train[:1], val_loader=val)
        stops = [e["epoch"] for e in stopping.logs if e.get("early_stop")]
        saved = sorted(os.listdir(f"{d}/e"))
        emit({"phase": "trainer_features_early_stop", "stopped_at_epoch": stops, "checkpoints": saved, "card": card})
        check(stops == [1] and saved == ["step_1", "step_2"], f"early stop at {stops}, checkpoints {saved}")
    return counts


def same_tree(a, b) -> bool:
    """Two train states (nested dicts, lists and tensors) bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return a == b


def learning_gate_phase(card: str, device="cuda", items: int = GATE_ITEMS, epochs: int = GATE_EPOCHS,
                        batch: int = GATE_BATCH) -> dict:
    """Phase ``learning_gate``: ``examples/synthetic_learning_demo.py::run`` on the port. 2,048 items of 3-8
    tone-coded characters (a 0.12 s Hann-windowed tone a character, noise 0.02, numpy seed 0) written as
    16-bit WAVs into a temporary folder; QuartzNet (one block of two 128-channel repeats, k 33) trained by
    ``Trainer.fit(datamodule=ManifestDatamodule(...))`` with AdamW at lr 1e-3, norm clip 1.0, batch 32, 6
    epochs; the last validation WER must be at or below GATE_WER (``bench.py``'s gate). Prints the WER curve,
    the wall seconds and the host time the trainer waited for the loader. Every train step launches 1 log-mel
    and 1 + 1 CTC kernels, every validation batch 1 log-mel and 1 ``ctc_alpha``. Returns the run's launches."""
    import json
    import tempfile
    import wave

    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.data import ManifestDatamodule
    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.trainer import Trainer

    freqs = {c: 300 + 150 * i for i, c in enumerate(GATE_CHARS)}
    seg = int(0.12 * SAMPLE_RATE)
    tones = {c: 0.4 * np.sin(2 * np.pi * f * np.arange(seg) / SAMPLE_RATE) * np.hanning(seg) for c, f in freqs.items()}

    class TimedManifestDatamodule(ManifestDatamodule):
        def train_dataloader(self):
            self.timed = TimedLoader(super().train_dataloader())
            return self.timed

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(0)
        rows = []
        for i in range(items):
            text = "".join(rng.choice(list(GATE_CHARS)) for _ in range(rng.integers(3, 9)))
            sig = np.concatenate([tones[c] for c in text])
            sig = np.clip(sig + 0.02 * rng.standard_normal(sig.shape), -1, 1).astype(np.float32)
            path = f"{d}/{i}.wav"
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SAMPLE_RATE)
                w.writeframes((sig * 32767).astype(np.int16).tobytes())
            rows.append({"audio_filepath": path, "text": text, "duration": len(sig) / SAMPLE_RATE})
        split = items - max(items // 32, 8)
        with open(f"{d}/t.json", "w") as f:
            f.write("\n".join(json.dumps(x) for x in rows[:split]))
        with open(f"{d}/v.json", "w") as f:
            f.write("\n".join(json.dumps(x) for x in rows[split:]))
        synth_s = time.perf_counter() - t_start

        tt = BatchTextTransformer(list(GATE_CHARS))
        module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(),
                                  QuartznetEncoder(repeat=2, filters=(128,), kernel_sizes=(33,)),
                                  Conv1dDecoder(tt.num_tokens), tt, device=device)
        dm = TimedManifestDatamodule(f"{d}/t.json", f"{d}/v.json", f"{d}/v.json", batch_size=batch, num_workers=8)
        trainer = Trainer(max_epochs=epochs, optimizer_kwargs={"learning_rate": 1e-3}, gradient_clip_norm=1.0,
                          log_every=100, device=device)
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit(module, datamodule=dm)
        sync(device)
        wall = time.perf_counter() - t0
        counts = launch_counts()
    curve = [(e["epoch"], e["metrics/wer"], e["metrics/cer"]) for e in trainer.logs if "metrics/wer" in e]
    steps = dm.timed.batches
    val_batches = epochs * -(-(items - split) // batch)
    emit({"phase": "learning_gate", "items": items, "epochs": epochs, "batch": batch, "train_steps": steps,
          "val_curve_epoch_wer_cer": curve, "final_wer": curve[-1][1], "bound": GATE_WER, "wall_s": wall,
          "synthesis_s": synth_s, "loader_wait_s": dm.timed.wait_s, "loader_wait_share": dm.timed.wait_s / wall,
          "launches": counts, "card": card})
    if torch.device(device).type == "cuda":
        want = expected_counts(fused_log_mel=steps + val_batches, ctc_alpha=steps + val_batches, ctc_beta=steps)
        check(counts == want, f"the learning gate must launch {want}, got {counts}")
    check(curve[-1][1] <= GATE_WER, f"synthetic held-out WER {curve[-1][1]} > {GATE_WER}: the learning gate failed")
    return counts


def add_training_launches(kernels: list, runs: dict) -> None:
    """Each kernel's launches in the remat steps, the trainer_features run A and the learning gate."""
    for entry in kernels:
        entry["training_launches"] = {run: sum(c[w] for w in ENTRY_WRAPPERS[entry["name"]]) for run, c in runs.items()}



# ---- phase 24: language-model decoding and the native host runtime

LM_WIDTH, LM_WEIGHT, LM_ORDER, WORD_LM_ORDER = 16, 0.5, 4, 3
LM_LINES = 2000  # seeded lines the token and word LMs are fitted on
NUMPY_ROWS = 8  # rows the numpy search reproduces, one a worker process (7 s a row with an LM on one core)
FLAC_BLOCK, FLAC_PARTITION_ORDER = 4096, 4


def _crc(data: bytes, table: list, bits: int) -> int:
    crc, shift, mask = 0, bits - 8, (1 << bits) - 1
    for byte in data:
        crc = ((crc << 8) & mask) ^ table[(crc >> shift) ^ byte]
    return crc


def _crc_table(poly: int, bits: int) -> list:
    table, top, mask = [], 1 << (bits - 1), (1 << bits) - 1
    for byte in range(256):
        crc = byte << (bits - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
        table.append(crc)
    return table


def _bits(value: int, n: int) -> np.ndarray:
    """``value``'s low ``n`` bits, most significant first, as 0/1 bytes."""
    return ((int(value) & ((1 << n) - 1)) >> np.arange(n - 1, -1, -1)) & 1


def _rice(residuals: np.ndarray) -> np.ndarray:
    """One Rice partition: its 4-bit parameter (the cheapest of 0-14) and the codes, as 0/1 bytes."""
    u = np.where(residuals >= 0, 2 * residuals, -2 * residuals - 1).astype(np.int64)
    k = int(np.argmin([(u >> k).sum() + u.size * (1 + k) for k in range(15)]))
    q = u >> k
    lens = q + 1 + k
    starts = np.cumsum(lens) - lens
    out = np.zeros(int(lens.sum()), np.uint8)
    out[starts + q] = 1
    for j in range(k):
        out[starts + q + 1 + j] = (u >> (k - 1 - j)) & 1
    return np.concatenate([_bits(k, 4).astype(np.uint8), out])


def flac_bytes(pcm: np.ndarray, rate: int) -> bytes:
    """A mono 16-bit FLAC stream of ``pcm`` (int16), numpy-vectorised: frames of ``FLAC_BLOCK`` samples, each one
    FIXED order-2 subframe whose residuals are Rice-coded in ``2**FLAC_PARTITION_ORDER`` partitions (a parameter
    each), with the frame's CRC-8 and CRC-16 (the decoder the port ships skips them; the format has them)."""
    crc8, crc16 = _crc_table(0x07, 8), _crc_table(0x8005, 16)
    x = np.asarray(pcm, np.int64)
    info = np.concatenate([_bits(FLAC_BLOCK, 16), _bits(FLAC_BLOCK, 16), _bits(0, 24), _bits(0, 24), _bits(rate, 20),
                           _bits(0, 3), _bits(15, 5), _bits(x.size, 36)]).astype(np.uint8)
    out = [b"fLaC", bytes([0x80, 0, 0, 34]), np.packbits(info).tobytes(), bytes(16)]
    for number, start in enumerate(range(0, x.size, FLAC_BLOCK)):
        block = x[start : start + FLAC_BLOCK]
        n = block.size
        utf8 = bytes([number]) if number < 0x80 else bytes([0xC0 | number >> 6, 0x80 | number & 0x3F])
        header = bytes([0xFF, 0xF8, 0x70, 0x08]) + utf8 + (n - 1).to_bytes(2, "big")
        header += bytes([_crc(header, crc8, 8)])
        order = min(2, n)  # FIXED order 2: the second difference (a block of one or two samples: all warm-up)
        residual = (block[2:] - 2 * block[1:-1] + block[:-2]) if order == 2 else block[order:] - block[: n - order]
        parts = FLAC_PARTITION_ORDER if n % (1 << FLAC_PARTITION_ORDER) == 0 and n >> FLAC_PARTITION_ORDER > 2 else 0
        size = n >> parts
        edges = [0] + [size * (i + 1) - order for i in range(1 << parts)]
        # subframe header: a zero pad bit, the type (FIXED: 8 + order) in 6 bits, no wasted bits
        pieces = [_bits((8 + order) << 1, 8), *[_bits(v, 16) for v in block[:order]], _bits(0, 2), _bits(parts, 4),
                  *[_rice(residual[lo:hi]) for lo, hi in zip(edges[:-1], edges[1:])]]
        body = np.packbits(np.concatenate([np.asarray(b, np.uint8) for b in pieces])).tobytes()
        frame = header + body
        out.append(frame + _crc(frame, crc16, 16).to_bytes(2, "big"))
    return b"".join(out)


_NUMPY_LM = None


def _numpy_worker_init(lines: list, vocab: list, order: int) -> None:
    """Fit the token LM of ``lm_native_phase`` once in a worker process (an LM's C++ mirror does not pickle)."""
    global _NUMPY_LM
    from thunder_tpu_torch.text import BatchTextTransformer, NGramLM

    _NUMPY_LM = NGramLM.from_texts(lines, BatchTextTransformer(vocab), order=order) if order else None


def _numpy_beam_row(job) -> tuple:
    """The numpy search (``use_native=False``) of one row; returns its ids and seconds."""
    from thunder_tpu_torch.ops.ctc_beam import beam_search_decode

    logits, length, blank, use_lm = job
    t0 = time.perf_counter()
    ids = beam_search_decode(logits[None], [length], blank=blank, beam_width=LM_WIDTH, lm=_NUMPY_LM if use_lm else None,
                             lm_weight=LM_WEIGHT, use_native=False)[0]
    return ids.tolist(), time.perf_counter() - t0


def numpy_rows(logits: np.ndarray, lengths, blank: int, lines: list, use_lm: bool) -> tuple:
    """The numpy search of rows 0 to ``NUMPY_ROWS`` - 1, one a spawned worker process: their ids, the sum of
    the rows' seconds (one core each) and the wall seconds."""
    import concurrent.futures
    import multiprocessing

    t0 = time.perf_counter()
    jobs = [(np.asarray(logits[b], np.float32), int(lengths[b]), blank, use_lm) for b in range(NUMPY_ROWS)]
    with concurrent.futures.ProcessPoolExecutor(NUMPY_ROWS, mp_context=multiprocessing.get_context("spawn"),
                                                initializer=_numpy_worker_init,
                                                initargs=(lines, VOCAB, LM_ORDER if use_lm else 0)) as pool:
        results = list(pool.map(_numpy_beam_row, jobs))
    return [ids for ids, _ in results], sum(sec for _, sec in results), time.perf_counter() - t0


def host_ms(fn, repeats: int = 3) -> float:
    """Median host milliseconds of ``fn()`` over ``repeats`` calls, after one call."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


LM_TIE_DIR = "smoke_out/lm_ties"  # under the checkout: the rows whose best differs on the CPU path


def lm_rows(seed: int) -> tuple:
    """Phase 24's rows from ``seed``: 64 x 15 s of one speech-like signal at random gains, quantized to 16 bits
    (int16 PCM), the same as float32 in [-1, 1), and the lengths."""
    rng = np.random.default_rng(seed)
    samples = int(SECONDS * SAMPLE_RATE)
    base = speech_like(samples, rng)
    pcm = np.clip(np.round(np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(BATCH)]) * 32767), -32768,
                  32767).astype(np.int16)
    return pcm, pcm.astype(np.float32) / 32768.0, np.full((BATCH,), samples, dtype=np.int32)


def lm_parting(row_logits, frames: int, blank: int, prune_logp: float = -12.0) -> dict:
    """Where the card's beam scan and the port's CPU path part on one row of logits (on the card): both search the
    row cut at every length 1 to ``frames`` (one batch of ``frames`` rows), and the first length t whose 16
    survivors differ is the parting. Up to t - 1 both paths kept the same prefixes, so their scores there differ
    only by rounding; what follows t is a consequence of it. At t: the hypotheses only one path keeps, each with
    its margin over the other path's lowest kept score (a tie at the top-W cut when at most ``tol``, the float32
    chain bound at t steps), the tokens of frame t whose log-probabilities fall on different sides of
    ``prune_logp`` on the two paths (a tie at the pruning threshold), the shared hypotheses' largest difference,
    and ``tie``: every hypothesis kept by one path alone is a cut tie, or the frame has a threshold tie. None when
    the survivors never differ."""
    import torch

    from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device

    x = row_logits[:frames].float()
    stack = x[None].expand(frames, frames, x.shape[-1]).contiguous()
    lens = torch.arange(1, frames + 1, dtype=torch.int32, device=x.device)
    kw = dict(blank=blank, beam_width=LM_WIDTH, prune_logp=prune_logp, nbest=LM_WIDTH)
    card = [{tuple(ids.tolist()): s for ids, s in hyps} for hyps in beam_search_device(stack, lens, **kw)]
    cpu = [{tuple(ids.tolist()): s for ids, s in hyps} for hyps in beam_search_device(stack.cpu(), lens.cpu(), **kw)]
    differ = [a.keys() != b.keys() for a, b in zip(card, cpu)]
    if not any(differ):
        return None
    t = differ.index(True)
    a, b = card[t], cpu[t]
    low_card, low_cpu = min(a.values()), min(b.values())
    tol = (t + 1) * 2.0**-24 * max(abs(low_card), abs(low_cpu))
    margins = [a[k] - low_cpu for k in a.keys() - b.keys()] + [b[k] - low_card for k in b.keys() - a.keys()]
    logp_card, logp_cpu = torch.log_softmax(x[t], -1).cpu().numpy(), torch.log_softmax(x[t].cpu(), -1).numpy()
    flips = np.flatnonzero((logp_card >= prune_logp) != (logp_cpu >= prune_logp))
    shared = a.keys() & b.keys()
    return {"length": t + 1, "kept_by_one_path": len(margins), "margins": margins, "tol": tol,
            "threshold_flips": [(int(v), float(logp_card[v]), float(logp_cpu[v])) for v in flips],
            "shared_max_dev": max((abs(a[k] - b[k]) for k in shared), default=0.0),
            "lengths_differing": int(sum(differ)), "tie": bool(len(flips)) or max(margins) <= tol}


def lm_ranked_rows(logits, out_lengths, blank: int, lm, tag: str) -> dict:
    """The device beam's 16 survivors a row ranked by ``lm``, on the card (the kernels) and on the port's CPU path
    (the plain versions on the CPU, with its own log-softmax and scan arithmetic), ranked as
    ``beam_search_device(lm=...)`` ranks them (acoustic total + ``LM_WEIGHT`` x ``lm_prefix_score``, a stable sort).

    A hypothesis the two paths share scores within ``tol``, the worst-case rounding of a float32 chain of T steps
    (T 2^-24 of the best fused score's magnitude); ``deviation`` is the largest such difference over ``tol``. For a
    row whose best differs, the row's logits and both ranked lists go to ``LM_TIE_DIR/<tag>_row<b>.npz``, and its
    entry of ``differing`` says whether it is a tie: with the same 16 survivors on both paths, a tie of the ranking
    (``gap``, the CPU best's fused score less the card best's on the CPU, at most ``tol``); with different
    survivors, a tie where the scans parted (``lm_parting``)."""
    from pathlib import Path

    from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device, lm_prefix_score

    card = beam_search_device(logits, out_lengths, blank=blank, beam_width=LM_WIDTH, nbest=LM_WIDTH)
    cpu = beam_search_device(logits.cpu(), out_lengths.cpu(), blank=blank, beam_width=LM_WIDTH, nbest=LM_WIDTH)
    lm_scores = {}

    def ranked(hyps):
        out = []
        for ids, acoustic in hyps:
            key = tuple(ids.tolist())
            if key not in lm_scores:
                lm_scores[key] = lm_prefix_score(lm, ids, final=True)
            out.append((key, acoustic, acoustic + LM_WEIGHT * lm_scores[key]))
        return sorted(out, key=lambda h: -h[2])

    equal, survivors_differ, deviation, differing, best = 0, 0, 0.0, [], []
    for b, (card_hyps, cpu_hyps) in enumerate(zip(card, cpu)):
        card_r, cpu_r = ranked(card_hyps), ranked(cpu_hyps)
        best.append(card_r[0][0])
        frames = int(out_lengths[b])
        tol = frames * 2.0**-24 * abs(cpu_r[0][2])
        card_fused, cpu_fused = {k: f for k, _, f in card_r}, {k: f for k, _, f in cpu_r}
        for key in card_fused.keys() & cpu_fused.keys():
            deviation = max(deviation, abs(card_fused[key] - cpu_fused[key]) / tol)
        survivors_differ += card_fused.keys() != cpu_fused.keys()
        if card_r[0][0] == cpu_r[0][0]:
            equal += 1
            continue
        card_best, cpu_best = card_r[0][0], cpu_r[0][0]
        entry = {"row": b, "frames": frames, "tol": tol, "gap": cpu_r[0][2] - cpu_fused.get(card_best, -np.inf),
                 "card_gap": card_r[0][2] - card_fused.get(cpu_best, -np.inf),
                 "card_best_on_cpu_path": card_best in cpu_fused, "cpu_best_on_card": cpu_best in card_fused,
                 "survivors_equal": card_fused.keys() == cpu_fused.keys(),
                 "card_top3": [(len(k), a, f) for k, a, f in card_r[:3]],
                 "cpu_top3": [(len(k), a, f) for k, a, f in cpu_r[:3]]}
        if entry["survivors_equal"]:
            entry["tie"] = entry["gap"] <= tol  # the ranking's tie: the same 16 survivors
        else:  # the scans kept different survivors: where they parted must be a rounding tie
            entry["parting"] = lm_parting(logits[b], frames, blank)
            entry["tie"] = entry["parting"] is not None and entry["parting"]["tie"]
        dump = Path(__file__).resolve().parent / LM_TIE_DIR / f"{tag}_row{b}.npz"
        dump.parent.mkdir(parents=True, exist_ok=True)
        lists = {}
        for name, r in (("card", card_r), ("cpu", cpu_r)):
            lists[f"{name}_ids"] = np.array([np.pad(np.array(k, np.int32), (0, frames - len(k)), constant_values=-1)
                                             for k, _, _ in r])
            lists[f"{name}_acoustic"] = np.array([a for _, a, _ in r], np.float64)
            lists[f"{name}_fused"] = np.array([f for _, _, f in r], np.float64)
        np.savez(dump, logits=logits[b, :frames].float().cpu().numpy(), **lists)
        entry["dump"] = str(dump.relative_to(dump.parents[2]))
        differing.append(entry)
    return {"equal": equal, "differing": differing, "deviation": deviation, "survivors_differ": survivors_differ,
            "best": best}


def lm_native_build() -> None:
    """Load the native host runtime, building it with g++ on its first use in this process; print the seconds
    (0 once loaded) and the machine's cores."""
    import os

    from thunder_tpu_torch import native

    t0 = time.perf_counter()
    built = native.native_available()
    emit({"phase": "lm_native_build", "seconds": time.perf_counter() - t0, "nproc": os.cpu_count(),
          "available": built, "library": native.library_path().name})
    check(built, "the native runtime did not build")


def lm_native_phase(card: str, device="cuda") -> dict:
    """Phase 24 of the module docstring: the native runtime built, 64 FLAC files read back bit-exact and served
    by QuartzNet15x5, the host backend's C++ beam with a 4-gram token LM held to the numpy search, the device beam
    with word fusion held to the port's CPU path and to the plain versions. Returns the launches of its runs, by
    run, for the kernels line."""
    import tempfile
    from pathlib import Path

    import torch

    from thunder_tpu_torch import native
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.data import load_audio
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.kernels.beam import beam_backtrace, beam_scan
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule, run_beam_decode
    from thunder_tpu_torch.ops.ctc_beam import beam_search_decode, log_softmax
    from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device
    from thunder_tpu_torch.text import BatchTextTransformer, NGramLM, WordFusionLM, WordNGramLM

    runs = {}
    lm_native_build()

    # ---- 64 FLAC files of 15 s, 16-bit, from seed 0 (phase 4's rows), read back through load_audio
    pcm, in_memory, lengths = lm_rows(0)
    samples = pcm.shape[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = []
        for b in range(BATCH):
            paths.append(Path(tmp) / f"row{b:02d}.flac")
            paths[-1].write_bytes(flac_bytes(pcm[b], SAMPLE_RATE))
        write_s = time.perf_counter() - t0
        flac_bytes_total = sum(p.stat().st_size for p in paths)
        t0 = time.perf_counter()
        decoded = [load_audio(p) for p in paths]
        decode_s = time.perf_counter() - t0
    rates = {rate for _, rate in decoded}
    audio = np.concatenate([a for a, _ in decoded])
    exact = rates == {SAMPLE_RATE} and audio.shape == (BATCH, samples) and np.array_equal(audio, in_memory)
    emit({"phase": "lm_native_flac", "files": BATCH, "seconds_each": SECONDS, "bytes": flac_bytes_total,
          "compression": flac_bytes_total / (BATCH * samples * 2), "write_s": write_s, "decode_s": decode_s,
          "audio_s_per_host_s": BATCH * SECONDS / decode_s, "bit_exact": exact, "card": card})
    check(exact, "the FLAC files did not read back bit-equal to the PCM written")

    # ---- QuartzNet15x5 greedy serving of the decoded rows
    tt = BatchTextTransformer(VOCAB)
    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(), QuartznetEncoder(**QN15X5),
                              Conv1dDecoder(len(VOCAB) + 1), tt, device=device)
    fit_bn(module, audio[:8], lengths[:8])
    engine = InferenceEngine(module)
    engine.warmup([BATCH], [SECONDS])
    blank = module.blank_idx
    reset_launch_counts()
    texts = engine.predict(audio, lengths)
    sync(device)
    runs["greedy_from_flac"] = launch_counts()
    check(texts == engine.predict(in_memory, lengths), "transcripts of the FLAC rows differ from the in-memory rows'")
    check(runs["greedy_from_flac"] == expected_counts(fused_log_mel=1, fused_separable_repeat=QN_SEPARABLE),
          f"a greedy predict launched {runs['greedy_from_flac']}")

    # ---- the LMs: a 4-gram over the character vocabulary, word fusion over a word 3-gram
    lines = seeded_lines(LM_LINES)
    t0 = time.perf_counter()
    ngram = NGramLM.from_texts(lines, tt, order=LM_ORDER)
    word_lm = WordNGramLM(order=WORD_LM_ORDER).fit(lines)
    fusion = WordFusionLM(word_lm, tt)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mirrors = ngram.native() is not None and fusion.native() is not None
    mirror_s = time.perf_counter() - t0
    check(mirrors, "an LM has no native mirror")

    # ---- the host backend: the C++ beam with the 4-gram fused inside it, against the numpy search
    host_kw = dict(beam_width=LM_WIDTH, beam_backend="host", lm=ngram, lm_weight=LM_WEIGHT)
    reset_launch_counts()
    t0 = time.perf_counter()
    host_texts = engine.predict(audio, lengths, **host_kw)
    host_predict_ms = (time.perf_counter() - t0) * 1e3
    runs["host_beam_lm"] = launch_counts()
    check(runs["host_beam_lm"] == runs["greedy_from_flac"], f"a host-beam predict launched {runs['host_beam_lm']}")
    logits, _, out_lengths = engine.infer(torch.as_tensor(audio, device=device), torch.as_tensor(lengths, device=device))
    served = logits.float().cpu().numpy()
    served_lengths = out_lengths.cpu().numpy()
    served_ids = beam_search_decode(served, served_lengths, blank=blank, beam_width=LM_WIDTH, lm=ngram,
                                    lm_weight=LM_WEIGHT)
    check(host_texts == [tt.decode_prediction(h[None], remove_repeated=False)[0] if len(h) else "" for h in served_ids],
          "the host predict's texts differ from the C++ beam on its own logits")
    numpy_served, served_numpy_s, served_pool_s = numpy_rows(served, served_lengths, blank, lines, use_lm=True)
    served_equal = [a.tolist() == b for a, b in zip(served_ids, numpy_served)]
    peaked = peaked_logits(np.random.default_rng(0), BATCH, served.shape[1], served.shape[2], blank)
    timings = {}
    for name, lm in (("lm", ngram), ("no_lm", None)):
        decode = lambda lm=lm, use_native=True: beam_search_decode(  # noqa: E731
            peaked, blank=blank, beam_width=LM_WIDTH, lm=lm, lm_weight=LM_WEIGHT, use_native=use_native)
        ids = decode()
        numpy_ids, numpy_s, pool_s = numpy_rows(peaked, [peaked.shape[1]] * BATCH, blank, lines, use_lm=lm is not None)
        lp = log_softmax(peaked[:NUMPY_ROWS])
        native_lm = lm.native() if lm is not None else None
        one_thread = lambda: native.native_ctc_beam_search_batch(  # noqa: E731
            lp, [lp.shape[1]] * NUMPY_ROWS, blank, LM_WIDTH, -12.0, max_tokens_per_step=50, lm=native_lm,
            lm_weight=LM_WEIGHT if native_lm is not None else 0.0, n_threads=1)
        timings[name] = {"native_ms_64_rows_threaded": host_ms(decode),
                         f"native_ms_{NUMPY_ROWS}_rows_one_thread": host_ms(one_thread),
                         f"numpy_ms_{NUMPY_ROWS}_rows_one_core_each_summed": numpy_s * 1e3,
                         "numpy_pool_wall_s": pool_s,
                         "rows_equal": [a.tolist() == b for a, b in zip(ids, numpy_ids)],
                         "native_equals_its_batch_on_rows": [a.tolist() == b.tolist() for a, b in zip(ids, one_thread())]}
    emit({"phase": "lm_native_host", "B": BATCH, "T": served.shape[1], "V": served.shape[2], "W": LM_WIDTH,
          "lm": f"NGramLM order {LM_ORDER} on {LM_LINES} seeded lines", "lm_weight": LM_WEIGHT, "fit_s": fit_s,
          "mirror_s": mirror_s, "predict_ms_host_clock": host_predict_ms, "served_rows_equal": served_equal,
          "served_numpy_ms_summed": served_numpy_s * 1e3, "served_numpy_pool_wall_s": served_pool_s,
          "peaked": timings, "card": card})
    check(all(served_equal), f"the C++ beam differs from the numpy search on served rows: {served_equal}")
    for name, t in timings.items():
        check(all(t["rows_equal"]) and all(t["native_equals_its_batch_on_rows"]),
              f"the C++ beam differs from the numpy search on peaked rows ({name}): {t['rows_equal']}")

    # ---- the device backend: the beam kernels, word fusion ranking the surviving beams on the host
    device_kw = dict(beam_width=LM_WIDTH, beam_backend="device", lm=fusion, lm_weight=LM_WEIGHT)
    engine.predict(audio, lengths, **device_kw)  # warms the path
    reset_launch_counts()
    device_texts = engine.predict(audio, lengths, **device_kw)
    sync(device)
    runs["device_beam_word_fusion"] = launch_counts()
    want = expected_counts(fused_log_mel=1, fused_separable_repeat=QN_SEPARABLE, beam_scan=1, beam_backtrace=1)
    check(runs["device_beam_word_fusion"] == want,
          f"a device-beam predict with word fusion launched {runs['device_beam_word_fusion']}")
    beam_args = dict(blank=blank, text_transform=tt, beam_width=LM_WIDTH, nbest=None, prune_logp=-12.0, lm=fusion,
                     lm_weight=LM_WEIGHT, backend="device")
    with plain_beam():
        plain_texts = run_beam_decode(logits, out_lengths, **beam_args)
    plain_equal = sum(a == b for a, b in zip(device_texts, plain_texts))
    # the port's CPU path: its own log-softmax and scan arithmetic in float32 (``lm_ranked_rows``)
    cpu_path = lm_ranked_rows(logits, out_lengths, blank, fusion, "phase")
    check([tt.decode_prediction(np.array(k, np.int32)[None], remove_repeated=False)[0] if k else ""
           for k in cpu_path["best"]] == device_texts, "the card's ranking differs from the device-beam predict's")
    fused = lambda: beam_search_device(logits, out_lengths, blank=blank, beam_width=LM_WIDTH, lm=fusion,  # noqa: E731
                                       lm_weight=LM_WEIGHT)
    bare = lambda: beam_search_device(logits, out_lengths, blank=blank, beam_width=LM_WIDTH)  # noqa: E731
    bare_wide = lambda: beam_search_device(logits, out_lengths, blank=blank, beam_width=LM_WIDTH, nbest=LM_WIDTH)  # noqa: E731
    logp = torch.log_softmax(logits.float(), dim=-1)
    scan = lambda: beam_scan(logp, out_lengths, -12.0, blank=blank, beam_width=LM_WIDTH, k_tokens=50)  # noqa: E731
    parents, exts, total, _ = scan()
    slots = torch.argsort(-total, dim=1, stable=True).to(torch.int32)
    walk = lambda: beam_backtrace(parents, exts, slots)  # noqa: E731
    fused_ms, bare_ms, wide_ms = host_ms(fused, repeats=1), host_ms(bare), host_ms(bare_wide)
    emit({"phase": "lm_native_device", "B": BATCH, "W": LM_WIDTH,
          "lm": f"WordFusionLM over a word {WORD_LM_ORDER}-gram of {len(word_lm.words)} words", "lm_weight": LM_WEIGHT,
          "rows_equal_to_cpu_path": cpu_path["equal"], "rows_differing_on_cpu_path": cpu_path["differing"],
          "rows_whose_survivors_differ_on_cpu_path": cpu_path["survivors_differ"],
          "max_score_deviation_over_tol": cpu_path["deviation"], "rows_equal_to_plain_versions": plain_equal,
          "decode_lm_ms_host_clock": fused_ms, "decode_ms_host_clock": bare_ms,
          "decode_every_beam_ms_host_clock": wide_ms, "lm_ranking_ms_host_clock": fused_ms - wide_ms,
          "decode_ms": cuda_ms(bare, 3), "scan_ms": cuda_ms(scan, 5), "backtrace_every_slot_ms": cuda_ms(walk, 5),
          "card": card})
    check(cpu_path["deviation"] <= 1.0,
          f"a hypothesis scores {cpu_path['deviation']} times the float32 chain's rounding apart on the CPU path")
    check(all(row["tie"] for row in cpu_path["differing"]),
          f"the device beam with word fusion differs from the CPU path past a tie: {cpu_path['differing']}")
    check(plain_equal == BATCH, f"the device beam with word fusion differs from the plain versions on "
                                f"{BATCH - plain_equal} rows")
    return runs


def lm_tie_search(card: str, trials: int) -> int:
    """``python3 chip_smoke.py --lm-ties N``: phase 24's device beam with word fusion against the port's CPU path
    (``lm_ranked_rows``) on the rows of seeds 0 to N - 1 (seed 0: the phase's own rows, served twice to show whether
    the card's logits repeat bit for bit), QuartzNet15x5 and the LMs built as in the phase, the card's float32
    products at PyTorch's defaults (as when the phase runs alone). One line a seed, then the totals; every row
    whose best differs is dumped (``LM_TIE_DIR``). Exits 1 when such a row is not a tie."""
    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import _build
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer, WordFusionLM, WordNGramLM

    _build.load()
    tt = BatchTextTransformer(VOCAB)
    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(), QuartznetEncoder(**QN15X5),
                              Conv1dDecoder(len(VOCAB) + 1), tt, device="cuda")
    _, audio, lengths = lm_rows(0)
    fit_bn(module, audio[:8], lengths[:8])
    engine = InferenceEngine(module)
    fusion = WordFusionLM(WordNGramLM(order=WORD_LM_ORDER).fit(seeded_lines(LM_LINES)), tt)
    totals = {"rows": 0, "equal": 0, "differing": 0, "ties": 0, "survivors_differ": 0, "max_deviation": 0.0}
    for seed in range(trials):
        _, audio, lengths = lm_rows(seed)
        audio_d, lengths_d = torch.as_tensor(audio, device="cuda"), torch.as_tensor(lengths, device="cuda")
        logits, _, out_lengths = engine.infer(audio_d, lengths_d)
        line = {"phase": "lm_ties", "seed": seed}
        if seed == 0:
            line["logits_repeat_bit_for_bit"] = bool(torch.equal(logits, engine.infer(audio_d, lengths_d)[0]))
        t0 = time.perf_counter()
        rows = lm_ranked_rows(logits, out_lengths, module.blank_idx, fusion, f"seed{seed}")
        emit({**line, "seconds": time.perf_counter() - t0, "equal": rows["equal"], "differing": rows["differing"],
              "survivors_differ": rows["survivors_differ"], "max_deviation_over_tol": rows["deviation"]})
        totals["rows"] += BATCH
        totals["equal"] += rows["equal"]
        totals["differing"] += len(rows["differing"])
        totals["ties"] += sum(row["tie"] for row in rows["differing"])
        totals["survivors_differ"] += rows["survivors_differ"]
        totals["max_deviation"] = max(totals["max_deviation"], rows["deviation"])
    emit({"phase": "lm_ties_total", "seeds": trials, **totals, "card": card})
    return 0 if totals["ties"] == totals["differing"] and totals["max_deviation"] <= 1.0 else 1


def add_lm_native_launches(kernels: list, runs: dict) -> None:
    """Each kernel's launches in phase 24's runs (0 for those they do not reach)."""
    for entry in kernels:
        entry["lm_native_launches"] = {run: sum(c[w] for w in ENTRY_WRAPPERS[entry["name"]]) for run, c in runs.items()}

if __name__ == "__main__":
    sys.exit(main())
