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
    rows 0-1, within ``W2V_TRAIN_LOSS_BOUND`` (the extractor trained too,
    ``--no-freeze``, is phase 38);
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
    give their launches in this phase's runs (``lm_native_launches``);
25. ``streaming``: ``StreamingTranscriber`` on phase 4's QuartzNet15x5 engine
    built ``batch_invariant`` and on its ``CTCModule``, one 60 s speech-like
    clip each, fed in pushes of 800 to 20,000 samples (numpy seed), greedy and
    with the device beam (W = 16), at (chunk, overlap) = (0.5, 0.125), (1,
    0.25), (2, 0.5) and (20, 2) s on the engine, (2, 0.5) and (20, 2) s on the
    module: each ``flush()`` must equal the same predictor's ``predict_long`` on
    that grid, every greedy partial must be a prefix of it (the beam's
    partials may be revised: counted, not checked), and the launches must be
    1 log-mel (+ 77 separable repeats on the engine) a window, + 1
    ``beam_scan`` and 1 ``beam_backtrace`` with the device beam; the device
    beam's window as it is and padded to its 64-frame bucket must give the
    same beams; a row of a 64 x 1 s forward of the engine must be bit-equal to
    the same row served alone, stage by stage (``streaming_batch_invariance``,
    which also prints the default engine's rows and both engines' forward at
    64 x 15 s); a ``StreamingPool(batch_size=64)`` on the engine, 64 streams
    of 60 s (8 distinct clips, stream k feeding clip k % 8) fed round-robin in
    pushes of 1,600 samples (100 ms) at (1, 0.25) and (2, 0.5) s, greedy and
    with the device beam, and at (2, 0.5) once more from 8 threads: every
    stream's text must equal that of a lone ``StreamingTranscriber`` on its
    clip (one push, then ``flush``), with 1 log-mel + 77
    separable launches a forward and one scan and backtrace a window a
    stream with the device beam; the forward of one drain is timed with CUDA
    events; two 30 s streams with the device beam ranked by word fusion
    (phase 24's LM) must equal ``predict_long`` with it. Push latencies
    (p50, p99, host clock) of the pushes that complete a window (lone) or run
    a forward (pool), and the sustained RTF (audio seconds over wall
    seconds), are printed. The kernels line's ``streaming_launches``;
26. ``align``: ``CTCModule.align`` of 64 seeded transcripts of 20-120
    characters on 64 x 15 s (T = 751; 1 log-mel launch): the card's Viterbi
    states and scores must equal the plain CPU run of ``ctc_forced_align``
    on the card's float32 log-probs bit for bit, every score must be finite,
    the spans ordered within the clip, 64 subtitle documents rendered, a
    text too long for its frames ``-inf``, and ``torch.argmax`` on the card
    must take the first of tied choices; the forward and the Viterbi are timed
    apart (CUDA events), the Viterbi's device kernels counted by the
    profiler (``align_launches``);
27. ``profiling``: ``profiling.trace`` around one engine forward at 64 x 15 s
    with an ``annotate("serve")`` span: the written Chrome trace must hold the
    span, 1 log-mel kernel and 77 separable repeats in one of
    ``TRACE_TAKES`` takes (each take's launch calls without a kernel record,
    in ``trace``'s warm-up and in the block, are printed); ``StepTimer`` over 10 synchronized forwards, timed
    before the traces and after a ``gc.collect()``, must give an RTF within
    ``STEP_TIMER_RTF_TOL`` of phase 4's measurement taken again in the phase
    (CUDA events over 10 forwards, the mean of one taken before and one after
    the steps; each step's time and the card's clocks printed beside it)
    (``profiling_launches``);
28. ``cli``: ``python -m thunder_tpu_torch`` in subprocesses on the card, no
    ``--device``, on a ``.nemo`` of phase 4's module (``write_nemo``), a 15 s
    WAV, a 60 s WAV and a 15 s FLAC: ``transcribe`` (the module with
    ``--timestamps``; ``--engine``; ``--engine --beam-width 16 --beam-backend
    device``) must print the in-process API's records, ``eval`` of an 8-item
    manifest the in-process WER and CER, ``train`` one epoch and exit 0,
    ``export`` a bundle that serves the source module's logits bit for bit;
    with ``CUDA_VISIBLE_DEVICES=`` the CLI must exit non-zero
    (``cli_launches``, counted in each subprocess);
29. ``mesh``: a one-rank mesh (``thunder_tpu_torch.parallel.make_mesh``)
    over an NCCL process group set up through ``init_process_group`` with a
    ``FileStore`` under ``smoke_out/``: ``Trainer(mesh=...)`` trains
    QuartzNet15x5 (the training phase's configuration: dropout 0.1, dither,
    SpecAugment) for 3 steps at 16 x 15 s; each loss, every parameter and
    every running statistic must equal the meshless trainer's from the same
    state and generator bit for bit, with the same launches (1 log-mel, 1
    ``ctc_alpha``, 1 ``ctc_beta`` a step). Both trainers run with
    deterministic algorithms (``deterministic_algorithms``): with PyTorch's
    defaults two meshless runs differ (cuDNN's backward and the gathers'
    scatter-adds sum in no fixed order); ``InferenceEngine(mesh=...)`` on
    phase 4's module and batch (64 x 15 s), greedy and with the device beam
    (W = 16), must give the meshless engine's transcripts and logits (SHA-256)
    with the same launches (1 + 77, + 1 scan + 1 backtrace); the forward is
    timed against the meshless one (CUDA events, mean of 5, in turns:
    meshless, mesh, mesh, meshless; phase 41 times the train steps)
    (``mesh_launches``);
30. ``row_offsets``: the training kernels at the wav2vec2 step's shape (8 x
    749, 12 heads, D 768, rate 0.1) on 2 and 4 slices of the batch, each with
    its rows' offset, against the whole batch's launches: the keep mask, the
    add + dropout + LayerNorm output, dx and dy, the attention output, its
    statistics and the packed dqkv bit for bit, the slices' summed dscale and
    dbias within 1 %, and each slice within ``TRAIN_KERNEL_ULP`` of the plain
    versions with the same offsets;
31. ``citrinet_batch_invariance``: Citrinet-256 (phase 12's weights) on an
    engine built ``batch_invariant``: a row of a 64 x 1 s forward must be
    bit-equal to the same row alone, stage by stage (the log-mel, the
    frontend, every separable repeat, the squeeze-excite gates, the strided
    1x1 residuals, the decoder: ``citrinet_streaming_batch_invariance``, which
    also prints the default engine's parting rows and times both engines at
    64 x 15 s in turns); a ``StreamingPool(batch_size=64)`` of 64 streams of
    60 s over 8 clips at (2, 0.5) s, greedy and with the device beam (W =
    16), must give each stream its lone stream's text, with 1 log-mel + 107
    separable launches a forward (``citrinet_pool_launches``);
32. ``parting_rows``: at 64 x 1 s, the rows of a batch that part from the same
    row served alone, and their argmax flips, on the wav2vec2-base engine and
    on phase 4's QuartzNet ``CTCModule`` (the module predictor of a pool):
    counted and printed, not checked; then ``w2v2_batch_invariance``: on
    wav2vec2-base and WavLM engines built ``batch_invariant`` (a forward one
    row at a time) no row may part, and each is timed against the default
    engine at 64 x 1 s (CUDA events, in turns: default, invariant, invariant,
    default); a ``StreamingPool(batch_size=64)`` of 64 streams over 8 clips on
    the wav2vec2-base engine, greedy and with the device beam (W = 16), must
    give each stream its lone stream's text, with 12 attention + 25 add +
    LayerNorm launches a window's row, none for the forwards' padding rows
    (``w2v2_pool_launches``);
33. ``w2v2_variant``: the wav2vec2 family's variants at their published
    widths with random weights (seed 22), each on a bf16 ``InferenceEngine``
    at 16 x 15 s of speech-like audio: WavLM (``transformers.WavLMConfig()``:
    12 x 768, 320 buckets, distance 800, group norm, post-LN), data2vec-audio
    (``Data2VecAudioConfig()``: 5 positional convs of kernel 19 in 16 groups,
    a layer-norm extractor), SEW (``SEWConfig()``: squeeze 2, its 13-conv
    extractor), the conv adapter on wav2vec2-base's width (3 GLU convs of
    stride 2) and MMS-1b-all's width (1,280 hidden, 16 heads of 80, FFN
    5,120, stable LN, a layer-norm extractor, attention adapters of 16; 12
    of its 48 layers, ``MMS_LAYERS``). One forward must launch the add + LayerNorm and attention
    kernels the code predicts (``variant_launches``: 2 a post-LN layer + 1,
    SEW's plain encoder LayerNorm aside; one attention a layer where dh is 64
    or 80 and no position bias: 12 for MMS-1b, at dh 80); the logits must be finite, of the expected shape
    (the adapter's frames ``(L - 1) // 2 + 1`` three times), within
    ``LOGIT_BOUND`` of the same engine under ``plain_wav2vec2`` and, on rows
    0-1, of the module's float32 forward on the card; the forward's ms (CUDA
    events, mean of 3), peak memory and one forward's device profile are
    printed (``variants_launches``);
34. ``w2v2_variant_kernel_shape``: the attention and add + LayerNorm kernels
    on the inputs SEW's and the conv-adapter model's forwards give layer 0
    (SEW's at the squeezed length), and the dh-80 attention on MMS-1b's
    (``mha_from_qkv_dh80``, 16 x 749 x 16 heads; its stable LN has no add +
    LayerNorm kernel), against their plain versions (4 and 2
    bf16 ULP) and timed with them in turns (host-paced), beside their PyTorch
    calls (SDPA with the key mask; ``F.layer_norm``), timed only;
35. ``w2v2_large_serving``: wav2vec2-large-960h (``W2V_LARGE``: 24 post-LN
    layers of 1,024 in 16 heads of 64, FFN 4,096, the group-norm extractor
    without conv biases, 32 classes; random weights, seed ``W2V_CELL_SEED``)
    on a bf16 ``InferenceEngine`` at 16 x 15 s (T 749) and 8 x 30 s (T
    1499) of speech-like audio: one forward must launch 24 attention and 49
    add + LayerNorm kernels, its logits finite and of their shape, rows 0-1
    within ``LOGIT_BOUND`` of the module's float32 forward on the card; the
    forward's ms (CUDA events, mean of ``W2V_CELL_TIMED``), peak memory,
    model FLOPs (``flops.wav2vec2_forward_flops``) and MFU against
    ``flops.peak_flops()`` (which must be 989e12 on "NVIDIA H100 80GB HBM3");
    one profiled forward at 16 x 15 s; both kernels on layer 0's inputs at
    each shape against their plain versions (4 and 2 bf16 ULP), timed beside
    them and their PyTorch calls (the attention at 16 x 749 and 8 x 1499, 16
    heads; the add + LayerNorm at 11,984 and 11,992 x 1,024);
36. ``w2v2_serving_30s``: wav2vec2-base through the same checks at 8 x 30 s
    (12 + 25 launches);
37. ``w2v2_large_training``: wav2vec2-large-960h's widths in CTC training at
    8 x 15 s (``w2v2_train_create``: the extractor frozen, dropout 0.1, bf16
    compute, AdamW lr 1e-4, phase 10's noise audio and text): one
    ``Trainer.fit`` step must launch 24 + 48 ``mha_train``, 49 + 98 add +
    dropout + LayerNorm, 1 ``ctc_alpha`` and 1 ``ctc_beta``; 8 steps, the last
    5 timed (CUDA events), every loss finite and the 8th below ``1 -
    W2V_LOSS_FALL`` times the first; the extractor decays by lr x wd a step;
    one profiled step; the train-mode loss with every dropout rate 0, bf16 on
    the card, within ``W2V_TRAIN_LOSS_BOUND`` of float32 on the CPU on rows
    0-1; step ms, peak memory, model FLOPs (``flops.wav2vec2_train_flops``,
    ``frozen_extractor=True``) and MFU; the training kernels on layer 0's
    inputs of a step (8 x 749, 16 heads; 5,992 x 1,024) against their plain
    versions (8 bf16 ULP; 1 % for dscale and dbias), timed beside them and
    their PyTorch calls;
38. ``w2v2_training_no_freeze``: wav2vec2-base with the extractor trained
    (``--no-freeze``) at 8 x 15 s through phase 37's checks (12 + 24, 25 +
    50, 1 + 1 launches; the 8th loss below ``1 - W2V_NO_FREEZE_LOSS_FALL``
    times the first), and every extractor parameter must receive a nonzero
    gradient and move past the weight decay at the optimizer step; MFU with
    ``frozen_extractor=False``;
39. ``aot_export``: ``export.aot_export`` on the card of phase 4's
    QuartzNet module cut to QuartzNet5x5 (``AOT_QN``: the export and the
    load grow with the graph's nodes; float32) and of a wav2vec2-base module
    with a bf16 encoder, at ``AOT_BATCH`` x ``AOT_SECONDS``, both loaded in one
    fresh ``python3`` by ``aot_load`` alone (``AOT_RUNNER``, float32 in full
    as this process runs it) to serve the phase's audio: ``preds`` and lengths bit-equal (SHA-256) to the live module's
    ``infer``, with its launches per call (1 log-mel; 12 + 25); export
    seconds, artifact bytes, load seconds, a call's ms beside the live
    module's (synchronized calls, host clock). The kernels line's entries
    give their launches in phases 35-39 (``w2v2_cells_launches``) and their
    lines at phase 35's and 37's shapes (``large_shapes``).
40. ``train_scan``: ``Trainer(steps_per_execution=4).fit`` against
    ``Trainer(steps_per_execution=1).fit`` from the same weights and
    generator seed, under ``deterministic_algorithms()``, at full width
    (AdamW lr 1e-4): QuartzNet15x5 at 16 x 15 s (4 batches of 15 s and one
    of 12 s), the same with ``remat``, accumulation 2, the norm clip and
    ``onecycle`` (4 batches), Citrinet-256 (4) and wav2vec2-base at 8 x 15 s
    (frozen extractor, dropout 0.1; 4). Each graphed run must equal its K = 1
    run bit for bit (per-step losses, parameters, running statistics,
    optimizer state, generator state), replay every step past its kind's
    first, and make the fixed launches a step (1 log-mel and 1 + 1 CTC; 12 +
    24 ``mha_train``, 25 + 50 add + dropout + LayerNorm, 1 + 1 CTC), counted
    through capture and replay (``train_scan_launches``); phase 41 times
    the steps;
41. ``mesh_scan``: ``Trainer(mesh=..., steps_per_execution=4).fit`` on a
    one-rank NCCL mesh (phase 29's ``FileStore`` group, ``one_rank_group``),
    its steps CUDA graph replays with the collectives captured, against the
    eager mesh fit (K = 1) and the meshless graphed fit (K = 4), under
    ``deterministic_algorithms()``: QuartzNet15x5 at 16 x 15 s (5 batches:
    a chunk and a leftover that replays), the same with ``remat``,
    accumulation 2, the norm clip and ``onecycle`` (4 batches: micro steps
    without the gradients' sum, updates with it), Citrinet-256 (4) and
    wav2vec2-base at 8 x 15 s (frozen extractor, dropout 0.1; 4), the three
    fits bit-equal in per-step losses, parameters, running statistics,
    optimizer and generator state; every mesh step past its kind's first a
    replay; the fixed launches a step, counted through capture and replay
    (``mesh_scan_launches``).
    Then ``rows_step`` as rank 0 of a data axis of twice the rows
    (``mesh_scan_emulated_rank0``): 3 padding rows of weight 0, another
    total weight each call, the weighted and the unweighted kind replayed
    bit-equal to the eager steps. Then, with the default algorithms, one
    chunk of 4 steps of QuartzNet15x5 (the host-bound model; Citrinet-256's
    and wav2vec2-base's chunks are no longer timed, for the whole run's
    time) in turns (meshless K = 1, mesh K = 1, mesh K = 4, meshless K = 4, and
    back): step ms (CUDA
    events over the chunk, over 4), host ms a step, peak memory allocated,
    each graph's pool, and one more chunk's idle share under the profiler
    (``mesh_scan_timing``);
42. ``mms_training``: MMS-1b-all's widths (phase 33's ``mms_1b``, 12 of its
    48 layers) in CTC training at 8 x 15 s through phase 37's checks with
    ``attention_dropout`` 0 (hidden and feature-projection dropout 0.1, the
    extractor frozen): the rate at which the JAX module trains on its flash
    kernel, and at which heads of 80 train on the port's kernels. One
    ``Trainer.fit`` step must launch 12 + 24 ``mha_train`` (dh 80), 1
    ``ctc_alpha`` and 1 ``ctc_beta`` (stable LN: no add + LayerNorm kernel);
    the 8th loss below ``1 - W2V_LOSS_FALL`` times the first; the train-mode
    loss with every dropout rate 0 within ``W2V_TRAIN_LOSS_BOUND`` of float32
    on the CPU (rows 0-1); step ms, peak memory, MFU; the dh-80 training
    kernels on layer 0's inputs of a step (8 x 749, 16 heads of 80, rate 0)
    against their plain versions (8 bf16 ULP), timed beside them and SDPA
    forward + backward (the kernels line's ``mha_train_dh80``).

Every profile (``device_profile``) must hold each launch of the port's
kernels that the launch counters saw during the profiled call; a trace that
misses some is taken again (``records_complete``, ``attempts``).

Every kernel's ``bound_ms`` is computed from this run's shapes: the largest
of its bytes (each input read once, each output written once) over 3.35
TB/s and its operations of each type over the published peak for that type
(989 TFLOP/s bf16 tensor, 67 TFLOP/s float32), for an H100 SXM at 700 W.
The log-mel's operations are an FFT-based STFT's, the least the function
needs; its bytes are the audio in, the log-mel out and the kernel's tables. The training attention's
are 4 T^2 dh forward and 10 T^2 dh backward a head and row (five products, the
least the function needs, whatever the kernels recompute).

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
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
    ("attention_train", ("mha_forward_kernel<true", "mha_forward_kernel<(bool)1", "mha_train_dq_kernel",
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


def attention_bound(batch: int, t: int, heads: int, dh: int = 64) -> dict:
    """qkv in and the output out (bf16, plus the int32 lengths); q k^T and P V on the bf16 tensor cores."""
    h = heads * dh
    return bound(2 * batch * t * 4 * h + 4 * batch, bf16_flop=4.0 * batch * heads * t * t * dh)


def add_ln_bound(rows: int, d: int) -> dict:
    """x and y in, the output out (bf16), scale and bias in (float32); about 8 float32 operations a value."""
    return bound(3 * 2 * rows * d + 2 * 4 * d, f32_flop=8.0 * rows * d)


def attention_train_bounds(batch: int, t: int, heads: int, dh: int = 64) -> tuple[dict, dict]:
    """Forward: qkv in, the output out, two products. Backward: qkv, o and do in, dqkv out, five products
    (dP, dS K, dS^T q, Pd^T dO' and the scores), whatever the kernels recompute."""
    h = heads * dh
    pairs = batch * heads * float(t) * t * dh
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


def gpu_clocks() -> str:
    """The card's SM clock, power draw and temperature now, as nvidia-smi reads them."""
    cmd = ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"]
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


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
    add_launches(kernels, "loading_launches", loading_phase(card))

    # ---- the rest of training: remat on the three encoders, the trainer's features, the learning gate
    training_runs = {f"remat_{name}": counts for name, counts in training_remat_phase(card).items()}
    training_runs["trainer_features_run_a"] = trainer_features_phase(card)
    training_runs["learning_gate"] = learning_gate_phase(card)
    add_launches(kernels, "training_launches", training_runs)

    # ---- language-model decoding and the native host runtime: FLAC files, the C++ beam, word fusion
    add_launches(kernels, "lm_native_launches", lm_native_phase(card))

    # ---- the user-facing entry points: streaming, forced alignment, profiling, the CLI
    add_launches(kernels, "streaming_launches", streaming_phase(card))
    add_launches(kernels, "align_launches", align_phase(card))
    add_launches(kernels, "profiling_launches", profiling_phase(card))
    add_launches(kernels, "cli_launches", cli_phase(card))

    # ---- the device mesh, the training kernels' row offsets, Citrinet's batch invariance, the parting rows
    add_launches(kernels, "mesh_launches", mesh_phase(card))
    row_offset_phase(card)
    add_launches(kernels, "citrinet_pool_launches", citrinet_invariance_phase(card))
    add_launches(kernels, "w2v2_pool_launches", parting_rows_phase(card))

    # ---- the wav2vec2 family's variants at their published widths, and the kernels at their shapes
    variant_runs, variant_shapes = variants_phase(card)
    add_launches(kernels, "variants_launches", variant_runs)
    for entry in kernels:
        if entry["name"] in variant_shapes:
            entry["variant_shapes"] = variant_shapes[entry["name"]]

    # ---- wav2vec2-large-960h served and trained, wav2vec2-base at 8 x 30 s and with its extractor trained, and
    # the exported predict graph loaded in a fresh process
    cell_runs, cell_shapes = w2v2_cells(card)
    add_launches(kernels, "w2v2_cells_launches", cell_runs)
    for entry in kernels:
        if entry["name"] in cell_shapes:
            entry["large_shapes"] = cell_shapes[entry["name"]]

    # ---- Trainer(steps_per_execution=4): K train steps a dispatch as CUDA graph replays, against K = 1; then on
    # a one-rank NCCL mesh, the collectives captured, against the eager mesh and the meshless graphs
    add_launches(kernels, "train_scan_launches", train_scan_phase(card))
    add_launches(kernels, "mesh_scan_launches", mesh_scan_phase(card))

    # ---- MMS-1b's widths trained at attention dropout 0; the dh-80 kernels' entries, from phases 33-34 and 42
    mms_runs, mms_line = mms_training_phase(card)
    add_launches(kernels, "mms_training_launches", {"mms_training": mms_runs})
    kernels.extend(dh80_kernel_entries(variant_runs["mms_1b"], variant_shapes["mha_from_qkv_dh80"][0], mms_runs,
                                       mms_line, checks))

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
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.optim import adamw
    from thunder_tpu_torch.training.trainer import Trainer, TrainStep, _encode_targets

    tt = BatchTextTransformer(VOCAB)
    bf16 = torch.bfloat16
    rate = 0.1

    def create(device, dtype, dropout: float):
        return w2v2_train_create({}, device, dtype, dropout, freeze=True)

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
    captured = layer0_step_inputs(model, step, batch, generator)
    layer0 = model.encoder.layer0

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


def numpy_pool(lines: list):
    """NUMPY_ROWS spawned worker processes for :func:`numpy_rows`, each with the token LM fitted on ``lines``:
    one pool for the phase's three searches, so that each worker imports the port once."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(NUMPY_ROWS, mp_context=multiprocessing.get_context("spawn"),
                                                  initializer=_numpy_worker_init, initargs=(lines, VOCAB, LM_ORDER))


def numpy_rows(pool, logits: np.ndarray, lengths, blank: int, use_lm: bool) -> tuple:
    """The numpy search of rows 0 to ``NUMPY_ROWS`` - 1, one a worker of ``pool`` (:func:`numpy_pool`): their
    ids, the sum of the rows' seconds (one core each) and the wall seconds."""
    t0 = time.perf_counter()
    jobs = [(np.asarray(logits[b], np.float32), int(lengths[b]), blank, use_lm) for b in range(NUMPY_ROWS)]
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
    with numpy_pool(lines) as pool:
        numpy_served, served_numpy_s, served_pool_s = numpy_rows(pool, served, served_lengths, blank, use_lm=True)
        served_equal = [a.tolist() == b for a, b in zip(served_ids, numpy_served)]
        peaked = peaked_logits(np.random.default_rng(0), BATCH, served.shape[1], served.shape[2], blank)
        timings = {}
        for name, lm in (("lm", ngram), ("no_lm", None)):
            decode = lambda lm=lm, use_native=True: beam_search_decode(  # noqa: E731
                peaked, blank=blank, beam_width=LM_WIDTH, lm=lm, lm_weight=LM_WEIGHT, use_native=use_native)
            ids = decode()
            numpy_ids, numpy_s, pool_s = numpy_rows(pool, peaked, [peaked.shape[1]] * BATCH, blank,
                                                    use_lm=lm is not None)
            lp = log_softmax(peaked[:NUMPY_ROWS])
            native_lm = lm.native() if lm is not None else None
            one_thread = lambda: native.native_ctc_beam_search_batch(  # noqa: E731
                lp, [lp.shape[1]] * NUMPY_ROWS, blank, LM_WIDTH, -12.0, max_tokens_per_step=50, lm=native_lm,
                lm_weight=LM_WEIGHT if native_lm is not None else 0.0, n_threads=1)
            timings[name] = {"native_ms_64_rows_threaded": host_ms(decode, repeats=1),
                             f"native_ms_{NUMPY_ROWS}_rows_one_thread": host_ms(one_thread, repeats=1),
                             f"numpy_ms_{NUMPY_ROWS}_rows_one_core_each_summed": numpy_s * 1e3,
                             "numpy_pool_wall_s": pool_s,
                             "rows_equal": [a.tolist() == b for a, b in zip(ids, numpy_ids)],
                             "native_equals_its_batch_on_rows": [a.tolist() == b.tolist()
                                                                 for a, b in zip(ids, one_thread())]}
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


def add_launches(kernels: list, key: str, runs: dict) -> None:
    """Each kernel entry's launches in a phase's runs, by run, under ``key`` (0 for the runs it does not reach)."""
    for entry in kernels:
        entry[key] = {run: sum(c[w] for w in ENTRY_WRAPPERS[entry["name"]]) for run, c in runs.items()}


# ---- phases 25-28: streaming, forced alignment, profiling, the CLI

STREAM_SECONDS = 60.0
STREAM_GRIDS = ((0.5, 0.125), (1.0, 0.25), (2.0, 0.5), (20.0, 2.0))  # (chunk, overlap) seconds of the lone streams
MODULE_GRIDS = STREAM_GRIDS[2:]  # the module's lone streams (a window's float32 forward of one row costs 30-136 ms)
POOL_GRIDS = ((1.0, 0.25), (2.0, 0.5))
POOL_BATCH = 64  # the pool's rows a forward, and its streams
POOL_CLIPS = 8  # distinct clips among the pool's streams (stream k feeds clip k % POOL_CLIPS), each a lone reference
POOL_PUSH = 1600  # samples a push: 100 ms, a microphone's buffer
POOL_THREADS = 8
STREAM_BEAM = dict(beam_width=LM_WIDTH, beam_backend="device")
FUSION_STREAMS, FUSION_SECONDS, FUSION_GRID = 2, 30.0, (2.0, 0.5)
ALIGN_CHARS = (20, 120)  # the seeded transcripts' lengths
STEP_TIMER_FORWARDS, STEP_TIMER_RTF_TOL = 10, 0.10
TRACE_TAKES = 6  # takes of the profiling phase's trace, of which one must hold every kernel record


def served_quartznet(device, batch_invariant: bool = False, encoder: dict = QN15X5):
    """Phase 4's QuartzNet15x5 (seed 0; BN by ``fit_bn`` on the first 8 rows of phase 4's batch; ``encoder`` the
    encoder's arguments), its engine (with ``batch_invariant``), and phase 4's batch (``BATCH`` rows of
    ``SECONDS``)."""
    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    rng = np.random.default_rng(0)
    samples = int(SECONDS * SAMPLE_RATE)
    base = speech_like(samples, rng)
    rows = np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(BATCH)])
    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(), QuartznetEncoder(**encoder),
                              Conv1dDecoder(len(VOCAB) + 1), BatchTextTransformer(VOCAB), device=device)
    fit_bn(module, rows[:8], np.full((len(rows[:8]),), samples, np.int32))
    return module, InferenceEngine(module, batch_invariant=batch_invariant), rows


def stream_clips(n: int, seconds: float, seed: int) -> list:
    """``n`` speech-like clips of ``seconds``: one signal from ``seed``, each clip shifted by its own offset and
    scaled by its own gain."""
    rng = np.random.default_rng(seed)
    base = speech_like(int(seconds * SAMPLE_RATE), rng)
    return [(np.roll(base, int(rng.integers(0, base.size))) * (0.7 + 0.6 * rng.random())).astype(np.float32)
            for _ in range(n)]


def grid_windows(samples: int, chunk_s: float, overlap_s: float) -> int:
    """Windows that ``chunked_transcribe`` (and a stream) decodes for a clip of ``samples`` longer than a chunk."""
    chunk, overlap = int(chunk_s * SAMPLE_RATE), int(overlap_s * SAMPLE_RATE)
    return len(range(0, max(samples - overlap, 1), chunk - overlap))


def percentiles_ms(seconds: list) -> dict:
    if not seconds:
        return {"n": 0}
    ms = np.asarray(seconds) * 1e3
    return {"n": int(ms.size), "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max())}


class CountedInfer:
    """A predictor's ``infer`` that counts its calls: set as the predictor's attribute for a run, so that the
    streams built on it call through it."""

    def __init__(self, predictor):
        self.predictor, self.real, self.calls = predictor, predictor.infer, 0

    def __call__(self, audio, lengths):
        self.calls += 1
        return self.real(audio, lengths)

    def __enter__(self):
        self.predictor.infer = self
        return self

    def __exit__(self, *exc):
        del self.predictor.infer


def lone_stream_run(predictor, clip: np.ndarray, grid: tuple, beam: dict, rng, device) -> dict:
    """One ``StreamingTranscriber`` on ``predictor`` fed ``clip`` in pushes of 800 to 20,000 samples (``rng``):
    its text, partials, the host seconds of the pushes that completed a window and the wall seconds."""
    from thunder_tpu_torch.streaming import StreamingTranscriber

    stream = StreamingTranscriber(predictor, chunk_seconds=grid[0], overlap_seconds=grid[1], **beam)
    partials, window_pushes, i = [], [], 0
    sync(device)
    t_start = time.perf_counter()
    while i < clip.size:
        n = int(rng.integers(800, 20001))
        done = stream._chunks_done
        t0 = time.perf_counter()
        partials.append(stream.push(clip[i: i + n]))
        if stream._chunks_done > done:
            window_pushes.append(time.perf_counter() - t0)
        i += n
    text = stream.flush()
    sync(device)
    return {"text": text, "partials": partials, "window_pushes": window_pushes,
            "wall_s": time.perf_counter() - t_start}


def lone_reference(engine, clip: np.ndarray, grid: tuple, beam: dict) -> str:
    """The text of a lone ``StreamingTranscriber`` on ``engine`` given the whole clip in one push, then flushed."""
    from thunder_tpu_torch.streaming import StreamingTranscriber

    stream = StreamingTranscriber(engine, chunk_seconds=grid[0], overlap_seconds=grid[1], **beam)
    stream.push(clip)
    return stream.flush()


def pool_run(predictor, clips: list, grid: tuple, beam: dict, threads: int, device) -> dict:
    """A ``StreamingPool(batch_size=POOL_BATCH)`` of one stream a clip, fed round-robin in pushes of ``POOL_PUSH``
    samples, from one thread or from ``threads`` threads (each feeding its share of the streams round-robin), then
    every stream flushed: the texts, the host seconds of the pushes that ran a forward, the wall seconds and the
    forwards."""
    import threading

    from thunder_tpu_torch.streaming import StreamingPool

    with CountedInfer(predictor) as counted:
        pool = StreamingPool(predictor, batch_size=POOL_BATCH, chunk_seconds=grid[0], overlap_seconds=grid[1], **beam)
        sids = [pool.open() for _ in clips]
        drain_pushes, errors = [], []

        def feed(share):
            try:
                for start in range(0, max(c.size for c in clips), POOL_PUSH):
                    for k in share:
                        if start < clips[k].size:
                            calls = counted.calls
                            t0 = time.perf_counter()
                            pool.push(sids[k], clips[k][start: start + POOL_PUSH])
                            if counted.calls > calls:
                                drain_pushes.append(time.perf_counter() - t0)
            except Exception as err:  # re-raised below: a thread's exception would be lost
                errors.append(err)

        sync(device)
        t_start = time.perf_counter()
        if threads == 1:
            feed(range(len(clips)))
        else:
            workers = [threading.Thread(target=feed, args=(range(t, len(clips), threads),)) for t in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=600)
            check(not any(w.is_alive() for w in workers), "a pool feeding thread did not finish in 600 s")
        if errors:
            raise errors[0]
        texts = [pool.flush(sid) for sid in sids]
        sync(device)
        wall = time.perf_counter() - t_start
    return {"texts": texts, "drain_pushes": drain_pushes, "wall_s": wall, "forwards": counted.calls}


def rows_parting(predictor, audio, lengths) -> tuple:
    """``(rows, flips)``: the rows of ``predictor.infer(audio, lengths)`` whose logits differ from the same row
    served alone, and the frames where their argmax differs."""
    import torch

    logits, preds, out_lengths = predictor.infer(audio, lengths)
    alone = [predictor.infer(audio[r: r + 1], lengths[r: r + 1]) for r in range(audio.shape[0])]
    whole = sum(not torch.equal(logits[r: r + 1], alone[r][0]) for r in range(audio.shape[0]))
    flips = sum(int((preds[r, : int(out_lengths[r])] != alone[r][1][0, : int(out_lengths[r])]).sum())
                for r in range(audio.shape[0]))
    return whole, flips


def one_second_rows(clips: list, device):
    """The first second of each clip as a batch on ``device``, the last row cut to a third of it."""
    import torch

    audio = torch.as_tensor(np.stack([c[:SAMPLE_RATE] for c in clips]), device=device)
    lengths = torch.full((audio.shape[0],), SAMPLE_RATE, dtype=torch.int32, device=device)
    lengths[-1] = SAMPLE_RATE // 3  # a row shorter than its window
    return audio, lengths


def batch_invariance(card: str, engine, clips: list, served: np.ndarray, device, phase: str = "streaming") -> None:
    """Whether a row of a ``(POOL_BATCH, 1 s)`` forward of the ``batch_invariant`` engine is bit-equal to the same
    row served alone: each stage on the same input (the log-mel kernel, the frontend, every repeat of the plan,
    the squeeze-excite gates and the residuals on rows 0-7, the decoder) and the whole forward on every row;
    beside them the default engine's frontend, decoder and whole forward, whose float32 sums the option replaces,
    and the forward of both engines on ``served`` (a 64 x 15 s batch), in turns (default, invariant, invariant,
    default). Prints ``{phase}_batch_invariance``."""
    import torch

    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels.frontend import fused_log_mel

    rows = range(min(8, len(clips)))
    audio, lengths = one_second_rows(clips, device)
    default = InferenceEngine(engine.module)

    def differing(batch_fn, row_fn) -> int:
        full = batch_fn()
        return sum(not torch.equal(full[r: r + 1], row_fn(r)) for r in rows)

    def whole_forward(eng) -> tuple:
        return rows_parting(eng, audio, lengths)

    def frontend(eng):
        return differing(lambda: eng.frontend(audio, lengths, sum_dtype=eng._sum_dtype)[0],
                         lambda r: eng.frontend(audio[r: r + 1], lengths[r: r + 1], sum_dtype=eng._sum_dtype)[0])

    stages = {"log_mel": differing(lambda: fused_log_mel(audio), lambda r: fused_log_mel(audio[r: r + 1])),
              "frontend": frontend(engine)}
    x, x_lengths = engine.frontend(audio, lengths, sum_dtype=engine._sum_dtype)
    x = x.to(engine.dtype)
    repeats = {"separable": 0, "dense": 0, "se": 0}
    for block in engine._plan:
        inp, inp_lengths = x, x_lengths
        for rp in block.repeats + ([block.res] if block.res is not None else []):
            if rp is block.res and block.se is not None:  # the gate, after the repeats and before the residual
                gated = engine._apply_se(block.se, x, x_lengths)
                repeats["se"] += differing(lambda: gated, lambda r: engine._apply_se(block.se, x[r: r + 1],
                                                                                     x_lengths[r: r + 1]))
                x = gated
            src, src_lengths = (inp, inp_lengths) if rp is block.res else (x, x_lengths)
            out, out_lengths = engine._apply_repeat(rp, src, src_lengths, {})
            repeats[rp.kind] += differing(lambda: out, lambda r: engine._apply_repeat(rp, src[r: r + 1],
                                                                                      src_lengths[r: r + 1], {})[0])
            if rp is block.res:
                x = x + out
            else:
                x, x_lengths = out, out_lengths
        if block.res is None and block.se is not None:
            gated = engine._apply_se(block.se, x, x_lengths)
            repeats["se"] += differing(lambda: gated, lambda r: engine._apply_se(block.se, x[r: r + 1],
                                                                                 x_lengths[r: r + 1]))
            x = gated
        x = torch.relu(x)
    stages.update({f"{kind}_repeats" if kind != "se" else "se_gates": n for kind, n in repeats.items()})
    stages["decoder"] = differing(lambda: engine._decode(x)[0], lambda r: engine._decode(x[r: r + 1])[0])
    whole, flips = whole_forward(engine)
    default_whole, default_flips = whole_forward(default)
    default_stages = {"frontend": frontend(default),
                      "decoder": differing(lambda: default._decode(x)[0], lambda r: default._decode(x[r: r + 1])[0])}
    audio_s = torch.as_tensor(served, device=device)
    lengths_s = torch.full((audio_s.shape[0],), audio_s.shape[1], dtype=torch.int32, device=device)
    forward_ms = {"default": [], "batch_invariant": []}
    for name, eng in (("default", default), ("batch_invariant", engine), ("batch_invariant", engine),
                      ("default", default)):
        forward_ms[name].append(cuda_ms(lambda: eng.infer(audio_s, lengths_s), 20))
    emit({"phase": f"{phase}_batch_invariance", "batch": int(audio.shape[0]), "seconds": 1.0,
          "rows_differing_of_8": stages, "whole_forward_rows_differing": whole, "whole_forward_argmax_flips": flips,
          "default_engine": {"rows_differing_of_8": default_stages, "whole_forward_rows_differing": default_whole,
                             "whole_forward_argmax_flips": default_flips},
          "forward_ms_64x15s": forward_ms, "card": card})
    check(not any(stages.values()) and whole == 0, "a row of the batch differs from the same row served alone")


def streaming_phase(card: str, device="cuda") -> dict:
    """Phase 25 of the module docstring: lone streams on the ``batch_invariant`` engine and the module, the pool of
    64 streams on that engine from one and from 8 threads, word fusion on the device beam. Returns the launches of
    its runs, by run."""
    import torch

    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device_stream
    from thunder_tpu_torch.text import WordFusionLM, WordNGramLM

    runs = {}
    module, engine, served = served_quartznet(device, batch_invariant=True)
    samples = int(STREAM_SECONDS * SAMPLE_RATE)
    clip = stream_clips(1, STREAM_SECONDS, seed=25)[0]
    decodes = {"greedy": {}, "device_beam": STREAM_BEAM}

    # ---- lone streams: each flush equals predict_long on the same grid; greedy partials are prefixes of it
    for pname, predictor, grids in (("engine", engine, STREAM_GRIDS), ("module", module, MODULE_GRIDS)):
        for dname, beam in decodes.items():
            for grid in grids:
                tag = f"lone_{pname}_{dname}_{grid[0]:g}s"
                predictor.predict_long(clip[: int(grid[0] * SAMPLE_RATE) * 2], chunk_seconds=grid[0],
                                       overlap_seconds=grid[1], **beam)  # warms this grid's shapes
                reset_launch_counts()
                run = lone_stream_run(predictor, clip, grid, beam, np.random.default_rng(len(runs)), device)
                runs[tag] = launch_counts()
                want = predictor.predict_long(clip, chunk_seconds=grid[0], overlap_seconds=grid[1], **beam)
                windows = grid_windows(samples, *grid)
                beam_launches = windows if beam else 0
                expect = expected_counts(fused_log_mel=windows,
                                         fused_separable_repeat=QN_SEPARABLE * windows if pname == "engine" else 0,
                                         beam_scan=beam_launches, beam_backtrace=beam_launches)
                not_prefix = sum(not run["text"].startswith(p) for p in run["partials"])
                emit({"phase": "streaming_lone", "predictor": pname, "decode": dname, "chunk_s": grid[0],
                      "overlap_s": grid[1], "seconds": STREAM_SECONDS, "pushes": len(run["partials"]),
                      "windows": windows, "launches": {k: v for k, v in runs[tag].items() if v},
                      "flush_equals_predict_long": run["text"] == want, "text_chars": len(run["text"]),
                      "partials_not_prefix": not_prefix, "window_push_latency": percentiles_ms(run["window_pushes"]),
                      "wall_s": run["wall_s"], "rtf": STREAM_SECONDS / run["wall_s"], "card": card})
                check(runs[tag] == expect, f"{tag}: launched {runs[tag]}, expected {expect}")
                check(run["text"] == want, f"{tag}: flush() differs from predict_long")
                check(bool(beam) or not_prefix == 0, f"{tag}: {not_prefix} greedy partials are no prefix of the text")

    # the device beam searches each trimmed window as it is; predict_long pads it to a 64-frame bucket
    logits, _, out_lengths = engine.infer(clip[None, : 20 * SAMPLE_RATE], np.array([20 * SAMPLE_RATE], np.int32))
    win = logits[:, : int(out_lengths[0]) - 50]
    bucket = -(-win.shape[1] // 64) * 64
    plain = beam_search_device_stream(win, blank=module.blank_idx, beam_width=LM_WIDTH)
    padded = beam_search_device_stream(torch.nn.functional.pad(win, (0, 0, 0, bucket - win.shape[1])),
                                       lengths=[win.shape[1]], blank=module.blank_idx, beam_width=LM_WIDTH)
    same = np.array_equal(plain.total, padded.total) and all(
        (a is None and b is None) or (a is not None and b is not None and a.tolist() == b.tolist())
        for a, b in zip(plain.prefixes[0], padded.prefixes[0]))
    emit({"phase": "streaming_window_padding", "frames": int(win.shape[1]), "bucket": bucket, "same_beams": same})
    check(same, "the device beam's window padded to its bucket gives other beams than the window as it is")

    # ---- the pool: 64 streams of 60 s, each equal to the lone stream of its clip; the forward of one drain
    distinct = stream_clips(POOL_BATCH, STREAM_SECONDS, seed=26)
    batch_invariance(card, engine, distinct, served, device)
    clips = [distinct[k % POOL_CLIPS] for k in range(POOL_BATCH)]
    t0 = time.perf_counter()
    lone = {(dname, grid): [lone_reference(engine, c, grid, beam) for c in distinct[:POOL_CLIPS]]
            for dname, beam in decodes.items() for grid in POOL_GRIDS}
    emit({"phase": "streaming_pool_lone_references", "clips": POOL_CLIPS, "grids": POOL_GRIDS,
          "seconds_host_clock": time.perf_counter() - t0})
    for dname, beam in decodes.items():
        for grid in POOL_GRIDS:
            windows = grid_windows(samples, *grid)
            lone_texts = [lone[dname, grid][k % POOL_CLIPS] for k in range(POOL_BATCH)]
            for threads in (1, POOL_THREADS) if grid == POOL_GRIDS[-1] else (1,):
                tag = f"pool_{dname}_{grid[0]:g}s" + (f"_{threads}_threads" if threads > 1 else "")
                reset_launch_counts()
                run = pool_run(engine, clips, grid, beam, threads, device)
                runs[tag] = launch_counts()
                beam_launches = windows * POOL_BATCH if beam else 0
                expect = expected_counts(fused_log_mel=run["forwards"],
                                         fused_separable_repeat=QN_SEPARABLE * run["forwards"],
                                         beam_scan=beam_launches, beam_backtrace=beam_launches)
                differing = [k for k, (a, b) in enumerate(zip(run["texts"], lone_texts)) if a != b]
                line = {"phase": "streaming_pool", "decode": dname, "chunk_s": grid[0], "overlap_s": grid[1],
                        "streams": POOL_BATCH, "clips": POOL_CLIPS, "seconds": STREAM_SECONDS, "push_samples": POOL_PUSH,
                        "threads": threads, "windows_per_stream": windows, "forwards": run["forwards"],
                        "launches": {k: v for k, v in runs[tag].items() if v}, "streams_differing": differing,
                        "drain_push_latency": percentiles_ms(run["drain_pushes"]), "wall_s": run["wall_s"],
                        "rtf": POOL_BATCH * STREAM_SECONDS / run["wall_s"], "card": card}
                if threads == 1:
                    padded = np.zeros((POOL_BATCH, int(grid[0] * SAMPLE_RATE)), np.float32)
                    for k, c in enumerate(clips):
                        padded[k] = c[: padded.shape[1]]
                    audio_d = torch.as_tensor(padded, device=device)
                    lengths_d = torch.full((POOL_BATCH,), padded.shape[1], dtype=torch.int32, device=device)
                    line["drain_forward_ms"] = cuda_ms(lambda: engine.infer(audio_d, lengths_d), 10)
                emit(line)
                check(runs[tag] == expect, f"{tag}: launched {runs[tag]}, expected {expect}")
                check(not differing, f"{tag}: streams {differing} differ from their lone streams")

    # ---- word fusion on the device beam: 2 lone streams of 30 s, each equal to predict_long with the same LM
    fusion = WordFusionLM(WordNGramLM(order=WORD_LM_ORDER).fit(seeded_lines(LM_LINES)), module.text_transform)
    fused = dict(STREAM_BEAM, lm=fusion, lm_weight=LM_WEIGHT)
    reset_launch_counts()
    results = []
    for k, c in enumerate(stream_clips(FUSION_STREAMS, FUSION_SECONDS, seed=27)):
        run = lone_stream_run(engine, c, FUSION_GRID, fused, np.random.default_rng(100 + k), device)
        t0 = time.perf_counter()
        want = engine.predict_long(c, chunk_seconds=FUSION_GRID[0], overlap_seconds=FUSION_GRID[1], **fused)
        results.append((run, want, time.perf_counter() - t0))
    runs["word_fusion"] = launch_counts()
    windows = grid_windows(int(FUSION_SECONDS * SAMPLE_RATE), *FUSION_GRID) * FUSION_STREAMS
    expect = expected_counts(fused_log_mel=2 * windows, fused_separable_repeat=2 * QN_SEPARABLE * windows,
                             beam_scan=2 * windows, beam_backtrace=2 * windows)
    emit({"phase": "streaming_word_fusion", "streams": FUSION_STREAMS, "seconds": FUSION_SECONDS,
          "chunk_s": FUSION_GRID[0], "overlap_s": FUSION_GRID[1], "W": LM_WIDTH, "lm_weight": LM_WEIGHT,
          "equal_to_predict_long": [run["text"] == want for run, want, _ in results],
          "stream_wall_s": [run["wall_s"] for run, _, _ in results],
          "window_push_latency": [percentiles_ms(run["window_pushes"]) for run, _, _ in results],
          "predict_long_s": [s for _, _, s in results], "launches": {k: v for k, v in runs["word_fusion"].items() if v},
          "card": card})
    check(runs["word_fusion"] == expect, f"word fusion streams launched {runs['word_fusion']}, expected {expect}")
    check(all(run["text"] == want for run, want, _ in results), "a word-fusion stream differs from predict_long")
    return runs


def align_texts(n: int, seed: int) -> list:
    """``n`` seeded strings of ``ALIGN_CHARS`` characters from the vocabulary."""
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(VOCAB, int(rng.integers(ALIGN_CHARS[0], ALIGN_CHARS[1] + 1)))) for _ in range(n)]


def align_phase(card: str, device="cuda") -> dict:
    """Phase 26 of the module docstring: ``CTCModule.align`` of 64 seeded transcripts on 64 x 15 s. Returns the
    launches of its call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.module import host_batch, to_device
    from thunder_tpu_torch.ops.ctc import ctc_forced_align
    from thunder_tpu_torch.text.subtitles import to_srt, to_vtt, word_spans

    module, _, audio = served_quartznet(device)
    samples = audio.shape[1]
    lengths = np.full((BATCH,), samples, np.int32)
    texts = align_texts(BATCH, seed=26)
    module.align(audio[:2], texts[:2], lengths[:2])  # warms the path
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    spans, scores = module.align(audio, texts, lengths)
    sync(device)
    align_ms = (time.perf_counter() - t0) * 1e3
    runs = {"align": launch_counts()}
    check(runs["align"] == expected_counts(fused_log_mel=1), f"align launched {runs['align']}")

    # the forward and the Viterbi apart; the Viterbi on the card against its plain CPU run on the same log-probs
    padded, lengths_h = host_batch(audio, lengths, module.pad_multiple)
    targets, target_lengths = module.text_transform.encode(texts)
    audio_d, lengths_d = torch.as_tensor(padded, device=device), torch.as_tensor(lengths_h, device=device)
    targets_d, target_lengths_d = to_device(targets, torch.int32, device), to_device(target_lengths, torch.int32, device)
    logits, _, out_lengths = module.infer(audio_d, lengths_d)
    logp = torch.log_softmax(logits.float(), dim=-1)
    viterbi = lambda: ctc_forced_align(logp, out_lengths, targets_d, target_lengths_d, module.blank_idx)  # noqa: E731
    states, _, card_scores = viterbi()
    t0 = time.perf_counter()
    cpu_states, _, cpu_scores = ctc_forced_align(logp.cpu(), out_lengths.cpu(), torch.as_tensor(targets),
                                                 torch.as_tensor(target_lengths), module.blank_idx)
    cpu_viterbi_ms = (time.perf_counter() - t0) * 1e3
    forward_ms = cuda_ms(lambda: module.infer(audio_d, lengths_d), 3)
    viterbi_ms = cuda_ms(viterbi, 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        viterbi()
        sync(device)
    device_kernels = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    launch_calls = sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC") for e in prof.events())

    # first-maximum ties of the stacked choices on the card, as on the CPU and in jnp.argmax
    g = torch.Generator().manual_seed(0)
    stacked = torch.randint(0, 2, (3, BATCH, 2 * ALIGN_CHARS[1] + 1), generator=g).float()
    ties_first = bool(torch.equal(torch.argmax(stacked.to(device), dim=0).cpu(), torch.argmax(stacked, dim=0))
                      and (torch.argmax(stacked.to(device), dim=0).cpu().numpy()
                           == np.argmax(stacked.numpy(), axis=0)).all())

    duration = samples / SAMPLE_RATE
    ordered = all(all(0.0 <= s < e <= duration + 1e-6 for _, s, e in row)
                  and all(a[1] <= b[1] and a[2] <= b[2] for a, b in zip(row, row[1:])) for row in spans)
    docs = [(to_srt(row), to_vtt(row), word_spans(row)) for row in spans]
    rendered = sum(bool(srt) and "-->" in srt and vtt.startswith("WEBVTT") and bool(words) for srt, vtt, words in docs)
    too_long, too_long_scores = module.align(audio[0, :SAMPLE_RATE], ["ab" * 60])  # 120 tokens, 51 frames
    line = {"phase": "align", "batch": BATCH, "seconds": SECONDS, "frames": int(logits.shape[1]),
            "chars": [int(target_lengths.min()), int(target_lengths.max())], "align_ms_host_clock": align_ms,
            "forward_ms": forward_ms, "viterbi_ms": viterbi_ms, "viterbi_device_kernels": device_kernels,
            "viterbi_launch_calls": launch_calls, "viterbi_cpu_ms_host_clock": cpu_viterbi_ms,
            "states_equal_cpu": bool(torch.equal(states.cpu(), cpu_states)),
            "scores_bit_equal_cpu": bool(torch.equal(card_scores.cpu(), cpu_scores)),
            "scores_finite": bool(np.isfinite(scores).all()), "spans_ordered_within_clip": ordered,
            "documents_rendered": rendered, "too_long_score": float(too_long_scores[0]), "ties_first_index": ties_first,
            "launches": {k: v for k, v in runs["align"].items() if v}, "card": card}
    emit(line)
    check(line["states_equal_cpu"] and line["scores_bit_equal_cpu"], "the card's Viterbi differs from its CPU run")
    check(np.array_equal(scores, card_scores.cpu().numpy()), "align's scores differ from the Viterbi on its log-probs")
    check(line["scores_finite"], "an align score is not finite")
    check(ordered, "align's spans are out of order or outside the clip")
    check(rendered == BATCH, f"{rendered} of {BATCH} subtitle documents rendered")
    check(np.isneginf(too_long_scores[0]) and len(too_long[0]) == 120, "a text too long for its frames is not -inf")
    check(ties_first, "torch.argmax on the card does not take the first of tied choices")
    return runs


def unrecorded_launches(events: list, block: str) -> dict:
    """A Chrome trace's kernel launch calls (host side) against its kernel records (card side), matched by
    correlation id: the calls, those without a record before the host span ``block`` (``trace``'s warm-up) and
    in or after it, the host microseconds from the first call to the first and last unrecorded one, and the
    least and median microseconds from a call to its kernel's start."""
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in e.get("name", "")
                and "correlation" in e.get("args", {})}
    kernel_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    start = min((e["ts"] for e in events if e.get("name") == block and e.get("cat") == "user_annotation"),
                default=float("inf"))
    missing = sorted(ts for c, ts in launches.items() if c not in kernel_ts)
    lead = [ts - launches[c] for c, ts in kernel_ts.items() if c in launches]
    first = min(launches.values(), default=0.0)
    return {"launch_calls": len(launches), "unrecorded_before_block": sum(ts < start for ts in missing),
            "unrecorded_in_block": sum(ts >= start for ts in missing),
            "unrecorded_from_first_call_us": [missing[0] - first, missing[-1] - first] if missing else [],
            "call_to_kernel_us": [min(lead), float(np.median(lead))] if lead else []}


@contextlib.contextmanager
def gc_pauses():
    """Yields a list that gains ``[generation, ms]`` for each collection the garbage collector makes in the block."""
    pauses, start = [], [0.0]

    def record(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            pauses.append([info["generation"], (time.perf_counter() - start[0]) * 1e3])

    gc.callbacks.append(record)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(record)


def profiling_phase(card: str, device="cuda") -> dict:
    """Phase 27 of the module docstring: ``profiling.trace`` around one engine forward at 64 x 15 s with an
    ``annotate("serve")`` span, counted in the written trace; ``StepTimer`` over synchronized forwards against
    phase 4's RTF, measured again here as phase 4 measures it (CUDA events over 10 forwards back to back): the
    card and its host run at another pace late in a whole run than at its start. Returns the launches of the
    traced forward."""
    import tempfile
    from pathlib import Path

    import torch

    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.profiling import StepTimer, annotate, trace

    _, engine, audio = served_quartznet(device)
    samples = audio.shape[1]
    audio_d = torch.as_tensor(audio, device=device)
    lengths_d = torch.full((BATCH,), samples, dtype=torch.int32, device=device)
    forward = lambda: engine.infer(audio_d, lengths_d)  # noqa: E731
    forward()
    # the timed steps come before the traces, and after a collection: neither the profiler's state after a
    # trace nor a collection of the garbage of the phases before falls into a step. Phase 4's measurement is
    # taken before and after them, so that a drift of the card's pace falls on both sides
    gc.collect()
    forward_ms_before = cuda_ms(forward, 10)
    timer = StepTimer()
    with gc_pauses() as pauses:
        for _ in range(STEP_TIMER_FORWARDS):
            with timer.step(BATCH * samples):
                forward()
                sync(device)
    forward_ms_after = cuda_ms(forward, 10)
    forward_ms = (forward_ms_before + forward_ms_after) / 2
    serving_rtf = BATCH * SECONDS / (forward_ms / 1e3)
    summary = timer.summary()
    takes = []
    for _ in range(TRACE_TAKES):  # every take is kept: how often a take misses records is a finding
        with tempfile.TemporaryDirectory() as tmp:
            reset_launch_counts()
            with trace(tmp):
                with annotate("serve"):
                    forward()
                sync(device)
            files = list(Path(tmp).glob("*.pt.trace.json"))
            events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
        counts = launch_counts()
        kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        found = {"files": len(files), "serve_spans": sum(e.get("name") == "serve" for e in events),
                 "log_mel_kernels": sum("log_mel_" in k for k in kernels),
                 "separable_kernels": sum("separable_repeat_kernel" in k for k in kernels),
                 "kernel_events": len(kernels), **unrecorded_launches(events, "serve")}
        found["complete"] = found["log_mel_kernels"] == 1 and found["separable_kernels"] == QN_SEPARABLE
        takes.append((found, counts))
    found, counts = next((t for t in takes if t[0]["complete"]), takes[-1])
    emit({"phase": "profiling", **found, "complete_takes": sum(t["complete"] for t, _ in takes),
          "takes": [t for t, _ in takes],
          "launches": {k: v for k, v in counts.items() if v},
          "step_timer": summary, "step_ms": [t * 1e3 for t in timer.times], "forward_ms": forward_ms,
          "forward_ms_before_after": [forward_ms_before, forward_ms_after], "gc_pauses_in_steps": pauses,
          "serving_rtf": serving_rtf,
          "rtf_ratio": summary["rtf"] / serving_rtf, "clocks": gpu_clocks(), "card": card})
    check(found["files"] == 1 and found["serve_spans"] >= 1, f"the trace lacks the annotated span: {found}")
    check(found["log_mel_kernels"] == 1 and found["separable_kernels"] == QN_SEPARABLE,
          f"the trace does not hold 1 log-mel and {QN_SEPARABLE} separable kernels: {found}")
    check(counts == expected_counts(fused_log_mel=1, fused_separable_repeat=QN_SEPARABLE),
          f"the traced forward launched {counts}")
    check(abs(summary["rtf"] / serving_rtf - 1) <= STEP_TIMER_RTF_TOL,
          f"StepTimer's rtf {summary['rtf']:.0f} is not within {STEP_TIMER_RTF_TOL:.0%} of the CUDA events' "
          f"{serving_rtf:.0f} (steps {', '.join(f'{t * 1e3:.2f}' for t in timer.times)} ms; forward "
          f"{forward_ms:.2f} ms)")
    return {"traced_forward": counts}


# runs ``python -m thunder_tpu_torch`` (``runpy``, as ``-m`` does) and prints, at its end, the kernels' launches
CLI_RUNNER = """import json, runpy, sys
sys.argv = ["thunder_tpu_torch", *sys.argv[1:]]
try:
    runpy.run_module("thunder_tpu_torch", run_name="__main__", alter_sys=True)
finally:
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS
    print("cli_launches " + json.dumps({w.__name__: w.launches for w in KERNEL_WRAPPERS}), file=sys.stderr)
"""


def write_wav(path, pcm: np.ndarray) -> None:
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(np.asarray(pcm, np.int16).tobytes())


def cli_phase(card: str, device="cuda") -> dict:
    """Phase 28 of the module docstring: ``python -m thunder_tpu_torch`` in subprocesses on the card (no
    ``--device``; ``device="cpu"`` adds ``--device cpu``, to rehearse), against the in-process API on the same
    files. Returns the launches of each CLI run."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from thunder_tpu_torch import load_inference_bundle, load_pretrained
    from thunder_tpu_torch.data import ManifestDatamodule, load_audio
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.training.metrics import CharErrorRate, WordErrorRate

    module, _, _ = served_quartznet(device)
    pcm = [np.clip(np.round(c * 32767), -32768, 32767).astype(np.int16)
           for c in stream_clips(10, STREAM_SECONDS, seed=28)]
    short = int(SECONDS * SAMPLE_RATE)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        nemo = tmp / "quartznet15x5.nemo"
        write_nemo(nemo, module, nemo_quartznet_config(module))
        files = [tmp / "clip15.wav", tmp / "clip60.wav", tmp / "clip15.flac"]
        write_wav(files[0], pcm[0][:short])
        write_wav(files[1], pcm[1])
        files[2].write_bytes(flac_bytes(pcm[2][:short], SAMPLE_RATE))
        texts = align_texts(8, seed=28)
        entries = []
        for k in range(8):
            write_wav(tmp / f"item{k}.wav", pcm[2 + k][:short])
            entries.append(json.dumps({"audio_filepath": str(tmp / f"item{k}.wav"), "duration": SECONDS,
                                       "text": texts[k]}))
        manifest = tmp / "manifest.json"
        manifest.write_text("\n".join(entries))
        clips = [str(f) for f in files]
        common = ["--checkpoint", str(nemo)] + (["--device", device] if device != "cuda" else [])
        jobs = {
            "transcribe_timestamps": ["transcribe", *common, "--timestamps", *clips],
            "transcribe_engine": ["transcribe", *common, "--engine", *clips],
            "transcribe_device_beam": ["transcribe", *common, "--engine", "--beam-width", str(LM_WIDTH),
                                       "--beam-backend", "device", *clips],
            "eval": ["eval", *common, "--engine", "--manifest", str(manifest), "--batch-size", "8",
                     "--num-workers", "4"],
            "train": ["train", *common, "--train-manifest", str(manifest), "--epochs", "1", "--batch-size", "8",
                      "--num-workers", "4", "--log-every", "1"],
            "export": ["export", *common, "--output", str(tmp / "bundle")],
        }
        env = {**os.environ, "PYTHONPATH": os.getcwd()}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen([sys.executable, "-c", CLI_RUNNER, *argv], stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True, env=env) for name, argv in jobs.items()}
        no_card = subprocess.Popen([sys.executable, "-m", "thunder_tpu_torch", "transcribe", "--checkpoint", str(nemo),
                                    clips[0]],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                   env={**env, "CUDA_VISIBLE_DEVICES": ""})
        outputs = {}
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            outputs[name] = (proc.returncode, out, err)
        no_card_out, no_card_err = no_card.communicate(timeout=600)
        cli_s = time.perf_counter() - t0
        for name, (rc, _, err) in outputs.items():
            check(rc == 0, f"cli {name} exited {rc}: {err[-2000:]}")
        runs = {name: json.loads([line for line in err.splitlines() if line.startswith("cli_launches ")][-1]
                                 .removeprefix("cli_launches ")) for name, (_, _, err) in outputs.items()}
        records = {name: [json.loads(line) for line in outputs[name][1].splitlines() if line.startswith("{")]
                   for name in ("transcribe_timestamps", "transcribe_engine", "transcribe_device_beam", "eval")}

        # the in-process API on the same files (the CLI, as this run, computes float32 in full)
        loaded = load_pretrained(str(nemo), device=device)
        engine = InferenceEngine(loaded)
        beam = dict(beam_width=LM_WIDTH, beam_backend="device")
        want = {"transcribe_timestamps": [], "transcribe_engine": [], "transcribe_device_beam": []}
        windows = 0
        for path in clips:
            audio = load_audio(path)[0][0]
            is_long = audio.size > 20 * SAMPLE_RATE
            windows += grid_windows(audio.size, 20.0, 2.0) if is_long else 1
            for name, predictor, kwargs in (("transcribe_timestamps", loaded, {}), ("transcribe_engine", engine, {}),
                                            ("transcribe_device_beam", engine, beam)):
                text = (predictor.predict_long(audio, chunk_seconds=20.0, overlap_seconds=2.0, **kwargs) if is_long
                        else predictor.predict(audio, **kwargs)[0])
                record = {"audio": path, "text": text.strip()}
                if name == "transcribe_timestamps" and text.strip() and not is_long:
                    spans, _ = loaded.align(audio, [text])
                    record["tokens"] = [{"token": t, "start": round(s, 3), "end": round(e, 3)} for t, s, e in spans[0]]
                want[name].append(record)
        aligned = sum("tokens" in r for r in want["transcribe_timestamps"])
        dm = ManifestDatamodule(str(manifest), str(manifest), str(manifest), batch_size=8, num_workers=4)
        dm.setup("test")
        wer, cer = WordErrorRate(), CharErrorRate()
        for audio, lengths, refs in dm.test_dataloader():
            hyps = engine.predict(audio, lengths)
            wer.update(hyps, list(refs))
            cer.update(hyps, list(refs))
        restored = InferenceEngine(load_inference_bundle(str(tmp / "bundle"), device=device))
        probe = torch.as_tensor(np.stack([p[:short] for p in pcm[:4]]).astype(np.float32) / 32768.0, device=device)
        probe_lengths = torch.full((4,), short, dtype=torch.int32, device=device)
        bundle_equal = logits_sha256(restored.infer(probe, probe_lengths)[0]) == logits_sha256(
            engine.infer(probe, probe_lengths)[0])

    ev = records["eval"][0] if records["eval"] else {}
    expect = {
        "transcribe_timestamps": expected_counts(fused_log_mel=windows + aligned),
        "transcribe_engine": expected_counts(fused_log_mel=windows, fused_separable_repeat=QN_SEPARABLE * windows),
        "transcribe_device_beam": expected_counts(fused_log_mel=windows, fused_separable_repeat=QN_SEPARABLE * windows,
                                                  beam_scan=windows, beam_backtrace=windows),
        "eval": expected_counts(fused_log_mel=1, fused_separable_repeat=QN_SEPARABLE),
    }
    line = {"phase": "cli", "jobs": list(jobs), "wall_s": cli_s, "files": [f.name for f in files],
            "transcribe_equal": {name: records[name] == want[name] for name in want},
            "timestamped_records": aligned,
            "eval": ev, "eval_in_process": {"wer": round(wer.compute(), 4), "cer": round(cer.compute(), 4)},
            "bundle_logits_equal": bundle_equal,
            "no_card_exit": no_card.returncode, "no_card_error": no_card_err.strip().splitlines()[-1:],
            "launches": {name: {k: v for k, v in c.items() if v} for name, c in runs.items()}, "card": card}
    emit(line)
    for name, want_counts in expect.items():
        check(runs[name] == want_counts, f"cli {name} launched {runs[name]}, expected {want_counts}")
    check(all(line["transcribe_equal"].values()), f"the CLI's records differ from the in-process API: "
                                                  f"{ {n: (records[n], want[n]) for n in want} }")
    check(ev.get("utterances") == 8 and {k: ev.get(k) for k in ("wer", "cer")} == line["eval_in_process"],
          f"cli eval {ev} differs from the in-process metrics {line['eval_in_process']}")
    check(runs["train"]["ctc_beta"] >= 1, f"cli train launched no CTC backward: {runs['train']}")
    check(bundle_equal, "the exported bundle serves other logits than the source module")
    check(no_card.returncode != 0 and "no CUDA device is available" in no_card_err,
          f"the CLI without a card exited {no_card.returncode}: {no_card_err[-500:]}")
    return runs


# ---- phases 29-32: the device mesh, the training kernels' row offsets, Citrinet's batch invariance

MESH_STEPS = 3  # Trainer.fit steps of the mesh and the meshless trainer
MESH_TIMED = 5  # forwards a turn
MESH_STORE = "smoke_out/mesh"  # under the checkout: the FileStore of the one-rank process group
CITRINET_POOL_GRID = (2.0, 0.5)


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms (no benchmark) and ``torch.use_deterministic_algorithms`` in the block; the
    settings before it afterwards."""
    import torch

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


@contextlib.contextmanager
def one_rank_group(device="cuda"):
    """A one-rank process group over a ``FileStore`` under MESH_STORE (NCCL on the card, gloo on the CPU) and its
    mesh; the group is destroyed after the block."""
    import shutil
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from thunder_tpu_torch.parallel import make_mesh

    store = Path(MESH_STORE)
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(str(store / "store"), 1), rank=0, world_size=1)
    try:
        yield make_mesh(device=device)
    finally:
        dist.destroy_process_group()


def mesh_phase(card: str, device="cuda") -> dict:
    """Phase 29 of the module docstring: a one-rank mesh against the meshless path, training and serving. Returns
    the launches of its runs, by run."""
    import hashlib

    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.trainer import Trainer

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    with one_rank_group(device) as mesh:
        runs = {}
        dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
        tt = BatchTextTransformer(VOCAB)

        def create():
            # the training phase's configuration: dropout 0.1, the default dither, 2 + 2 SpecAugment masks
            return CTCModule.create(torch.Generator().manual_seed(0),
                                    FilterbankFeatures(num_time_masks=2, num_freq_masks=2),
                                    QuartznetEncoder(**QN15X5, dropout=0.1, dtype=dtype),
                                    Conv1dDecoder(len(VOCAB) + 1, dtype=dtype), tt, device=device)

        samples = int(TRAIN_SECONDS * SAMPLE_RATE)
        rng = np.random.default_rng(29)
        loader = [((rng.standard_normal((TRAIN_BATCH, samples)) * 0.1).astype(np.float32),
                   np.full((TRAIN_BATCH,), samples, np.int32), [TRAIN_TEXT] * TRAIN_BATCH) for _ in range(MESH_STEPS)]
        trained = {}
        for name, m in (("meshless", None), ("mesh", mesh)):
            reset_launch_counts()
            trainer = Trainer(seed=0, log_every=1, device=device, mesh=m)
            with deterministic_algorithms():
                fitted = trainer.fit(create(), loader)
                sync(device)
            runs[f"train_{name}"] = launch_counts()
            trained[name] = ([e["loss/train_loss"] for e in trainer.logs if "loss/train_loss" in e],
                             {k: v.detach().clone() for k, v in fitted.model.state_dict().items()})
        losses, states = {n: t[0] for n, t in trained.items()}, {n: t[1] for n, t in trained.items()}
        parting = sorted(k for k in states["meshless"] if not torch.equal(states["meshless"][k], states["mesh"][k]))
        expect_train = expected_counts(fused_log_mel=MESH_STEPS, ctc_alpha=MESH_STEPS, ctc_beta=MESH_STEPS)

        # serving: phase 4's module and batch, the meshless and the mesh engine
        module, engine, rows = served_quartznet(device)
        engines = {"meshless": engine, "mesh": InferenceEngine(module, mesh=mesh)}
        lengths = np.full((len(rows),), rows.shape[1], np.int32)
        audio_d, lengths_d = torch.as_tensor(rows, device=device), torch.as_tensor(lengths, device=device)
        served = {}
        for name, eng in engines.items():
            eng.warmup([len(rows)], [SECONDS])
            reset_launch_counts()
            texts = eng.predict(rows, lengths)
            sync(device)
            runs[f"serve_{name}"] = launch_counts()
            reset_launch_counts()
            beam_texts = eng.predict(rows, lengths, beam_width=16, beam_backend="device")
            sync(device)
            runs[f"serve_beam_{name}"] = launch_counts()
            logits = eng.infer(audio_d, lengths_d)[0]
            served[name] = (texts, beam_texts, hashlib.sha256(logits.float().cpu().numpy().tobytes()).hexdigest())
        forward_ms = {"meshless": [], "mesh": []}
        for name in ("meshless", "mesh", "mesh", "meshless"):
            forward_ms[name].append(cuda_ms(lambda: engines[name].infer(audio_d, lengths_d), MESH_TIMED))
        expect_serve = expected_counts(fused_log_mel=1, fused_separable_repeat=QN_SEPARABLE)
        expect_beam = expected_counts(fused_log_mel=1, fused_separable_repeat=QN_SEPARABLE, beam_scan=1,
                                      beam_backtrace=1)
        emit({"phase": "mesh", "backend": backend, "mesh": mesh.shape, "train_batch": TRAIN_BATCH,
              "train_seconds": TRAIN_SECONDS, "steps": MESH_STEPS, "losses": losses,
              "losses_equal": losses["mesh"] == losses["meshless"], "state_entries": len(states["mesh"]),
              "state_entries_differing": parting, "serve_batch": len(rows),
              "serve_seconds": SECONDS, "transcripts_equal": served["mesh"][0] == served["meshless"][0],
              "beam_transcripts_equal": served["mesh"][1] == served["meshless"][1],
              "logits_sha256": {n: s[2] for n, s in served.items()}, "forward_ms": forward_ms,
              "launches": {n: {k: v for k, v in c.items() if v} for n, c in runs.items()}, "card": card})
        check(len(losses["mesh"]) == MESH_STEPS and losses["mesh"] == losses["meshless"],
              f"the mesh trainer's losses {losses['mesh']} differ from the meshless {losses['meshless']}")
        check(not parting, f"after {MESH_STEPS} steps the mesh trainer's state differs in {parting[:5]}")
        check(runs["train_mesh"] == runs["train_meshless"] == expect_train,
              f"mesh training launched {runs['train_mesh']}, meshless {runs['train_meshless']}, expected "
              f"{expect_train}")
        check(runs["serve_mesh"] == runs["serve_meshless"] == expect_serve,
              f"the mesh engine launched {runs['serve_mesh']}, expected {expect_serve}")
        check(runs["serve_beam_mesh"] == runs["serve_beam_meshless"] == expect_beam,
              f"the mesh engine's device beam launched {runs['serve_beam_mesh']}, expected {expect_beam}")
        check(served["mesh"] == served["meshless"], "the mesh engine's transcripts or logits differ from the meshless")
        return runs


def row_offset_phase(card: str, device="cuda") -> None:
    """Phase 30 of the module docstring: the training kernels on slices of the wav2vec2 step's batch, each with
    its rows' offset, against the whole batch's launches and the plain versions."""
    from thunder_tpu_torch.kernels.selftest import row_offset_check

    t = 749  # wav2vec2's frames at 15 s
    for parts in (2, 4):
        t0 = time.perf_counter()
        result = row_offset_check(parts, W2V_TRAIN_BATCH, t, 12, 0.1, device)
        emit({"phase": "row_offsets", "parts": parts, "batch": W2V_TRAIN_BATCH, "T": t, "heads": 12, "D": 768,
              "rate": 0.1, **result, "ulp_bound": TRAIN_KERNEL_ULP, "seconds": time.perf_counter() - t0, "card": card})
        bits = [k for k in ("mask_bits", "add_ln_bits", "dx_dy_bits", "attn_bits", "stats_bits", "dqkv_bits",
                            "mask_vs_plain_bits") if not result[k]]
        check(not bits, f"{parts} slices with their row offsets differ from the whole batch's launch in {bits}")
        check(result["vs_plain"] <= TRAIN_KERNEL_ULP and result["dparams_rel"] <= 0.01,
              f"row offsets: {result['vs_plain']} bf16 ULP from the plain versions, dscale/dbias off by "
              f"{result['dparams_rel']}")


def citrinet_invariance_phase(card: str, device="cuda") -> dict:
    """Phase 31 of the module docstring: Citrinet-256 on a ``batch_invariant`` engine, stage by stage, then a pool
    of 64 streams against their lone streams. Returns the launches of the pool's runs, by run."""
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import reset_launch_counts

    module = citrinet_create(device)
    engine = InferenceEngine(module, batch_invariant=True)
    rng = np.random.default_rng(31)
    samples = int(SECONDS * SAMPLE_RATE)
    base = speech_like(samples, rng)
    served = np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(BATCH)]).astype(np.float32)
    distinct = stream_clips(POOL_BATCH, STREAM_SECONDS, seed=31)
    batch_invariance(card, engine, distinct, served, device, phase="citrinet_streaming")

    runs = {}
    clips = [distinct[k % POOL_CLIPS] for k in range(POOL_BATCH)]
    grid = CITRINET_POOL_GRID
    windows = grid_windows(int(STREAM_SECONDS * SAMPLE_RATE), *grid)
    for dname, beam in (("greedy", {}), ("device_beam", STREAM_BEAM)):
        lone = [lone_reference(engine, c, grid, beam) for c in distinct[:POOL_CLIPS]]
        tag = f"citrinet_pool_{dname}_{grid[0]:g}s"
        reset_launch_counts()
        run = pool_run(engine, clips, grid, beam, 1, device)
        runs[tag] = launch_counts()
        beam_launches = windows * POOL_BATCH if beam else 0
        expect = expected_counts(fused_log_mel=run["forwards"],
                                 fused_separable_repeat=CITRINET_SEPARABLE * run["forwards"],
                                 beam_scan=beam_launches, beam_backtrace=beam_launches)
        differing = [k for k, text in enumerate(run["texts"]) if text != lone[k % POOL_CLIPS]]
        emit({"phase": "citrinet_streaming_pool", "decode": dname, "chunk_s": grid[0], "overlap_s": grid[1],
              "streams": POOL_BATCH, "clips": POOL_CLIPS, "seconds": STREAM_SECONDS, "windows_per_stream": windows,
              "forwards": run["forwards"], "launches": {k: v for k, v in runs[tag].items() if v},
              "streams_differing": differing, "text_chars": [len(t) for t in lone],
              "drain_push_latency": percentiles_ms(run["drain_pushes"]), "wall_s": run["wall_s"],
              "rtf": POOL_BATCH * STREAM_SECONDS / run["wall_s"], "card": card})
        check(runs[tag] == expect, f"{tag}: launched {runs[tag]}, expected {expect}")
        check(not differing, f"{tag}: streams {differing} differ from their lone streams")
    return runs


W2V_POOL_SECONDS = 10.0  # 7 windows a stream; the invariant engine runs each window's row alone
W2V_POOL_GRID = (2.0, 0.5)
WAVLM = dict(rel_pos_buckets=320, rel_pos_max_distance=800)  # transformers.WavLMConfig()'s buckets


def w2v2_create(config, device, seed: int = 0, dtype=None):
    """A wav2vec2-family ``CTCModule`` (``Wav2Vec2Preprocess(mask_input=True)``, a ``LinearDecoder`` over
    ``W2V_VOCAB``) with random weights from ``seed``; ``dtype`` the encoder's and decoder's compute type (float32
    by default)."""
    import torch

    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    tt = BatchTextTransformer(W2V_VOCAB)
    dtype = dtype or torch.float32
    return CTCModule.create(torch.Generator().manual_seed(seed), Wav2Vec2Preprocess(mask_input=True),
                            Wav2Vec2Encoder(config, dtype=dtype), LinearDecoder(tt.num_tokens, dtype=dtype), tt,
                            device=device)


def parting_rows_phase(card: str, device="cuda") -> dict:
    """Phase 32 of the module docstring: the rows of a 64 x 1 s batch that part from the same row alone on the
    wav2vec2-base engine and on phase 4's QuartzNet module (counted, not checked); then C19 on the wav2vec2
    engine: the ``batch_invariant`` engines of wav2vec2-base and WavLM (no row may part; timed against the default
    engine) and a pool of 64 streams on the base one against their lone streams. Returns the pool runs' launches,
    by run."""
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.models import Wav2Vec2Config

    audio, lengths = one_second_rows(stream_clips(POOL_BATCH, 1.0, seed=32), device)
    w2v = w2v2_create(Wav2Vec2Config(), device)
    counted = {"wav2vec2_engine": rows_parting(InferenceEngine(w2v), audio, lengths)}
    module, _, _ = served_quartznet(device)
    counted["quartznet_module"] = rows_parting(module, audio, lengths)
    del module
    emit({"phase": "parting_rows", "batch": int(audio.shape[0]), "seconds": 1.0,
          **{name: {"rows_differing": r, "argmax_flips": f} for name, (r, f) in counted.items()}, "card": card})

    for name, config in (("wav2vec2_base", Wav2Vec2Config()), ("wavlm", Wav2Vec2Config(**WAVLM))):
        module = w2v if name == "wav2vec2_base" else w2v2_create(config, device)
        default, invariant = InferenceEngine(module), InferenceEngine(module, batch_invariant=True)
        rows, flips = rows_parting(invariant, audio, lengths)
        logits, _, out_lengths = invariant.infer(audio, lengths)
        plain = default.infer(audio, lengths)[0]
        valid = lengths_valid(logits, out_lengths)
        dev = ((logits - plain).abs()[valid].max() / plain.abs()[valid].max()).item()
        forward_ms = {"default": [], "batch_invariant": []}
        for tag, eng in (("default", default), ("batch_invariant", invariant), ("batch_invariant", invariant),
                         ("default", default)):
            forward_ms[tag].append(cuda_ms(lambda: eng.infer(audio, lengths), 3))
        emit({"phase": "w2v2_batch_invariance", "model": name, "batch": int(audio.shape[0]), "seconds": 1.0,
              "rows_differing": rows, "argmax_flips": flips, "max_rel_dev_vs_default_engine": dev,
              "forward_ms_64x1s": forward_ms, "card": card})
        check(rows == 0, f"{name}: {rows} rows of the batch_invariant engine part from the same row alone")
        check(dev < LOGIT_BOUND, f"{name}: the batch_invariant engine's logits {dev} from the default engine's")

    engine = InferenceEngine(w2v, batch_invariant=True)
    distinct = stream_clips(POOL_BATCH, W2V_POOL_SECONDS, seed=33)
    clips = [distinct[k % POOL_CLIPS] for k in range(POOL_BATCH)]
    grid = W2V_POOL_GRID
    windows = grid_windows(int(W2V_POOL_SECONDS * SAMPLE_RATE), *grid)
    layers = w2v.model.encoder.config.num_hidden_layers
    runs = {}
    for dname, beam in (("greedy", {}), ("device_beam", STREAM_BEAM)):
        lone = [lone_reference(engine, c, grid, beam) for c in distinct[:POOL_CLIPS]]
        tag = f"w2v2_pool_{dname}_{grid[0]:g}s"
        reset_launch_counts()
        run = pool_run(engine, clips, grid, beam, 1, device)
        runs[tag] = launch_counts()
        rows_run = windows * POOL_BATCH  # the invariant engine runs each window's row alone, and no padding row
        beam_launches = windows * POOL_BATCH if beam else 0
        expect = expected_counts(mha_from_qkv=layers * rows_run, add_layer_norm=(2 * layers + 1) * rows_run,
                                 beam_scan=beam_launches, beam_backtrace=beam_launches)
        differing = [k for k, text in enumerate(run["texts"]) if text != lone[k % POOL_CLIPS]]
        emit({"phase": "w2v2_streaming_pool", "decode": dname, "chunk_s": grid[0], "overlap_s": grid[1],
              "streams": POOL_BATCH, "clips": POOL_CLIPS, "seconds": W2V_POOL_SECONDS, "windows_per_stream": windows,
              "forwards": run["forwards"], "launches": {k: v for k, v in runs[tag].items() if v},
              "streams_differing": differing, "text_chars": [len(t) for t in lone],
              "drain_push_latency": percentiles_ms(run["drain_pushes"]), "wall_s": run["wall_s"],
              "rtf": POOL_BATCH * W2V_POOL_SECONDS / run["wall_s"], "card": card})
        check(runs[tag] == expect, f"{tag}: launched {runs[tag]}, expected {expect}")
        check(not differing, f"{tag}: streams {differing} differ from their lone streams")
    return runs


def lengths_valid(logits, out_lengths):
    """``(B, T)`` True on each row's valid frames."""
    import torch

    return torch.arange(logits.shape[1], device=logits.device)[None, :] < out_lengths[:, None]


# ---- phases 33-34: the wav2vec2 family's variants

SEW_EXTRACTOR = dict(conv_dim=(64, 128, 128, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512),
                     conv_kernel=(10, 3, 1, 3, 1, 3, 1, 3, 1, 2, 1, 2, 1),
                     conv_stride=(5, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1))  # transformers.SEWConfig()'s
MMS_LAYERS = 12  # MMS-1b-all's 48 layers cut to 12: the whole run's time, which phases 35-41 grow
W2V_VARIANTS = {  # each published config's widths, written out: the card's machine reads no transformers config
    "wavlm": dict(**WAVLM),
    "data2vec_audio": dict(feat_extract_norm="layer", pos_conv_stack=True, num_conv_pos_embeddings=5,
                           conv_pos_kernel_size=19),
    "sew": dict(sew_style=True, squeeze_factor=2, **SEW_EXTRACTOR),
    "conv_adapter": dict(add_adapter=True, num_adapter_layers=3, adapter_stride=2),
    "mms_1b": dict(hidden_size=1280, num_hidden_layers=MMS_LAYERS, num_attention_heads=16, intermediate_size=5120,
                   feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True, adapter_attn_dim=16),
}
VARIANT_SHAPES = ("sew", "conv_adapter", "mms_1b")  # the kernels against their plain versions at these forwards' inputs


def variant_launches(config) -> dict:
    """The add + LayerNorm and attention kernel launches one serving forward of ``config`` makes, from the code:
    two add + LayerNorms a post-LN layer and one after the positional embedding (SEW's encoder LayerNorm is
    plain), none for stable LN; one attention a layer where the heads are 64 or 80 wide and no position bias is
    added."""
    from thunder_tpu_torch.kernels.attention import HEAD_DIMS

    post_ln = not config.do_stable_layer_norm
    add_ln = (2 * config.num_hidden_layers + (0 if config.sew_style else 1)) if post_ln else 0
    fused = config.hidden_size // config.num_attention_heads in HEAD_DIMS and not config.rel_pos_buckets
    return {"add_layer_norm": add_ln, "mha_from_qkv": config.num_hidden_layers if fused else 0}


def variant_frames(config, samples: int) -> int:
    from thunder_tpu_torch.models.wav2vec2 import feat_extract_output_lengths

    frames = feat_extract_output_lengths(samples, config.conv_kernel, config.conv_stride)
    for _ in range(config.num_adapter_layers if config.add_adapter else 0):
        frames = (frames - 1) // config.adapter_stride + 1
    return frames


def variant_kernel_shapes(name: str, engine, audio_d, lengths_d) -> dict:
    """Phase 34 for one variant (and phases 35-36 for a served shape): the attention and add + LayerNorm kernels
    on layer 0's inputs of one forward, against their plain versions, timed in turns with them, and beside their
    PyTorch calls (the split into heads + ``F.scaled_dot_product_attention`` with the key mask; ``F.layer_norm``
    of the float32 sum), timed only. Returns each kernel's shape line: the attention's as ``mha_from_qkv`` at
    heads of 64 and ``mha_from_qkv_dh80`` at 80; no add + LayerNorm line for a stable-LN model, which has none."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.kernels.add_ln import add_layer_norm, add_layer_norm_reference
    from thunder_tpu_torch.kernels.attention import mha_from_qkv, mha_from_qkv_reference
    from thunder_tpu_torch.kernels.selftest import KERNEL_CHECKS, ulp_bf16_error

    captured = {}

    def keep(name, value) -> None:  # a forward hook that returns None leaves the output as it is
        captured[name] = value

    layer0 = engine._encoder.layer0
    hooks = [layer0.attention.qkv_proj.register_forward_hook(lambda m, a, out: keep("qkv", out)),
             layer0.attention.register_forward_hook(lambda m, a, out: keep("lengths", a[1])),
             layer0.layer_norm.register_forward_hook(lambda m, a, out: keep("add_ln", a))]
    try:
        engine.infer(audio_d, lengths_d)
    finally:
        for hook in hooks:
            hook.remove()
    cfg = engine._encoder.config
    qkv, lens, heads = captured["qkv"], captured["lengths"].to(torch.int32), cfg.num_attention_heads
    dh = cfg.hidden_size // heads
    b, t = qkv.shape[:2]
    got, want = mha_from_qkv(qkv, lens, heads), mha_from_qkv_reference(qkv, lens, heads)
    a_err, a_ulp = (got.float() - want.float()).abs().max().item(), ulp_bf16_error(got, want)
    a_ms, a_plain = paired_ms(lambda: mha_from_qkv(qkv, lens, heads), lambda: mha_from_qkv_reference(qkv, lens, heads),
                              10)
    h = qkv.shape[-1] // 3
    key_mask = (torch.arange(t, device=qkv.device)[None, :] < lens[:, None])[:, None, None, :]

    def attention_library():
        q, k, v = (a.reshape(b, t, heads, h // heads).transpose(1, 2) for a in qkv.split(h, dim=-1))
        return F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask).transpose(1, 2).reshape(b, t, h)

    _, a_lib = paired_ms(lambda: mha_from_qkv(qkv, lens, heads), attention_library, 10)
    lines = {
        "mha_from_qkv" if dh == 64 else f"mha_from_qkv_dh{dh}": {
            "variant": name, "B": b, "T": t, "heads": heads, "dh": dh, "ms": a_ms, "plain_ms": a_plain,
            "library_ms": a_lib, "max_abs_err": a_err, "ulp": a_ulp, **attention_bound(b, t, heads, dh),
            "ms_is": "one launch on layer 0's qkv, host-paced, in turns with the plain version"},
    }
    check(a_ulp <= KERNEL_CHECKS["attn_onepanel"][1], f"{name}: attention off by {a_ulp} bf16 ULP")
    if not cfg.do_stable_layer_norm:
        x, y = (v.contiguous() for v in captured["add_ln"][:2])
        ln = layer0.layer_norm
        rows, d = x.numel() // x.shape[-1], x.shape[-1]
        got, want = add_layer_norm(x, y, ln.scale, ln.bias), add_layer_norm_reference(x, y, ln.scale, ln.bias)
        n_err, n_ulp = (got.float() - want.float()).abs().max().item(), ulp_bf16_error(got, want)
        n_ms, n_plain = paired_ms(lambda: add_layer_norm(x, y, ln.scale, ln.bias),
                                  lambda: add_layer_norm_reference(x, y, ln.scale, ln.bias), 50)
        n_lib = cuda_ms(lambda: F.layer_norm(x.float() + y.float(), (d,), ln.scale, ln.bias, ln.epsilon).to(x.dtype),
                        50)
        lines["add_layer_norm"] = {"variant": name, "rows": rows, "D": d, "ms": n_ms, "plain_ms": n_plain,
                                   "library_ms": n_lib, "max_abs_err": n_err, "ulp": n_ulp, **add_ln_bound(rows, d),
                                   "ms_is": "one launch on layer 0's first add + LayerNorm, host-paced, in turns "
                                            "with the plain version"}
        check(n_ulp <= KERNEL_CHECKS["add_ln"][1], f"{name}: add + LayerNorm off by {n_ulp} bf16 ULP")
    for kernel, line in lines.items():
        emit({"phase": "w2v2_variant_kernel_shape", "kernel": kernel, **line})
    return lines


def variants_phase(card: str, device="cuda") -> tuple:
    """Phases 33-34 of the module docstring. Returns the forwards' launches by variant and the kernels' lines at the
    variants' shapes by kernel."""
    import torch

    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.models import Wav2Vec2Config

    samples = int(W2V_SECONDS * SAMPLE_RATE)
    rng = np.random.default_rng(22)
    base = speech_like(samples, rng)
    audio = np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(W2V_BATCH)]).astype(np.float32)
    lengths = np.full((W2V_BATCH,), samples, dtype=np.int32)
    audio_d, lengths_d = torch.as_tensor(audio, device=device), torch.as_tensor(lengths, device=device)
    runs, shapes = {}, {"mha_from_qkv": [], "add_layer_norm": []}
    for name, overrides in W2V_VARIANTS.items():
        t_start = time.perf_counter()
        config = Wav2Vec2Config(**overrides)
        module = w2v2_create(config, device, seed=22)
        engine = InferenceEngine(module)
        create_s = time.perf_counter() - t_start
        engine.infer(audio_d, lengths_d)
        sync(device)
        reset_launch_counts()
        logits, _, out_lengths = engine.infer(audio_d, lengths_d)
        sync(device)
        runs[name] = launch_counts()
        want = expected_counts(**variant_launches(config))
        frames = variant_frames(config, samples)
        shape = (W2V_BATCH, frames, len(W2V_VOCAB) + 1)
        check(runs[name] == want, f"{name}: one forward launched {runs[name]}, expected {want}")
        check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == shape,
              f"{name}: logits not finite or of shape {tuple(logits.shape)}, expected {shape}")
        with plain_wav2vec2():
            plain = engine.infer(audio_d, lengths_d)[0]
        valid = lengths_valid(logits, out_lengths)
        plain_rel = ((logits - plain).abs()[valid].max() / plain.abs()[valid].max()).item()
        plain_agree = (logits.argmax(-1) == plain.argmax(-1))[valid].float().mean().item()
        t0 = time.perf_counter()
        f32, f32_lengths = module.forward(audio[:2], lengths[:2])  # the port's float32 path, on the card
        f32_s = time.perf_counter() - t0
        check(torch.equal(f32_lengths, out_lengths[:2]), f"{name}: the float32 path's lengths differ")
        ok = valid[:2]
        f32_rel = ((logits[:2] - f32).abs()[ok].max() / f32.abs()[ok].max()).item()
        f32_agree = (logits[:2].argmax(-1) == f32.argmax(-1))[ok].float().mean().item()
        del plain, f32
        torch.cuda.reset_peak_memory_stats()
        forward_ms = cuda_ms(lambda: engine.infer(audio_d, lengths_d), 3)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if device == "cuda":
            emit({"phase": "w2v2_variant_profile", "variant": name,
                  **device_profile(lambda: engine.infer(audio_d, lengths_d))})
        emit({"phase": "w2v2_variant", "variant": name, "batch": W2V_BATCH, "seconds": W2V_SECONDS,
              "hidden": config.hidden_size, "layers": config.num_hidden_layers, "heads": config.num_attention_heads,
              "frames": frames, "launches": {k: v for k, v in runs[name].items() if v},
              "predicted": variant_launches(config),
              "max_rel_dev_vs_plain": plain_rel, "argmax_agreement_vs_plain": plain_agree,
              "rows01_max_rel_dev_vs_f32_card": f32_rel, "rows01_argmax_agreement_vs_f32": f32_agree,
              "bound": LOGIT_BOUND, "forward_ms": forward_ms, "rtf": W2V_BATCH * W2V_SECONDS / (forward_ms / 1e3),
              "peak_mem_gb": peak_gb, "create_s": create_s, "f32_rows01_s": f32_s,
              "phase_s": time.perf_counter() - t_start, "card": card})
        check(plain_rel < LOGIT_BOUND, f"{name}: kernels vs plain versions deviate by {plain_rel}")
        check(f32_rel < LOGIT_BOUND, f"{name}: bf16 engine vs float32 on the card deviate by {f32_rel}")
        if name in VARIANT_SHAPES:
            for kernel, line in variant_kernel_shapes(name, engine, audio_d, lengths_d).items():
                shapes.setdefault(kernel, []).append(line)
        del engine, module, logits
        gc.collect()
        torch.cuda.empty_cache()
    return runs, shapes


# ---- phases 35-39: wav2vec2-large-960h served and trained, wav2vec2-base at 8 x 30 s, the extractor trained at
# 8 x 15 s, the exported predict graph

#: ``facebook/wav2vec2-large-960h``'s published config, written out (the card's machine reads no transformers config);
#: the rest is ``Wav2Vec2Config``'s defaults, which are that checkpoint's: a group-norm extractor of seven 512-channel
#: convs without biases, post-LN layers, the k=128 positional conv in 16 groups, 32 classes (``W2V_VOCAB`` + blank)
W2V_LARGE = dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096)
W2V_LARGE_SHAPES = ((16, 15.0), (8, 30.0))  # (rows, seconds) served: T 749 and 1499
W2V_BASE_30S_SHAPES = ((8, 30.0),)
W2V_CELL_TIMED = 5  # forwards and steps timed a cell (CUDA events, the mean)
W2V_CELL_SEED = 23
# the last of the 1 + W2V_TRAIN_WARMUP + W2V_TRAIN_TIMED = 8 losses of the extractor-trained step must be below
# (1 - W2V_NO_FREEZE_LOSS_FALL) x the first; on the port's float32 CPU path of the card's machine
# (``w2v2_cpu_loss_fall``) the same configuration at 4 x 3 s (hidden 128, 2 layers) and 2 x 6 s (hidden 256, 4 layers)
# ended its 8th step at 0.373 and 0.375 of the first (0.397 and 0.396 with the extractor frozen)
W2V_NO_FREEZE_LOSS_FALL = W2V_LOSS_FALL
AOT_BATCH, AOT_SECONDS = 8, 15.0
#: the exported QuartzNet's depth: QuartzNet5x5, phase 4's five blocks once each (export and load grow with the
#: graph's nodes, 4,821 at 15x5: the whole run's time)
AOT_QN = dict(repeat_blocks=1)
# runs in a fresh ``python3``, float32 in full as this process runs it (``exact_float32``: cuDNN's float32
# convolutions would take TF32 by default): for each exported predict graph, ``aot_load``, one call on the saved
# batch (its launches), then the median of W2V_CELL_TIMED synchronized calls on the host clock (``host_ms``'s way);
# prints one line a graph, with the SHA-256 of what the call returns
AOT_RUNNER = """import hashlib, json, sys, time
import numpy as np
import torch
from thunder_tpu_torch.export import aot_load
from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
from thunder_tpu_torch.kernels.selftest import exact_float32
exact_float32()
audio_path, lengths_path, timed, *paths = sys.argv[1:]
for path in paths:
    t0 = time.perf_counter()
    loaded = aot_load(path)
    load_s = time.perf_counter() - t0
    sync = torch.cuda.synchronize if loaded.device.type == "cuda" else (lambda: None)
    audio = torch.as_tensor(np.load(audio_path), device=loaded.device)
    lengths = torch.as_tensor(np.load(lengths_path), device=loaded.device)
    loaded.call(audio, lengths)
    sync()
    reset_launch_counts()
    preds, out_lengths = loaded.call(audio, lengths)
    sync()
    launches = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    times = []
    for _ in range(int(timed)):
        t0 = time.perf_counter()
        loaded.call(audio, lengths)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    sha = lambda t: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    print("aot_result " + json.dumps({"path": path, "load_s": load_s, "launches": launches,
                                      "preds_sha256": sha(preds), "lengths_sha256": sha(out_lengths),
                                      "preds_dtype": str(preds.dtype), "call_ms": float(np.median(times))}), flush=True)
"""


def w2v2_flops_kwargs(config) -> dict:
    """``wav2vec2_forward_flops``'s widths of ``config``, with the CTC head over ``W2V_VOCAB`` and the blank."""
    return dict(hidden_size=config.hidden_size, num_hidden_layers=config.num_hidden_layers,
                intermediate_size=config.intermediate_size, conv_dim=tuple(config.conv_dim),
                conv_kernel=tuple(config.conv_kernel), conv_stride=tuple(config.conv_stride),
                num_classes=len(W2V_VOCAB) + 1)


def speech_batch(batch: int, seconds: float, seed: int) -> tuple:
    """``batch`` rows of one speech-like signal at random gains, full length: ``(audio, lengths)``."""
    samples = int(seconds * SAMPLE_RATE)
    rng = np.random.default_rng(seed)
    base = speech_like(samples, rng)
    audio = np.stack([base * (0.7 + 0.6 * rng.random()) for _ in range(batch)]).astype(np.float32)
    return audio, np.full((batch,), samples, dtype=np.int32)


def peak_check(card: str) -> float:
    """``flops.peak_flops()`` on this card: 989e12 on the H100 SXM ("NVIDIA H100 80GB HBM3")."""
    import torch

    from thunder_tpu_torch.flops import peak_flops

    peak = peak_flops()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "peak_flops", "device_name": name, "peak_flops": peak, "card": card})
    if name == "NVIDIA H100 80GB HBM3":
        check(peak == 989e12, f"peak_flops() on {name} is {peak}, not 989e12")
    return peak


def w2v2_serving_cells_phase(card: str, phase: str, config, shapes, profile: bool, device="cuda") -> tuple:
    """Phases 35 and 36 of the module docstring: a wav2vec2 ``CTCModule`` (random weights, seed
    ``W2V_CELL_SEED``) on a bf16 ``InferenceEngine`` at each of ``shapes``: one forward's launches (an attention
    a layer, two add + LayerNorms a layer and one more), the logits finite and of their shape, rows 0-1 within
    ``LOGIT_BOUND`` of the module's float32 forward on the card, the forward's ms (CUDA events, mean of
    ``W2V_CELL_TIMED``), peak memory, model FLOPs and MFU; both kernels on layer 0's inputs against their plain
    versions (``variant_kernel_shapes``). Returns the forwards' launches by shape and the kernels' shape lines."""
    import torch

    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.flops import mfu, wav2vec2_forward_flops
    from thunder_tpu_torch.kernels import reset_launch_counts

    t_start = time.perf_counter()
    module = w2v2_create(config, device, seed=W2V_CELL_SEED)
    engine = InferenceEngine(module)
    create_s = time.perf_counter() - t_start
    layers = config.num_hidden_layers
    want = expected_counts(mha_from_qkv=layers, add_layer_norm=2 * layers + 1)
    runs, lines = {}, {"mha_from_qkv": [], "add_layer_norm": []}
    for i, (batch, seconds) in enumerate(shapes):
        tag = f"{batch}x{seconds:g}s"
        audio, lengths = speech_batch(batch, seconds, W2V_CELL_SEED)
        samples = audio.shape[1]
        audio_d, lengths_d = torch.as_tensor(audio, device=device), torch.as_tensor(lengths, device=device)
        engine.infer(audio_d, lengths_d)
        sync(device)
        reset_launch_counts()
        logits, _, out_lengths = engine.infer(audio_d, lengths_d)
        sync(device)
        runs[tag] = launch_counts()
        frames = variant_frames(config, samples)
        shape = (batch, frames, len(W2V_VOCAB) + 1)
        check(runs[tag] == want, f"{phase} {tag}: one forward launched {runs[tag]}, expected {want}")
        check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == shape,
              f"{phase} {tag}: logits not finite or of shape {tuple(logits.shape)}, expected {shape}")
        f32, f32_lengths = module.forward(audio[:2], lengths[:2])  # the port's float32 path, on the card
        check(torch.equal(f32_lengths, out_lengths[:2]), f"{phase} {tag}: the float32 path's lengths differ")
        ok = lengths_valid(f32, f32_lengths)
        f32_rel = ((logits[:2] - f32).abs()[ok].max() / f32.abs()[ok].max()).item()
        f32_agree = (logits[:2].argmax(-1) == f32.argmax(-1))[ok].float().mean().item()
        del f32
        torch.cuda.reset_peak_memory_stats()
        forward_ms = cuda_ms(lambda: engine.infer(audio_d, lengths_d), W2V_CELL_TIMED)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        model_flops = wav2vec2_forward_flops(samples, batch=batch, **w2v2_flops_kwargs(config))
        if profile and i == 0:
            emit({"phase": f"{phase}_profile", "shape": tag, **device_profile(lambda: engine.infer(audio_d, lengths_d))})
        emit({"phase": phase, "shape": tag, "batch": batch, "seconds": seconds, "hidden": config.hidden_size,
              "layers": layers, "heads": config.num_attention_heads, "frames": frames,
              "launches": {k: v for k, v in runs[tag].items() if v}, "rows01_max_rel_dev_vs_f32_card": f32_rel,
              "rows01_argmax_agreement_vs_f32": f32_agree, "bound": LOGIT_BOUND, "forward_ms": forward_ms,
              "forward_ms_is": f"CUDA events, mean of {W2V_CELL_TIMED} forwards back to back",
              "rtf": batch * seconds / (forward_ms / 1e3), "peak_mem_gb": peak_gb, "model_flops": model_flops,
              "mfu": mfu(model_flops, forward_ms / 1e3), "create_s": create_s,
              "phase_s": time.perf_counter() - t_start, "card": card})
        check(f32_rel < LOGIT_BOUND, f"{phase} {tag}: bf16 engine vs float32 on the card deviate by {f32_rel}")
        for kernel, line in variant_kernel_shapes(f"{phase}_{tag}", engine, audio_d, lengths_d).items():
            lines[kernel].append(line)
        del logits, audio_d
    del engine, module
    gc.collect()
    torch.cuda.empty_cache()
    return runs, lines


def w2v2_train_create(overrides: dict, device, dtype, dropout: float, freeze: bool):
    """wav2vec2 for CTC training (``bench_train.py --model wav2vec2``'s: ``Wav2Vec2Preprocess(mask_input=False)``,
    attention, hidden and feature-projection dropout at ``dropout``, the 29-token ``VOCAB``): the same weights
    (generator seed 0) whatever the device, dtype and rates. ``overrides`` may set ``attention_dropout`` apart."""
    import torch

    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    tt = BatchTextTransformer(VOCAB)
    cfg = Wav2Vec2Config(**{"hidden_dropout": dropout, "attention_dropout": dropout, "feat_proj_dropout": dropout,
                            **overrides})
    encoder = Wav2Vec2Encoder(cfg, dtype=dtype, freeze_feature_extractor=freeze)
    return CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=False), encoder,
                            LinearDecoder(tt.num_tokens, dtype=dtype), tt, device=device)


def w2v2_cpu_loss_fall(batch: int, seconds: float, freeze: bool, **overrides) -> dict:
    """A wav2vec2 training cell's 8 losses on the port's float32 CPU path (the plain versions of every kernel) at
    ``batch`` x ``seconds`` and the widths ``overrides`` give, from which the cell's loss-fall margin is set;
    needs no card: ``python3 -c "import chip_smoke; print(chip_smoke.w2v2_cpu_loss_fall(4, 3.0, False,
    hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256))"``."""
    import torch

    from thunder_tpu_torch.training.optim import adamw
    from thunder_tpu_torch.training.trainer import TrainStep, _encode_targets

    module = w2v2_train_create(overrides, "cpu", torch.float32, 0.1, freeze)
    samples = int(seconds * SAMPLE_RATE)
    audio = torch.as_tensor((np.random.default_rng(0).standard_normal((batch, samples)) * 0.1).astype(np.float32))
    lengths = torch.full((batch,), samples, dtype=torch.int32)
    targets, target_lengths = _encode_targets(module.text_transform, [TRAIN_TEXT] * batch)
    step = TrainStep(module.model, adamw(module.model.parameters(), learning_rate=1e-4), module.blank_idx)
    generator = torch.Generator().manual_seed(0)
    losses = [step(audio, lengths, torch.as_tensor(targets), torch.as_tensor(target_lengths), generator).item()
              for _ in range(1 + W2V_TRAIN_WARMUP + W2V_TRAIN_TIMED)]
    return {"batch": batch, "seconds": seconds, "freeze": freeze, "widths": overrides, "losses": losses,
            "last_over_first": losses[-1] / losses[0]}


def layer0_step_inputs(model, step, batch: tuple, generator) -> dict:
    """What one step of ``step`` gives wav2vec2's layer 0: its packed qkv (``"qkv"``), the cotangent of its
    attention output (``"attn_dout"``), its first add + LayerNorm's inputs (``"add_ln"``) and that output's
    cotangent (``"add_ln_dout"``), detached."""
    captured = {}

    def grad_of(name, tensor) -> None:
        tensor.register_hook(lambda g: captured.__setitem__(name, g.detach()))

    def on_add_ln(mod, args, out) -> None:
        captured["add_ln"] = tuple(a.detach().contiguous() for a in args[:2])
        grad_of("add_ln_dout", out)

    layer0 = model.encoder.layer0
    hooks = [layer0.attention.qkv_proj.register_forward_hook(lambda m, a, out: captured.__setitem__("qkv", out.detach())),
             layer0.attention.out_proj.register_forward_pre_hook(lambda m, a: grad_of("attn_dout", a[0])),
             layer0.layer_norm.register_forward_hook(on_add_ln)]
    try:
        step(*batch, generator)
    finally:
        for hook in hooks:
            hook.remove()
    sync(batch[0].device)
    return captured


def train_kernel_shapes(phase: str, model, step, batch: tuple, generator, rate: float) -> dict:
    """The training kernels on the inputs one step of ``step`` gives layer 0 (its packed qkv and the cotangent of
    its attention output, its first add + LayerNorm's inputs and cotangent, each cotangent at unit scale):
    forward and backward against their plain versions (``TRAIN_KERNEL_ULP``; dscale and dbias 1 %), timed in
    turns with them, beside their PyTorch calls forward + backward (the split into heads +
    ``F.scaled_dot_product_attention`` with the key mask and ``dropout_p``; ``F.dropout`` + ``F.layer_norm`` of the
    float32 sum), timed only. Returns each kernel's line."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.kernels.add_ln_train import (
        add_ln_train_backward,
        add_ln_train_backward_reference,
        add_ln_train_forward,
        add_ln_train_forward_reference,
    )
    from thunder_tpu_torch.kernels.attention_train import (
        mha_train_backward,
        mha_train_backward_reference,
        mha_train_forward,
        mha_train_forward_reference,
    )
    from thunder_tpu_torch.kernels.selftest import ulp_bf16_error

    captured = layer0_step_inputs(model, step, batch, generator)
    layer0 = model.encoder.layer0
    cfg = model.encoder.config
    heads, h = cfg.num_attention_heads, cfg.hidden_size
    dh = h // heads
    qkv, dout = captured["qkv"].contiguous(), to_unit_scale(captured["attn_dout"].contiguous())
    b, frames = qkv.shape[:2]
    lens = torch.full((b,), frames, dtype=torch.int32, device=qkv.device)
    seed = torch.tensor([20261018], dtype=torch.int32, device=qkv.device)
    out, stats = mha_train_forward(qkv, lens, seed, heads, rate)
    dqkv = mha_train_backward(qkv, out, stats, dout, lens, seed, heads, rate)
    out_p, _ = mha_train_forward_reference(qkv, lens, seed, heads, rate)
    dqkv_p = mha_train_backward_reference(qkv, out, stats, dout, lens, seed, heads, rate)
    parts = dict(zip(("dq", "dk", "dv"), zip(dqkv.split(h, dim=-1), dqkv_p.split(h, dim=-1))))
    a_ulp = {"fwd": ulp_bf16_error(out, out_p), **{n: ulp_bf16_error(g, w) for n, (g, w) in parts.items()}}
    a_err = max((out.float() - out_p.float()).abs().max().item(), (dqkv.float() - dqkv_p.float()).abs().max().item())
    del out_p, dqkv_p, parts
    af_ms, af_plain = paired_ms(lambda: mha_train_forward(qkv, lens, seed, heads, rate),
                                lambda: mha_train_forward_reference(qkv, lens, seed, heads, rate), 5)
    ab_ms, ab_plain = paired_ms(lambda: mha_train_backward(qkv, out, stats, dout, lens, seed, heads, rate),
                                lambda: mha_train_backward_reference(qkv, out, stats, dout, lens, seed, heads, rate), 5)
    key_mask = (torch.arange(frames, device=qkv.device)[None, :] < lens[:, None])[:, None, None, :]
    leaf = qkv.clone().requires_grad_(True)

    def attention_library():
        q, k, v = (a.reshape(b, frames, heads, h // heads).transpose(1, 2) for a in leaf.split(h, dim=-1))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask, dropout_p=rate)
        return torch.autograd.grad(o.transpose(1, 2).reshape(b, frames, h), leaf, dout)

    a_lib = cuda_ms(attention_library, 5)
    check(max(a_ulp.values()) <= TRAIN_KERNEL_ULP, f"{phase}: training attention off by {a_ulp} bf16 ULP")
    a_fwd_bound, a_bwd_bound = attention_train_bounds(b, frames, heads, dh)
    lines = {
        "mha_train": {"shape_of": phase, "B": b, "T": frames, "heads": heads, "dh": dh, "rate": rate,
                      "ms": af_ms + ab_ms, "fwd_ms": af_ms, "bwd_ms": ab_ms, "plain_ms": af_plain + ab_plain,
                      "plain_fwd_ms": af_plain, "plain_bwd_ms": ab_plain, "library_ms": a_lib, "max_abs_err": a_err,
                      "ulp": a_ulp, **sum_bounds(a_fwd_bound, a_bwd_bound), "bound_fwd_ms": a_fwd_bound["bound_ms"],
                      "bound_bwd_ms": a_bwd_bound["bound_ms"],
                      "ms_is": "forward + backward on layer 0's qkv and cotangent, host-paced, in turns with the "
                               "plain versions"},
    }
    if cfg.do_stable_layer_norm:  # plain LayerNorms: no add + LayerNorm kernel to hold
        emit({"phase": "w2v2_train_kernel_shape", "kernel": "mha_train", **lines["mha_train"]})
        return lines

    (x, y), n_dout = captured["add_ln"], to_unit_scale(captured["add_ln_dout"].contiguous())
    ln = layer0.layer_norm
    scale, bias = ln.scale.detach(), ln.bias.detach()
    rows = x.numel() // h
    got = (add_ln_train_forward(x, y, scale, bias, seed, rate), *add_ln_train_backward(x, y, scale, seed, n_dout, rate))
    plain = (add_ln_train_forward_reference(x, y, scale, bias, seed, rate),
             *add_ln_train_backward_reference(x, y, scale, seed, n_dout, rate))
    n_ulp = {name: ulp_bf16_error(got[i], plain[i]) for i, name in enumerate(("fwd", "dx", "dy"))}
    n_rel = {name: ((got[i] - plain[i]).abs().max() / plain[i].abs().max().clamp_min(1e-9)).item()
             for i, name in ((3, "dscale"), (4, "dbias"))}
    n_err = max((g.float() - q.float()).abs().max().item() for g, q in zip(got[:3], plain[:3]))
    nf_ms, nf_plain = paired_ms(lambda: add_ln_train_forward(x, y, scale, bias, seed, rate),
                                lambda: add_ln_train_forward_reference(x, y, scale, bias, seed, rate), 20)
    nb_ms, nb_plain = paired_ms(lambda: add_ln_train_backward(x, y, scale, seed, n_dout, rate),
                                lambda: add_ln_train_backward_reference(x, y, scale, seed, n_dout, rate), 20)
    leaves = [a.clone().requires_grad_(True) for a in (x, y, scale, bias)]

    def add_ln_library():
        xl, yl, sl, bl = leaves
        o = F.layer_norm(xl.float() + F.dropout(yl, rate, training=True).float(), (h,), sl, bl, ln.epsilon)
        return torch.autograd.grad(o.to(xl.dtype), leaves, n_dout)

    n_lib = cuda_ms(add_ln_library, 20)
    check(max(n_ulp.values()) <= TRAIN_KERNEL_ULP and max(n_rel.values()) <= 0.01,
          f"{phase}: add + dropout + LayerNorm off by {n_ulp} bf16 ULP, {n_rel} relative")
    n_fwd_bound, n_bwd_bound = add_ln_train_bounds(rows, h)
    lines.update({
        "add_ln_dropout_train": {"shape_of": phase, "rows": rows, "D": h, "rate": rate, "ms": nf_ms + nb_ms,
                                 "fwd_ms": nf_ms, "bwd_ms": nb_ms, "plain_ms": nf_plain + nb_plain,
                                 "library_ms": n_lib, "max_abs_err": n_err, "ulp": n_ulp, "rel": n_rel,
                                 **sum_bounds(n_fwd_bound, n_bwd_bound),
                                 "ms_is": "forward + backward (with its partial sum) on layer 0's first add + "
                                          "LayerNorm, host-paced, in turns with the plain versions"},
    })
    for kernel, line in lines.items():
        emit({"phase": "w2v2_train_kernel_shape", "kernel": kernel, **line})
    return lines


def w2v2_training_cell(card: str, phase: str, overrides: dict, freeze: bool, loss_fall: float,
                       kernel_shapes: bool = False, device="cuda") -> tuple:
    """Phases 37 and 38 of the module docstring: wav2vec2 (``overrides``' widths) CTC training at
    ``W2V_TRAIN_BATCH`` x ``W2V_SECONDS`` (``w2v2_train_create``: dropout 0.1, bf16 compute with float32
    parameters, AdamW lr 1e-4, noise audio from numpy seed 0, the fixed text), the extractor frozen or trained:
    one ``Trainer.fit`` step's launches; ``W2V_TRAIN_WARMUP`` + 1 steps, then ``W2V_TRAIN_TIMED`` timed (CUDA
    events) with peak memory, model FLOPs and MFU; every loss finite and the last below ``1 - loss_fall`` times the
    first; one profiled step; the frozen extractor decays by lr x wd a step, or every extractor parameter gets a
    nonzero gradient and moves past the decay at the optimizer step; the train-mode loss with every dropout rate 0,
    bf16 on the card, within ``W2V_TRAIN_LOSS_BOUND`` of float32 on the CPU on rows 0-1; with ``kernel_shapes``
    the training kernels at the step's shapes (``train_kernel_shapes``, at the attention's rate). ``overrides``
    may set ``attention_dropout`` apart from the other rates; a stable-LN model launches no add + LayerNorm
    kernel. Returns one step's launches and the kernels' lines."""
    import torch

    from thunder_tpu_torch.flops import mfu, wav2vec2_train_flops
    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.training.optim import adamw
    from thunder_tpu_torch.training.trainer import Trainer, TrainStep, _encode_targets

    t_start = time.perf_counter()
    bf16, rate, b = torch.bfloat16, 0.1, W2V_TRAIN_BATCH
    samples = int(W2V_SECONDS * SAMPLE_RATE)
    audio = (np.random.default_rng(0).standard_normal((b, samples)) * 0.1).astype(np.float32)
    lengths = np.full((b,), samples, dtype=np.int32)
    texts = [TRAIN_TEXT] * b
    module = w2v2_train_create(overrides, device, bf16, rate, freeze)
    cfg = module.model.encoder.config
    layers = cfg.num_hidden_layers
    add_ln = 0 if cfg.do_stable_layer_norm else 2 * layers + 1
    Trainer(seed=0, device=device).fit(module, [(audio, lengths, texts)])  # warms up
    reset_launch_counts()
    trainer = Trainer(seed=0, log_every=1, device=device)
    trainer.fit(module, [(audio, lengths, texts)])
    sync(device)
    counts = launch_counts()
    want = expected_counts(mha_train_forward=layers, mha_train_backward=2 * layers, add_ln_train_forward=add_ln,
                           add_ln_train_backward=2 * add_ln, ctc_alpha=1, ctc_beta=1)
    check(counts == want, f"{phase}: one train step must launch {want}, got {counts}")
    check(np.isfinite(trainer.logs[0]["loss/train_loss"]), f"{phase}: Trainer.fit loss {trainer.logs[0]}")

    targets, target_lengths = _encode_targets(module.text_transform, texts)
    batch = tuple(torch.as_tensor(a, device=device) for a in (audio, lengths, targets, target_lengths))
    model = module.model
    lr, wd = 1e-4, 1e-2
    step = TrainStep(model, adamw(model.parameters(), learning_rate=lr), module.blank_idx)
    generator = torch.Generator(device=device).manual_seed(0)
    extractor = dict(model.encoder.feature_extractor.named_parameters())
    before = {n: p.detach().clone() for n, p in extractor.items()}
    grads = {}
    hooks = [] if freeze else [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, float(p.grad.float().abs().sum()))) for n, p in extractor.items()]
    losses = [step(*batch, generator)]
    for hook in hooks:
        hook.remove()
    # a first AdamW step moves each weight with a gradient by about lr, past the decay lr * wd * w of one without
    moved = {n: (p.detach() - before[n] * (1 - lr * wd)).abs().max().item() > 0.5 * lr for n, p in extractor.items()}
    conv0 = extractor["conv0.kernel"]
    norm_first = conv0.detach().double().norm().item() / before["conv0.kernel"].double().norm().item()
    losses += [step(*batch, generator) for _ in range(W2V_TRAIN_WARMUP)]
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(W2V_TRAIN_TIMED):
        losses.append(step(*batch, generator))
    end.record()
    sync(device)
    step_ms = start.elapsed_time(end) / W2V_TRAIN_TIMED
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [loss.item() for loss in losses]
    shrink = conv0.detach().double().norm().item() / before["conv0.kernel"].double().norm().item()
    model_flops = wav2vec2_train_flops(samples, batch=b, frozen_extractor=freeze, **w2v2_flops_kwargs(cfg))
    profile = device_profile(lambda: step(*batch, generator))
    emit({"phase": f"{phase}_profile", **profile})

    with torch.no_grad():
        card_loss, _ = w2v2_train_create(overrides, device, bf16, 0.0, freeze).loss(
            audio[:2], lengths[:2], targets[:2], target_lengths[:2], train=True)
        t0 = time.perf_counter()
        cpu_loss, _ = w2v2_train_create(overrides, "cpu", torch.float32, 0.0, freeze).loss(
            audio[:2], lengths[:2], targets[:2], target_lengths[:2], train=True)
        cpu_s = time.perf_counter() - t0
    rel = abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    line = {"phase": phase, "batch": b, "seconds": W2V_SECONDS, "frames": variant_frames(cfg, samples),
            "hidden": cfg.hidden_size, "layers": layers, "heads": cfg.num_attention_heads,
            "attention_dropout": cfg.attention_dropout, "freeze_feature_extractor": freeze,
            "launches": {k: v for k, v in counts.items() if v}, "step_ms": step_ms,
            "step_ms_is": f"CUDA events, mean of {W2V_TRAIN_TIMED} steps back to back",
            "audio_s_per_s": b * W2V_SECONDS / (step_ms / 1e3), "peak_mem_gb": peak_gb, "losses": losses,
            "loss_fall_limit": 1 - loss_fall, "model_flops": model_flops, "mfu": mfu(model_flops, step_ms / 1e3),
            "card_loss_dropout0": card_loss.item(), "cpu_f32_loss_dropout0": cpu_loss.item(), "rel_dev": rel,
            "rel_bound": W2V_TRAIN_LOSS_BOUND, "cpu_seconds": cpu_s, "phase_s": time.perf_counter() - t_start,
            "card": card}
    if freeze:
        line["conv0_shrink"], line["conv0_shrink_want"] = shrink, (1 - lr * wd) ** len(losses)
    else:
        line["extractor_grad_abs_sum"] = grads
        line["extractor_parameters_not_moved"] = [n for n, m in moved.items() if not m]
        line["conv0_norm_ratio_first_step"] = norm_first
    emit(line)
    check(all(np.isfinite(losses)), f"{phase}: non-finite loss: {losses}")
    check(losses[-1] < (1 - loss_fall) * losses[0],
          f"{phase}: the loss did not fall by {loss_fall:.0%} over {len(losses)} steps: {losses[0]} -> {losses[-1]}")
    check(rel < W2V_TRAIN_LOSS_BOUND, f"{phase}: bf16 card loss vs f32 CPU loss off by {rel} >= {W2V_TRAIN_LOSS_BOUND}")
    if freeze:
        check(abs(shrink - line["conv0_shrink_want"]) < 1e-6,
              f"{phase}: the frozen extractor's conv0 shrank by {shrink}, expected {line['conv0_shrink_want']}")
    else:
        no_grad = sorted(set(extractor) - {n for n, g in grads.items() if g > 0})
        check(not no_grad and not line["extractor_parameters_not_moved"],
              f"{phase}: extractor parameters without a gradient {no_grad}, not moved past the decay "
              f"{line['extractor_parameters_not_moved']}")
    lines = train_kernel_shapes(phase, model, step, batch, generator, cfg.attention_dropout) if kernel_shapes else {}
    del module, model, step, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return counts, lines


def w2v2_cells(card: str, device="cuda") -> tuple:
    """Phases 35-39 of the module docstring, in order. Returns every run's launches, by run, and the kernels' lines
    at wav2vec2-large's shapes, by kernel."""
    from thunder_tpu_torch.models import Wav2Vec2Config

    peak_check(card)
    runs, lines = {}, {}
    for phase, config, shapes, profile in (("w2v2_large_serving", Wav2Vec2Config(**W2V_LARGE), W2V_LARGE_SHAPES, True),
                                           ("w2v2_serving_30s", Wav2Vec2Config(), W2V_BASE_30S_SHAPES, False)):
        served, shape_lines = w2v2_serving_cells_phase(card, phase, config, shapes, profile, device)
        runs.update({f"{phase}_{tag}": counts for tag, counts in served.items()})
        if phase == "w2v2_large_serving":
            lines.update(shape_lines)
    runs["w2v2_large_training"], train_lines = w2v2_training_cell(card, "w2v2_large_training", W2V_LARGE, True,
                                                                  W2V_LOSS_FALL, kernel_shapes=True, device=device)
    lines.update({k: [v] for k, v in train_lines.items()})
    runs["w2v2_training_no_freeze"], _ = w2v2_training_cell(card, "w2v2_training_no_freeze", {}, False,
                                                            W2V_NO_FREEZE_LOSS_FALL, device=device)
    runs.update({f"aot_{name}": counts for name, counts in aot_export_phase(card, device).items()})
    return runs, lines


# ---- phase 42: MMS-1b's widths trained at attention dropout 0, on the dh-80 training kernels

def mms_training_phase(card: str, device="cuda") -> tuple:
    """Phase 42 of the module docstring: ``w2v2_training_cell`` on ``W2V_VARIANTS["mms_1b"]`` at attention dropout
    0. Returns one step's launches and the dh-80 training kernels' line at the step's shape."""
    t0 = time.perf_counter()
    counts, lines = w2v2_training_cell(card, "mms_training", {**W2V_VARIANTS["mms_1b"], "attention_dropout": 0.0},
                                       True, W2V_LOSS_FALL, kernel_shapes=True, device=device)
    emit({"phase": "mms_training_seconds", "seconds": time.perf_counter() - t0})
    return counts, lines["mha_train"]


def dh80_kernel_entries(serving_runs: dict, serving_line: dict, training_runs: dict, training_line: dict,
                        checks: list) -> list:
    """The kernels line's entries of the dh-80 instantiations: the serving attention from MMS-1b's forward (phase
    33's launches, phase 34's shape line) and the training attention from MMS-1b's train step (phase 42), each
    with its phase-3 checks (``attn_*_dh80``: error, tolerance in bf16 ULP, ok)."""
    flash = "thunder_tpu/models/wav2vec2.py:662"
    served, trained = serving_line, training_line

    def checks_of(prefix: str) -> dict:
        return {r["name"]: {"max_err": r["max_err"], "tol": r["tol"], "ok": r["ok"]} for r in checks
                if r["name"].startswith(prefix) and r["name"].endswith(("_dh80", "_dh80_grad", "_dh80_749"))}

    return [
        {"name": "mha_from_qkv_dh80", "route": "cuda", "source": "thunder_tpu_torch/csrc/mha_from_qkv.cu",
         "replaces": flash, "launches": serving_runs["mha_from_qkv"],
         "launches_is": "one MMS-1b forward (12 layers) at 16 x 15 s (phase 33)", "max_abs_err": served["max_abs_err"],
         "max_ulp": served["ulp"], "ms": served["ms"], "plain_ms": served["plain_ms"],
         "ms_is": f"one launch at B={served['B']}, T={served['T']}, {served['heads']} heads of 80 (layer 0's qkv of "
                  "that forward), host-paced, in turns with the plain version",
         "bound_ms": served["bound_ms"], "bound_by": served["bound_by"], "library_ms": served["library_ms"],
         "library": "split into (B, heads, T, 80) + F.scaled_dot_product_attention with the key mask",
         "checks": checks_of("attn_onepanel")},
        {"name": "mha_train_dh80", "route": "cuda", "source": "thunder_tpu_torch/csrc/mha_train.cu",
         "replaces": flash, "launches": training_runs["mha_train_forward"] + training_runs["mha_train_backward"],
         "launches_is": "12 forward + 24 backward (dq, then dk/dv) in one MMS-1b train step at 8 x 15 s, attention "
                        "dropout 0 (phase 42)",
         "max_abs_err": trained["max_abs_err"], "max_ulp": max(trained["ulp"].values()), "ms": trained["ms"],
         "fwd_ms": trained["fwd_ms"], "bwd_ms": trained["bwd_ms"], "plain_ms": trained["plain_ms"],
         "plain_fwd_ms": trained["plain_fwd_ms"], "plain_bwd_ms": trained["plain_bwd_ms"],
         "ms_is": f"forward + backward at B={trained['B']}, T={trained['T']}, {trained['heads']} heads of 80, rate 0 "
                  "(layer 0's qkv and cotangent of a step), host-paced, in turns with the plain versions",
         "bound_ms": trained["bound_ms"], "bound_by": trained["bound_by"], "bound_fwd_ms": trained["bound_fwd_ms"],
         "bound_bwd_ms": trained["bound_bwd_ms"], "library_ms": trained["library_ms"],
         "library": "split into (B, heads, T, 80) + F.scaled_dot_product_attention with the key mask, forward + "
                    "backward", "checks": checks_of("attn_train")},
    ]


# ---- phase 40: Trainer(steps_per_execution=K), the whole train step as CUDA graph replays

SCAN_K = 4  # steps a chunk
SCAN_LR = 1e-4  # AdamW, ``bench_train.py``'s


def scan_create(model: str, device="cuda"):
    """The train-step models of phase 40 at their published widths, random weights from generator seed 0, in
    ``bench_train.py``'s configurations (bf16 compute, dropout 0.1, SpecAugment 2 + 2 and dither on the conv
    models; wav2vec2-base with its extractor frozen); ``quartznet15x5_remat`` with ``remat`` on."""
    import torch

    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    bf16 = torch.bfloat16
    if model.startswith("quartznet15x5"):
        encoder = QuartznetEncoder(repeat_blocks=3, dropout=0.1, dtype=bf16, remat=model.endswith("remat"))
        return CTCModule.create(torch.Generator().manual_seed(0),
                                FilterbankFeatures(num_time_masks=2, num_freq_masks=2), encoder,
                                Conv1dDecoder(29, dtype=bf16), BatchTextTransformer(VOCAB), device=device)
    if model == "citrinet256":
        return citrinet_create(device, bf16, VOCAB, train_config=True, dropout=0.1)
    return w2v2_train_create({}, device, bf16, 0.1, True)


def scan_loader(rows: int, seconds: list, seed: int) -> list:
    """``(audio, lengths, texts)`` batches of ``rows`` rows of noise, one a length in ``seconds``."""
    rng = np.random.default_rng(seed)
    out = []
    for s in seconds:
        n = int(s * SAMPLE_RATE)
        out.append(((rng.standard_normal((rows, n)) * 0.1).astype(np.float32), np.full((rows,), n, np.int32),
                    [TRAIN_TEXT] * rows))
    return out


def scan_kinds(loader: list, accumulate: int) -> int:
    """The step kinds a graphed fit of one epoch over ``loader`` meets: (shape, whether the step updates)."""
    return len({(loader[i][0].shape, (i + 1) % accumulate == 0) for i in range(len(loader))})


def raw_profile(fn) -> dict:
    """Device events, busy and span ms and the idle share of one call of ``fn`` under torch.profiler, as
    :func:`device_profile` counts them, read from the profiler's raw events: parsing a conv training chunk's
    50,000-70,000 device events into the profiler's event tree takes seconds each. Also whether the trace holds
    every launch of the port's kernels that the launch counters saw (``records_complete``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = sum(launch_counts().values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launched = sum(launch_counts().values()) - before
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    own = sum(any(p in e.name() for p in OWN_KERNELS) for e in events)
    if not events:
        return {"device_events": 0, "idle_share": "not measured"}
    span_ns = max(e.end_ns() for e in events) - min(e.start_ns() for e in events)
    busy_ns = sum(e.duration_ns() for e in events)
    return {"device_events": len(events), "span_ms": span_ns / 1e6, "busy_ms": busy_ns / 1e6,
            "idle_share": max(0.0, 1.0 - busy_ns / span_ns), "own_kernel_launches": launched,
            "own_kernel_events": own, "records_complete": own == launched}


def scan_launches_per_step(name: str) -> dict:
    """The launches one train step of a :func:`scan_create` model makes: 1 log-mel and 1 + 1 CTC for the conv
    models; 12 + 24 ``mha_train``, 25 + 50 add + dropout + LayerNorm and 1 + 1 CTC for wav2vec2-base."""
    if name != "wav2vec2_base":
        return dict(fused_log_mel=1, ctc_alpha=1, ctc_beta=1)
    layers = 12
    return dict(mha_train_forward=layers, mha_train_backward=2 * layers, add_ln_train_forward=2 * layers + 1,
                add_ln_train_backward=2 * (2 * layers + 1), ctc_alpha=1, ctc_beta=1)


def scan_fit(base, loader: list, k: int, device, mesh=None, **kw) -> tuple:
    """``Trainer(steps_per_execution=k, mesh=mesh).fit`` of a copy of ``base`` over ``loader`` (one epoch, AdamW at
    SCAN_LR, generator seed 0) under ``deterministic_algorithms()``: ``(per-step losses, train state, launches,
    (eager steps, replayed steps))``."""
    import copy

    import torch

    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.training.trainer import Trainer

    trainer = Trainer(seed=0, log_every=1, device=device, steps_per_execution=k, mesh=mesh,
                      optimizer_kwargs={"learning_rate": SCAN_LR}, **kw)
    module = copy.deepcopy(base)
    with deterministic_algorithms():
        reset_launch_counts()
        trainer.fit(module, loader)
        sync(device)
        counts = launch_counts()
    losses = [e["loss/train_loss"] for e in trainer.logs if "loss/train_loss" in e]
    result = (losses, trainer.train_state(), counts, (trainer.eager_steps, trainer.replayed_steps))
    del trainer, module
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return result


def scan_chunk_timing(card: str, name: str, module, loader: list, mesh, device="cuda") -> dict:
    """One chunk of SCAN_K steps of ``module`` (a ``name`` of :func:`scan_create`) at K = 1 and K = SCAN_K, each off
    and on the one-rank ``mesh``, in turns, forward then back (meshless K = 1, mesh K = 1, mesh K = SCAN_K, meshless
    K = SCAN_K, and back), PyTorch's default algorithms; each configuration's train step (on its own copy of the
    module) is built and warmed up by one step once (at K = SCAN_K that step captures the graph:
    ``graph_pool_gb`` is what the capture reserved). Each turn: the chunk's device ms by CUDA events over SCAN_K,
    its host ms (to a synchronize) over SCAN_K and its peak allocated memory; then one more chunk of each
    configuration under the profiler (:func:`raw_profile`: its idle share). Emits ``mesh_scan_timing``."""
    import copy

    import torch

    from thunder_tpu_torch.training.trainer import Trainer, _BATCH_DTYPES, _host_batch

    configs = {"k1": (1, None), "mesh_k1": (1, mesh), f"mesh_k{SCAN_K}": (SCAN_K, mesh), f"k{SCAN_K}": (SCAN_K, None)}
    chunk = [_host_batch(module, *b) for b in loader[:SCAN_K]]
    stacked = [torch.as_tensor(np.stack([np.asarray(b[i]) for b, _ in chunk]), dtype=t, device=device)
               for i, t in enumerate(_BATCH_DTYPES)]

    def run(step, generator):
        return [step(*(a[k] for a in stacked), generator) for k in range(SCAN_K)]

    steps, out = {}, {}
    for label, (k, m) in configs.items():
        steps[label] = Trainer(device=device, seed=0, steps_per_execution=k, mesh=m, optimizer_kwargs={
            "learning_rate": SCAN_LR}).train_step_for(copy.deepcopy(module), loader, m)[:2]
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        steps[label][0](*(a[0] for a in stacked), steps[label][1])  # the warm-up; at K > 1 the chunk kind's capture
        torch.cuda.synchronize()
        out[label] = {"k": k, "mesh": m is not None, "step_ms": [], "host_ms_per_step": [], "peak_mem_gb": [],
                      "graph_pool_gb": (torch.cuda.memory_reserved() - reserved) / 1e9 if k > 1 else 0.0}
    for label in [*configs, *reversed(configs)]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        begin.record()
        run(*steps[label])
        end.record()
        torch.cuda.synchronize()
        line = out[label]
        line["step_ms"].append(begin.elapsed_time(end) / SCAN_K)
        line["host_ms_per_step"].append((time.perf_counter() - t0) * 1e3 / SCAN_K)
        line["peak_mem_gb"].append(torch.cuda.max_memory_allocated() / 1e9)  # a replay allocates nothing
    for label, (step, generator) in steps.items():
        out[label]["profile"] = raw_profile(lambda: run(step, generator))
        out[label]["replayed_steps"] = getattr(step, "replayed_steps", 0)
    emit({"phase": "mesh_scan_timing", "model": name, "k": SCAN_K, "batch": len(loader[0][1]),
          "seconds": float(loader[0][0].shape[1] / SAMPLE_RATE), **out, "card": card})
    del steps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def scan_remat_kw() -> dict:
    """The Trainer arguments of the ``quartznet15x5_remat`` runs: accumulation 2, the norm clip and ``onecycle``
    through ``total_steps_arg``."""
    from thunder_tpu_torch.training.optim import onecycle

    return dict(accumulate_grad_batches=2, gradient_clip_norm=1.0, lr_scheduler_builder=onecycle,
                lr_scheduler_kwargs={"max_lr": SCAN_LR, "total_steps_arg": "total_steps"})


def train_scan_phase(card: str, device="cuda") -> dict:
    """Phase 40 of the module docstring: ``Trainer(steps_per_execution=SCAN_K).fit`` against
    ``Trainer(steps_per_execution=1).fit`` from the same weights and generator seed, under
    ``deterministic_algorithms()``, at full width: (a) QuartzNet15x5 at TRAIN_BATCH x TRAIN_SECONDS, 4 batches
    of 15 s and one of 12 s (a full chunk, and a leftover of another kind that the epoch's end flushes); (b) the same with
    ``remat``, ``accumulate_grad_batches=2``, ``gradient_clip_norm=1.0`` and ``onecycle`` through
    ``total_steps_arg``, 4 batches (a micro step and an update step twice); (c) Citrinet-256, 4 batches; (d)
    wav2vec2-base at W2V_TRAIN_BATCH x 15 s, extractor frozen, dropout 0.1, 4 batches. Each graphed run must
    equal its K = 1 run bit for bit in the per-step losses, every parameter, the running statistics, the
    optimizer's state and the generator's state (``Trainer.train_state``); every step past its kind's first must
    come from a CUDA graph replay; each run's launches must be the fixed ones a step times its steps
    (:func:`scan_launches_per_step`), counted through capture and replay (phase 41 times the steps, beside the
    mesh's). Returns the launches of the graphed runs, by model."""
    import torch

    runs = {"quartznet15x5": (TRAIN_BATCH, [TRAIN_SECONDS] * SCAN_K + [0.8 * TRAIN_SECONDS], {}),
            "quartznet15x5_remat": (TRAIN_BATCH, [TRAIN_SECONDS] * 4, scan_remat_kw()),
            "citrinet256": (TRAIN_BATCH, [TRAIN_SECONDS] * 4, {}),
            "wav2vec2_base": (W2V_TRAIN_BATCH, [W2V_SECONDS] * 4, {})}
    launches = {}
    for name, (rows, seconds, kw) in runs.items():
        t0 = time.perf_counter()
        loader = scan_loader(rows, seconds, seed=40)
        want = expected_counts(**{w: n * len(loader) for w, n in scan_launches_per_step(name).items()})
        base = scan_create(name, device)
        (losses1, state1, counts1, _), (losses_k, state_k, counts_k, dispatch) = (
            scan_fit(base, loader, k, device, **kw) for k in (1, SCAN_K))
        kinds = scan_kinds(loader, kw.get("accumulate_grad_batches", 1))
        line = {"phase": "train_scan", "model": name, "batch": rows, "seconds": seconds, "k": SCAN_K,
                "losses_k1": losses1, f"losses_k{SCAN_K}": losses_k, "losses_bit_equal": losses_k == losses1,
                "state_bit_equal": same_tree(state_k, state1), "eager_steps": dispatch[0],
                "replayed_steps": dispatch[1], "kinds": kinds, f"launches_k{SCAN_K}": counts_k,
                "launches_k1": counts1, "seconds_taken": time.perf_counter() - t0, "card": card}
        emit(line)
        check(all(np.isfinite(losses1)) and len(losses1) == len(loader), f"{name}: K = 1 losses {losses1}")
        check(line["losses_bit_equal"], f"{name}: K = {SCAN_K} losses {losses_k} != K = 1 losses {losses1}")
        check(line["state_bit_equal"], f"{name}: the train state after K = {SCAN_K} differs from K = 1's (weights, "
                                       "running statistics, optimizer state or generator state)")
        if torch.device(device).type == "cuda":
            check(dispatch == (kinds, len(loader) - kinds),
                  f"{name}: {dispatch} (eager, replayed) steps, expected {kinds} eager and the rest replayed")
            check(counts1 == want and counts_k == want,
                  f"{name}: launches K = 1 {counts1}, K = {SCAN_K} {counts_k}, expected {want}")
        launches[name] = counts_k
        del state1, state_k
        del base
    return launches


# ---- phase 41: the mesh's train steps as CUDA graphs

#: (local weights, total weight) of the emulated rank-0 steps: the last MESH_SCAN_PADDING rows padded (weight 0),
#: or none; the global batch holds twice the rank's rows and more weight than they do, another sum each call
MESH_SCAN_PADDING = 3
MESH_SCAN_TOTALS = ((True, 29.0), (True, 31.0), (False, 32.0), (True, 30.0), (False, 24.0), (True, 27.5))


def emulated_rank0_replays(card: str, mesh, device="cuda") -> dict:
    """QuartzNet15x5's ``rows_step`` as rank 0 of a data axis larger than the one-rank mesh: TRAIN_BATCH local rows
    of TRAIN_SECONDS, the last MESH_SCAN_PADDING a padding row each (weight 0, zero audio and target length), of a
    global batch of 2 x TRAIN_BATCH rows, with the weights and total weight of each of MESH_SCAN_TOTALS in turn
    (the weighted and the unweighted kind). The graphed step (``steps_per_execution=SCAN_K``) against the eager
    one (K = 1), under deterministic algorithms: losses and train state bit-equal, each kind eager once and then
    replayed, the fixed launches a step. Returns the graphed step's launches."""
    import copy

    import torch

    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.training.checkpointing import train_state
    from thunder_tpu_torch.training.trainer import Trainer, _BATCH_DTYPES, _host_batch

    base = scan_create("quartznet15x5", device)
    (audio, lengths, texts), = scan_loader(TRAIN_BATCH, [TRAIN_SECONDS], seed=43)
    (audio, lengths, targets, target_lengths), _ = _host_batch(base, audio, lengths, texts)
    lengths, target_lengths = lengths.copy(), target_lengths.copy()
    lengths[-MESH_SCAN_PADDING:] = 0
    target_lengths[-MESH_SCAN_PADDING:] = 0
    batch = tuple(torch.as_tensor(np.asarray(a), dtype=t, device=device)
                  for a, t in zip((audio, lengths, targets, target_lengths), _BATCH_DTYPES))
    padded = np.ones(TRAIN_BATCH, np.float32)
    padded[-MESH_SCAN_PADDING:] = 0
    calls = [(padded if weighted else np.ones(TRAIN_BATCH, np.float32), total) for weighted, total in MESH_SCAN_TOTALS]
    results = {}
    for k in (1, SCAN_K):
        step, generator, _ = Trainer(device=device, seed=0, steps_per_execution=k, mesh=mesh, optimizer_kwargs={
            "learning_rate": SCAN_LR}).train_step_for(copy.deepcopy(base), [None], mesh)
        with deterministic_algorithms():
            reset_launch_counts()
            losses = [step.rows_step(batch, w, total, 2 * TRAIN_BATCH, generator) for w, total in calls]
            sync(device)
            counts = launch_counts()
        results[k] = ([loss.item() for loss in losses], train_state(step, generator), counts,
                      (step.eager_steps, getattr(step, "replayed_steps", 0)))
        del step, generator
    (losses1, state1, counts1, _), (losses_k, state_k, counts_k, dispatch) = results[1], results[SCAN_K]
    want = expected_counts(**{w: n * len(calls) for w, n in scan_launches_per_step("quartznet15x5").items()})
    line = {"phase": "mesh_scan_emulated_rank0", "model": "quartznet15x5", "local_rows": TRAIN_BATCH,
            "total_rows": 2 * TRAIN_BATCH, "padding_rows": MESH_SCAN_PADDING, "calls": MESH_SCAN_TOTALS,
            "losses_k1": losses1, f"losses_k{SCAN_K}": losses_k, "losses_bit_equal": losses_k == losses1,
            "state_bit_equal": same_tree(state_k, state1), "eager_steps": dispatch[0], "replayed_steps": dispatch[1],
            f"launches_k{SCAN_K}": {w: n for w, n in counts_k.items() if n}, "card": card}
    emit(line)
    check(all(np.isfinite(losses1)), f"emulated rank 0: K = 1 losses {losses1}")
    check(line["losses_bit_equal"] and line["state_bit_equal"],
          f"emulated rank 0: the replays with other weights differ from the eager steps ({losses_k} != {losses1})")
    if torch.device(device).type == "cuda":
        check(dispatch == (2, len(calls) - 2), f"emulated rank 0: {dispatch} (eager, replayed) steps, expected 2 eager")
        check(counts1 == want and counts_k == want, f"emulated rank 0: launches {counts1}, {counts_k}, expected {want}")
    del base, results
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return counts_k


def mesh_scan_phase(card: str, device="cuda") -> dict:
    """Phase 41 of the module docstring: ``Trainer(mesh=..., steps_per_execution=SCAN_K).fit`` on a one-rank mesh
    (:func:`one_rank_group`: NCCL on the card), its steps CUDA graph replays with the collectives captured, against
    the eager mesh fit (K = 1) and the meshless graphed fit (K = SCAN_K), from the same weights and generator seed
    under ``deterministic_algorithms()``, at full width: QuartzNet15x5 at TRAIN_BATCH x TRAIN_SECONDS, 5 batches
    (a chunk and a leftover that replays its kind), the same with ``remat``, accumulation 2, the norm clip and
    ``onecycle`` (4: a micro step and an update step twice), Citrinet-256 (4) and wav2vec2-base at W2V_TRAIN_BATCH
    x 15 s (extractor frozen, dropout 0.1; 4). The three must agree bit for bit (per-step losses, parameters,
    running statistics, optimizer and generator state); every mesh step past its kind's first must be a replay;
    each run's launches the fixed ones a step, counted through capture and replay. Then
    :func:`emulated_rank0_replays`; then, with the default algorithms, :func:`scan_chunk_timing` of QuartzNet15x5.
    Returns the launches of the graphed mesh runs, by model."""
    import torch

    runs = {"quartznet15x5": (TRAIN_BATCH, [TRAIN_SECONDS] * 5, {}),
            "quartznet15x5_remat": (TRAIN_BATCH, [TRAIN_SECONDS] * 4, scan_remat_kw()),
            "citrinet256": (TRAIN_BATCH, [TRAIN_SECONDS] * 4, {}),
            "wav2vec2_base": (W2V_TRAIN_BATCH, [W2V_SECONDS] * 4, {})}
    cuda = torch.device(device).type == "cuda"
    launches = {}
    with one_rank_group(device) as mesh:
        for name, (rows, seconds, kw) in runs.items():
            t0 = time.perf_counter()
            loader = scan_loader(rows, seconds, seed=41)
            want = expected_counts(**{w: n * len(loader) for w, n in scan_launches_per_step(name).items()})
            base = scan_create(name, device)
            fits = {label: scan_fit(base, loader, k, device, m, **kw)
                    for label, k, m in (("mesh_k4", SCAN_K, mesh), ("mesh_k1", 1, mesh), ("k4", SCAN_K, None))}
            losses = {label: fit[0] for label, fit in fits.items()}
            states = {label: fit[1] for label, fit in fits.items()}
            counts = {label: fit[2] for label, fit in fits.items()}
            dispatch = {label: fit[3] for label, fit in fits.items()}
            kinds = scan_kinds(loader, kw.get("accumulate_grad_batches", 1))
            line = {"phase": "mesh_scan", "model": name, "batch": rows, "seconds": seconds, "k": SCAN_K,
                    "mesh": mesh.shape, "losses": losses,
                    "losses_bit_equal": losses["mesh_k4"] == losses["mesh_k1"] == losses["k4"],
                    "state_bit_equal": same_tree(states["mesh_k4"], states["mesh_k1"])
                    and same_tree(states["mesh_k4"], states["k4"]),
                    "dispatch": dispatch, "kinds": kinds,
                    "launches": {label: {w: n for w, n in c.items() if n} for label, c in counts.items()},
                    "seconds_taken": time.perf_counter() - t0, "card": card}
            emit(line)
            check(all(np.isfinite(losses["mesh_k1"])) and len(losses["mesh_k1"]) == len(loader),
                  f"{name}: mesh K = 1 losses {losses['mesh_k1']}")
            check(line["losses_bit_equal"], f"{name}: the mesh K = {SCAN_K}, mesh K = 1 and meshless K = {SCAN_K} "
                                            f"losses differ: {losses}")
            check(line["state_bit_equal"], f"{name}: the train states of the mesh K = {SCAN_K}, mesh K = 1 and "
                                           f"meshless K = {SCAN_K} differ")
            if cuda:
                check(dispatch["mesh_k4"] == (kinds, len(loader) - kinds),
                      f"{name}: {dispatch['mesh_k4']} (eager, replayed) mesh steps, expected {kinds} eager")
                check(all(c == want for c in counts.values()), f"{name}: launches {counts}, expected {want}")
            launches[name] = counts["mesh_k4"]
            del fits, states
            if cuda and name == "quartznet15x5":
                scan_chunk_timing(card, name, base, scan_loader(rows, seconds[:SCAN_K], seed=42), mesh, device)
            del base
        launches["emulated_rank0"] = emulated_rank0_replays(card, mesh, device)
    return launches


def aot_export_phase(card: str, device="cuda") -> dict:
    """Phase 39 of the module docstring: ``aot_export`` on the card of phase 4's QuartzNet module cut to
    QuartzNet5x5 (``AOT_QN``, float32) and of a wav2vec2-base module with a bf16 encoder, each at ``AOT_BATCH`` x ``AOT_SECONDS``, written to a
    temporary folder; both artifacts are loaded in one fresh ``python3`` by ``aot_load`` alone (``AOT_RUNNER``) and
    serve the phase's audio there: its ``preds`` and lengths must be bit-equal (SHA-256) to the live module's
    ``infer``, with the live forward's launches per call (1 log-mel; 12 + 25). Export seconds, artifact bytes, load
    seconds and a call's ms beside the live module's (synchronized calls, host clock). Returns the launches of each
    loaded call by model."""
    import hashlib
    import os
    import tempfile
    from pathlib import Path

    import torch

    from thunder_tpu_torch.export import aot_export
    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.models import Wav2Vec2Config

    sha = lambda t: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()  # noqa: E731
    quartznet, _, _ = served_quartznet(device, encoder=AOT_QN)
    w2v = w2v2_create(Wav2Vec2Config(), device, dtype=torch.bfloat16)
    models = {"quartznet5x5": (quartznet, expected_counts(fused_log_mel=1)),
              "wav2vec2_base_bf16": (w2v, expected_counts(mha_from_qkv=12, add_layer_norm=25))}
    audio, lengths = speech_batch(AOT_BATCH, AOT_SECONDS, seed=39)
    audio_d, lengths_d = torch.as_tensor(audio, device=device), torch.as_tensor(lengths, device=device)
    runs, lines = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        np.save(Path(tmp) / "audio.npy", audio)
        np.save(Path(tmp) / "lengths.npy", lengths)
        for name, (module, want) in models.items():
            module.infer(audio_d, lengths_d)
            sync(device)
            reset_launch_counts()
            _, preds, out_lengths = module.infer(audio_d, lengths_d)
            sync(device)
            live = launch_counts()
            check(live == want, f"aot_export {name}: the live forward launched {live}, expected {want}")

            def live_call():
                module.infer(audio_d, lengths_d)
                sync(device)

            path = Path(tmp) / f"{name}.pt2"
            t0 = time.perf_counter()
            aot_export(module, AOT_BATCH, audio.shape[1], path=str(path))
            lines[str(path)] = {"phase": "aot_export", "model": name, "batch": AOT_BATCH, "seconds": AOT_SECONDS,
                                "export_s": time.perf_counter() - t0, "artifact_bytes": path.stat().st_size,
                                "live_infer_ms": host_ms(live_call, W2V_CELL_TIMED),
                                "live_launches": {k: v for k, v in live.items() if v},
                                "live": (live, sha(preds), sha(out_lengths))}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", AOT_RUNNER, str(Path(tmp) / "audio.npy"),
                               str(Path(tmp) / "lengths.npy"), str(W2V_CELL_TIMED), *lines],
                              capture_output=True, text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)})
        process_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"aot_export: the loading process exited {proc.returncode}: {proc.stderr[-2000:]}")
        loaded = [json.loads(ln.removeprefix("aot_result ")) for ln in proc.stdout.splitlines()
                  if ln.startswith("aot_result ")]
    check(len(loaded) == len(lines), f"aot_export: the loading process served {len(loaded)} of {len(lines)} graphs")
    for got in loaded:
        line = lines[got["path"]]
        live, preds_sha, lengths_sha = line.pop("live")
        name = line["model"]
        runs[name] = got["launches"]
        line.update({"load_s": got["load_s"], "loading_process_s": process_s, "call_ms": got["call_ms"],
                     "ms_is": f"median of {W2V_CELL_TIMED} synchronized calls on the host clock",
                     "launches": {k: v for k, v in runs[name].items() if v},
                     "preds_equal": got["preds_sha256"] == preds_sha, "lengths_equal": got["lengths_sha256"] == lengths_sha,
                     "preds_sha256": got["preds_sha256"], "card": card})
        emit(line)
        check(runs[name] == live, f"aot_export {name}: the loaded call launched {runs[name]}, the live one {live}")
        check(line["preds_equal"] and line["lengths_equal"] and got["preds_dtype"] == "torch.int32",
              f"aot_export {name}: the loaded graph's preds or lengths differ from the live module's")
    del quartznet, w2v, models
    gc.collect()
    torch.cuda.empty_cache()
    return runs


if __name__ == "__main__":
    sys.exit(main())
