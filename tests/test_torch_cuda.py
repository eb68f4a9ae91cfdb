"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a CUDA device).

Each kernel is held against its plain PyTorch version on the same device, with
the check names and tolerances of ``thunder_tpu_torch.kernels.selftest``; a
small QuartzNet, a small Citrinet and a small wav2vec2 run through the
engine on the card and on the CPU, with the launch counts of one forward (and
one Citrinet train step); the attention and add +
LayerNorm kernels are held to their plain versions at the wav2vec2-base
serving shape (16 x 15 s: T = 749, 12 heads), with ragged rows and a row of
length 0; the CTC kernel pair is held to its plain loops on the edge case, at
both training shapes and at the edges of its plans (one warp of 3 and 8
states a lane, two warps, up to 17 warps of 32), with the Python mirror of
its plan held to the kernel's; and one ``Trainer.fit`` step on the card
launches each kernel of the training path once. The beam scan and backtrace kernels are
held to their plain versions at small shapes (besides their checks at the
serving shapes), past one block of shared memory too (the chunked scan) and
past the state that fits in it (the workspace plan), with the Python mirror of
the scan's plan held to the kernel's, and a beam
``predict`` on the card makes one launch of each; the backtrace is held to the
plain walk at its edges (slots outside [0, W), T = 0, 200 rows, spans off 16
bytes, rows past one span) with the mirror of its plan held to the kernel's;
the keep mask to its plain version at d = 1, 36, 768, 2056. The conv engine's
CUDA graphs of its frontend after the log-mel give the eager frontend's
features bit for bit. The engine's
serving modes run on a small wav2vec2 (each mode) and QuartzNet
(``int8_weights``) against the same mode on the CPU; ``int8_mm`` and the
dynamic int8 products equal their plain versions and the CPU's bit for bit;
the separable repeat's tap slices and the log-mel's wide path (C16) are held
to their plain versions. The repo's ``.nemo`` fixtures load on the card
through ``load_pretrained`` (within 0.1 of float32 on the CPU, one launch of
each kernel of the plan), the inference bundle round trip gives the same
logits bit for bit on the card, a ``frozen_paths`` step on the card leaves
the frozen extractor bit-equal, and a tiny HF wav2vec2 loads and serves on the
card where ``transformers`` is installed. ``remat`` on a small wav2vec2 (bf16, dropout 0.1) and a
small Citrinet gives the loss, the running statistics and the generator's state of the step without it,
bit for bit, with the recompute's launches (each layer's attention and two add + dropout + LayerNorm
forwards once more); a checkpoint saved on the card restores into a fresh train step bit for bit and a
run resumed from it carries on.
The training attention and add + dropout + LayerNorm kernels are held to
their plain versions, forward and backward, at odd sizes (T = 1, 31, 749,
1536, a row of length 0; row counts that are no multiple of a block, D = 128
to 2048), with the packed ``dqkv`` and ``dscale``/``dbias`` equal bit for bit
from run to run; the Python mirror of the add + LayerNorm backward's plan is
held to the kernel's on this card; their ``autograd.Function``s give the plain
backward's gradients; and one small wav2vec2 train step launches them as
counted. On slices of a batch, each with its rows' offset (a data-parallel
rank's rows), they give the whole batch's masks, outputs and gradients bit for
bit. The three custom ops of an exported predict graph equal their wrappers and pass ``torch.library.opcheck``
on the card, and a tiny bf16 wav2vec2 exported by ``aot_export`` serves through ``aot_load`` on the card with the
live module's predictions and launches. ``Trainer(steps_per_execution=4)`` (the graphed train step) equals
``steps_per_execution=1`` bit for bit under deterministic algorithms on a small QuartzNet (with remat,
accumulation, the clip and a schedule) and a small wav2vec2 (with remat and the fine-tuning freeze), with their
launches and every step past a kind's first replayed; past the graph bound, on another stream, with cleared
gradients and a reloaded optimizer state too. On a one-rank NCCL mesh (a ``FileStore`` group) the graphed mesh
fit, its collectives captured, equals the eager mesh fit and the meshless graphed fit bit for bit in the same
cases (remat, accumulation, the clip, the schedule and the freeze included); a replay as rank
0 of a larger data axis, with another total weight each time, equals the eager ``rows_step``; and a mesh step whose
capture fails raises.

On a machine with an NVIDIA Hopper card and nvcc, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which the port does not need.)
This file imports no JAX.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from thunder_tpu_torch.kernels.selftest import KERNEL_CHECKS, pointer_field, run_selftests

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NVIDIA Hopper, sm_90a) and nvcc")


@pytest.mark.parametrize("name", sorted(KERNEL_CHECKS))
def test_kernel_matches_plain_version_on_card(cuda, name):
    (result,) = run_selftests([name])
    assert result["ok"], result


def test_small_quartznet_on_card_matches_cpu(cuda):
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import fused_log_mel, fused_separable_repeat, reset_launch_counts
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule

    module = CTCModule.create(
        torch.Generator().manual_seed(0),
        FilterbankFeatures(),
        QuartznetEncoder(repeat=2, filters=(256,), kernel_sizes=(33,)),
        Conv1dDecoder(29),
        device="cuda",
    )
    audio = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    lengths = np.array([16000, 9000], np.int32)
    reset_launch_counts()
    got, got_lens = InferenceEngine(module)(audio, lengths)
    assert (fused_log_mel.launches, fused_separable_repeat.launches) == (1, 4)  # stem, 2 body repeats, tail
    want, want_lens = InferenceEngine(module.to("cpu"))(audio, lengths)
    assert torch.equal(got_lens.cpu(), want_lens)
    valid = torch.arange(want.shape[1])[None, :] < want_lens[:, None]
    dev = (got.float().cpu() - want).abs()[valid].max() / want.abs()[valid].max()
    assert dev < 0.1  # bf16 on the card against float32 on the CPU


@pytest.mark.parametrize("batch_invariant", [False, True])
def test_conv_engine_frontend_graph_is_bit_equal_to_the_eager_frontend_on_card(cuda, batch_invariant):
    """The conv engine's CUDA graphs of its frontend after the log-mel: at every shape, on a second call, on
    another stream and past ``FRONTEND_GRAPHS`` shapes (eager there), the features and lengths of the eager
    frontend bit for bit; an earlier call's result outlives a later call; the engine's logits equal those of the
    same engine with the eager frontend."""
    from thunder_tpu_torch import engine as engine_module
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule

    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(),
                              QuartznetEncoder(repeat=2, filters=(256,), kernel_sizes=(33,)), Conv1dDecoder(29),
                              device="cuda")
    engine = InferenceEngine(module, batch_invariant=batch_invariant)
    rng = np.random.default_rng(1)

    def inputs(batch, samples):
        audio = torch.as_tensor(rng.standard_normal((batch, samples)).astype(np.float32) * 0.2, device="cuda")
        lengths = torch.as_tensor(rng.integers(samples // 3, samples + 1, batch).astype(np.int32), device="cuda")
        return audio, lengths

    @torch.inference_mode()
    def both(audio, lengths):
        got = engine._frontend_tail(engine.frontend.log_mel(audio), lengths)
        feats, out_lengths = engine.frontend(audio, lengths, sum_dtype=engine._sum_dtype)
        return got, (feats.to(engine.dtype), out_lengths)

    shapes = [(b, s) for b in (1, 2, 3) for s in (8000, 16000, 24000)]
    assert len(shapes) > engine_module.FRONTEND_GRAPHS
    first = None
    for batch, samples in shapes + shapes[:2]:
        got, want = both(*inputs(batch, samples))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (batch, samples)
        if first is None:
            first, first_want = got, [t.clone() for t in want]
    assert all(torch.equal(g, w) for g, w in zip(first, first_want))  # after later replays of its graph
    assert len(engine._frontend_tail._graphs) == engine_module.FRONTEND_GRAPHS
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        got, want = both(*inputs(*shapes[0]))
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    audio, lengths = inputs(2, 16000)
    graphed = engine.infer(audio, lengths)
    engine._frontend_tail = None
    eager = engine.infer(audio, lengths)
    assert all(torch.equal(g, e) for g, e in zip(graphed, eager))


def test_small_citrinet_on_card_matches_cpu_and_trains(cuda):
    """A small Citrinet (80 mels; three blocks of 2 repeats, the last two strided) through the engine: one launch
    of each separable repeat (the stem, 3 x 2, the tail), within 0.1 of float32 on the CPU; one ``Trainer.fit``
    step launches the log-mel and each CTC kernel once."""
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.models import CitrinetEncoder, Conv1dDecoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.trainer import Trainer

    small = dict(filters=(64, 64, 64), kernel_sizes=(11, 13, 15), strides=(1, 2, 2), repeat=2)
    tt = BatchTextTransformer(list("abcdefghijklmnopqrstuvwxyz '"))
    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(nfilt=80), CitrinetEncoder(**small),
                              Conv1dDecoder(29), tt, device="cuda")
    audio = (np.random.default_rng(0).standard_normal((2, 32000)) * 0.2).astype(np.float32)
    lengths = np.array([32000, 18000], np.int32)
    reset_launch_counts()
    got, got_lens = InferenceEngine(module)(audio, lengths)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    assert {k: v for k, v in counts.items() if v} == {"fused_log_mel": 1, "fused_separable_repeat": 8}
    want, want_lens = InferenceEngine(module.to("cpu"))(audio, lengths)
    assert torch.equal(got_lens.cpu(), want_lens)
    valid = torch.arange(want.shape[1])[None, :] < want_lens[:, None]
    dev = (got.float().cpu() - want).abs()[valid].max() / want.abs()[valid].max()
    assert dev < 0.1  # bf16 on the card against float32 on the CPU

    train = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(nfilt=80, num_time_masks=2),
                             CitrinetEncoder(**small, dropout=0.1, dtype=torch.bfloat16),
                             Conv1dDecoder(29, dtype=torch.bfloat16), tt, device="cuda")
    reset_launch_counts()
    trainer = Trainer(device="cuda", fast_dev_run=True)
    trainer.fit(train, [(audio, lengths, ["hello world", "the cat"])])
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    assert {k: v for k, v in counts.items() if v} == {"fused_log_mel": 1, "ctc_alpha": 1, "ctc_beta": 1}
    assert np.isfinite(trainer.logs[0]["loss/train_loss"])


def test_small_wav2vec2_on_card_matches_cpu(cuda):
    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule

    config = Wav2Vec2Config(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                            conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                              Wav2Vec2Encoder(config), LinearDecoder(32), device="cuda")
    audio = (np.random.default_rng(0).standard_normal((3, 16000)) * 0.2).astype(np.float32)
    lengths = np.array([16000, 9000, 400], np.int32)
    reset_launch_counts()
    got, got_lens = InferenceEngine(module)(audio, lengths)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    assert {k: v for k, v in counts.items() if v} == {"mha_from_qkv": 2, "add_layer_norm": 5}
    want, want_lens = InferenceEngine(module.to("cpu"))(audio, lengths)
    assert torch.equal(got_lens.cpu(), want_lens)
    valid = torch.arange(want.shape[1])[None, :] < want_lens[:, None]
    dev = (got.float().cpu() - want).abs()[valid].max() / want.abs()[valid].max()
    assert dev < 0.1  # bf16 on the card against float32 on the CPU


def test_attention_kernel_at_wav2vec2_serving_shape(cuda):
    from thunder_tpu_torch.kernels.attention import mha_from_qkv, mha_from_qkv_reference
    from thunder_tpu_torch.kernels.selftest import attention_case, ulp_bf16_error

    lengths = [749] * 12 + [700, 333, 1, 0]  # full rows, ragged rows and a row of length 0
    qkv, lens = attention_case(21, 16, 749, 12, lengths, "cuda")
    got, want = mha_from_qkv(qkv, lens, 12), mha_from_qkv_reference(qkv, lens, 12)
    torch.cuda.synchronize()
    assert got.shape == (16, 749, 768) and bool(torch.isfinite(got).all())
    for row in range(16):
        assert ulp_bf16_error(got[row], want[row]) <= 4.0, (row, lengths[row])


@pytest.mark.parametrize("b,t,heads", [(1, 1, 1), (3, 33, 3), (2, 65, 5), (2, 200, 12), (1, 1664, 2)])
def test_attention_kernel_edge_shapes(cuda, b, t, heads):
    """T of 1, T off the 32-row tile and the 64-key chunk, odd head counts, and the longest T the panel fits."""
    from thunder_tpu_torch.kernels.attention import mha_from_qkv, mha_from_qkv_reference
    from thunder_tpu_torch.kernels.selftest import attention_case, ulp_bf16_error

    lengths = [t] + [max(t - 7 * i, 0) for i in range(1, b)]
    qkv, lens = attention_case(24, b, t, heads, lengths, "cuda")
    got, want = mha_from_qkv(qkv, lens, heads), mha_from_qkv_reference(qkv, lens, heads)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert ulp_bf16_error(got, want) <= 4.0


@pytest.mark.parametrize("b,t,heads,lengths", [(1, 1665, 2, [1665]), (2, 1665, 12, [1665, 901]), (1, 3001, 12, [3001])])
def test_attention_kernel_past_the_old_panel_cap(cuda, b, t, heads, lengths):
    """Lengths past the 1664 frames that the first kernel's score panel held: 1665, and a 60 s chunk."""
    from thunder_tpu_torch.kernels.attention import mha_from_qkv, mha_from_qkv_reference
    from thunder_tpu_torch.kernels.selftest import attention_case, ulp_bf16_error

    qkv, lens = attention_case(25, b, t, heads, lengths, "cuda")
    got, want = mha_from_qkv(qkv, lens, heads), mha_from_qkv_reference(qkv, lens, heads)
    torch.cuda.synchronize()
    assert got.shape == (b, t, heads * 64) and bool(torch.isfinite(got).all())
    assert ulp_bf16_error(got, want) <= 4.0


def test_attention_kernel_rejects_what_the_launch_does_not_take(cuda):
    from thunder_tpu_torch.kernels.attention import mha_from_qkv

    qkv = torch.zeros(65536, 1, 192, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="65535"):
        mha_from_qkv(qkv, torch.ones(65536, dtype=torch.int32, device="cuda"), 1)


@pytest.mark.parametrize("rows,d", [(1, 8), (33, 2048), (5, 1024), (9, 36), (4, 2056), (3, 1), (2, 4100)])
def test_add_ln_kernel_edge_widths(cuda, rows, d):
    from thunder_tpu_torch.kernels.add_ln import add_layer_norm, add_layer_norm_reference
    from thunder_tpu_torch.kernels.selftest import add_ln_case, ulp_bf16_error

    x, y, scale, bias = add_ln_case(26, (rows,), d, "cuda")
    got, want = add_layer_norm(x, y, scale, bias), add_layer_norm_reference(x, y, scale, bias)
    torch.cuda.synchronize()
    assert ulp_bf16_error(got, want) <= 2.0


def test_add_ln_kernel_at_wav2vec2_serving_shape(cuda):
    from thunder_tpu_torch.kernels.add_ln import add_layer_norm, add_layer_norm_reference
    from thunder_tpu_torch.kernels.selftest import add_ln_case, ulp_bf16_error

    x, y, scale, bias = add_ln_case(22, (16, 749), 768, "cuda")
    got, want = add_layer_norm(x, y, scale, bias), add_layer_norm_reference(x, y, scale, bias)
    torch.cuda.synchronize()
    assert ulp_bf16_error(got, want) <= 2.0
    # any multiple of 8 features, and an odd number of rows
    x, y, scale, bias = add_ln_case(23, (7,), 1032, "cuda")
    assert ulp_bf16_error(add_layer_norm(x, y, scale, bias), add_layer_norm_reference(x, y, scale, bias)) <= 2.0


@pytest.mark.parametrize(
    "b,t,c,co,k,stride,dilation",
    [(3, 100, 24, 40, 4, 1, 1), (2, 77, 8, 8, 87, 1, 2), (5, 129, 520, 136, 7, 2, 1), (1, 1, 64, 256, 33, 2, 1),
     (3, 65, 200, 264, 1, 1, 1), (2, 300, 1024, 520, 33, 1, 1), (4, 129, 72, 8, 9, 3, 1), (2, 140, 96, 64, 5, 1, 3)],
)
def test_separable_repeat_ragged_shapes_on_card(cuda, b, t, c, co, k, stride, dilation):
    from thunder_tpu_torch.kernels.selftest import exact_float32, _separable_check

    exact_float32()
    result = _separable_check(5, b, t, c, co, k, stride, dilation, ragged=True)("cuda")
    assert result["max_err"] <= 8.0, result


def test_separable_repeat_plan_and_refusal_on_card(cuda):
    from thunder_tpu_torch.kernels.selftest import _separable_case, ulp_bf16_error
    from thunder_tpu_torch.kernels.separable_conv import (
        fused_separable_repeat,
        separable_plan,
        separable_repeat_reference,
    )

    # QuartzNet's widths keep two blocks on an SM (one's depthwise beside the other's products)
    for c_in, k, dilation in ((256, 39, 1), (512, 87, 1), (512, 87, 2)):
        plan = separable_plan(c_in, k, 1, dilation)
        assert plan["blocks_per_sm"] == 2 and plan["smem_bytes"] <= 115712, (c_in, k, plan)
        assert plan["tap_slices"] == 1 and plan["taps"] == k and plan["launches"] == 1
    assert separable_plan(1024, 33)["blocks_per_sm"] == 1 and separable_plan(1024, 33)["parts"] == 1
    # an A tile past one block: launches over even slices of C_in, multiples of 64 channels
    assert {k: separable_plan(2048, 33)[k] for k in ("parts", "part")} == {"parts": 2, "part": 1024}
    assert {k: separable_plan(1544, 33)[k] for k in ("parts", "part")} == {"parts": 2, "part": 832}
    # C16: the smallest k whose span does not fit beside 64 channels at dilation 2 is 561 (k rounds up to 568
    # taps in the span); from there the taps go in slices of 560, and the launch gives the plain version's result
    assert separable_plan(256, 560, 1, 2)["tap_slices"] == 1
    assert {k: separable_plan(256, 561, 1, 2)[k] for k in ("taps", "tap_slices", "launches")} == {
        "taps": 560, "tap_slices": 2, "launches": 2 * separable_plan(256, 561, 1, 2)["parts"]}
    k = 1501
    plan = separable_plan(64, k, 1, 2)
    assert plan["smem_bytes"] > 0 and plan["tap_slices"] == 3, plan
    case = _separable_case(57, 2, 300, 64, 64, k, dilation=2, device="cuda", lengths=[300, 120])
    before = fused_separable_repeat.launches
    got = fused_separable_repeat(**case)
    assert fused_separable_repeat.launches == before + plan["launches"]
    assert ulp_bf16_error(got, separable_repeat_reference(**case)) <= 8.0
    # a span too long for even 8 taps beside 64 channels (dilation 300) raises, and launches nothing
    assert separable_plan(64, 9, 1, 300)["smem_bytes"] == 0
    x = torch.zeros((1, 64, 64), dtype=torch.bfloat16, device="cuda")
    dw = torch.zeros((9, 64), dtype=torch.bfloat16, device="cuda")
    pw = torch.zeros((64, 64), dtype=torch.bfloat16, device="cuda")
    before = fused_separable_repeat.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_separable_repeat(x, torch.full((1,), 64, dtype=torch.int32, device="cuda"), dw, pw,
                               torch.zeros(64, device="cuda"), 9, dilation=300)
    assert fused_separable_repeat.launches == before


@pytest.mark.parametrize(
    "time,win,n_mels,sr,hop,n_fft",
    [(12345, 320, 64, 16000, 160, 512), (8000, 400, 80, 16000, 160, 512),
     # the other configurations of the frontend checks: 44.1 and 48 kHz with n_fft 2048, hop 161, n_fft 4096,
     # the dense path's n_fft 400, a clip of one frame, and a long hop past the frames' overlap
     (44100, 1103, 64, 44100, 441, 2048), (48000, 1200, 64, 48000, 480, 2048), (16000, 320, 64, 16000, 161, 512),
     (48000, 2400, 128, 48000, 480, 4096), (16000, 400, 80, 16000, 160, 400), (100, 32, 16, 16000, 160, 32),
     (16000, 100, 40, 16000, 1000, 128)],
)
def test_log_mel_other_configs_on_card(cuda, time, win, n_mels, sr, hop, n_fft):
    from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_reference
    from thunder_tpu_torch.kernels.selftest import exact_float32

    exact_float32()
    audio = torch.as_tensor(np.random.default_rng(3).standard_normal((3, time)).astype(np.float32) * 0.3, device="cuda")
    kw = dict(sample_rate=sr, n_fft=n_fft, hop_length=hop, win_length=win, n_mels=n_mels)
    got = fused_log_mel(audio, **kw)
    want = log_mel_reference(audio, **kw)
    assert got.shape == want.shape == (3, time // hop + 1, n_mels)
    assert (got - want).abs().max().item() <= 2e-3


def test_log_mel_plan_paths_and_refusals_launch_nothing(cuda):
    from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_plan

    for n_fft in (32, 64, 512, 2048, 4096):
        assert log_mel_plan(n_fft, 160, n_fft // 2, 64)["path"] == "fft"
    for n_fft in (16, 400, 1000, 8192):
        assert log_mel_plan(n_fft, 160, n_fft // 2, 64)["path"] == "dense"
    # the main path: 16 frames of 256 complex points in two 32 KB buffers (the raw audio and the span, 15 hops +
    # the window, fit in one), the twiddles and the window, and the mel tables (64 filters, 2 x 257 weights at
    # most, each padded to 16 bytes): three blocks an SM
    main = log_mel_plan(512, 160, 320, 64)
    mel_tables = 4 * (3 * 64 + 516)
    assert main == {"path": "fft", "smem_bytes": 2 * 8 * 16 * 256 + 4 * (1024 + 320) + mel_tables, "frames": 16,
                    "threads": 256}
    assert 3 * (main["smem_bytes"] + 1024) <= 228 * 1024
    assert log_mel_plan(4096, 480, 2400, 128)["frames"] == 2
    dense = log_mel_plan(400, 160, 400, 80)
    span, tile = 15 * 160 + 400, 16 * 81
    assert dense == {"path": "dense", "smem_bytes": 4 * (span + 16 * 201 + tile) + 4 * (3 * 80 + 404), "frames": 16,
                     "threads": 224}
    # a long hop takes fewer frames a block, never a refusal: one frame's span is the window alone
    assert log_mel_plan(512, 100000, 320, 64)["frames"] == 1
    for args in ((512, 160, 600, 64), (512, 0, 320, 64), (512, 160, 0, 64), (512, 160, 320, 0), (1, 1, 1, 1)):
        assert log_mel_plan(*args)["smem_bytes"] == 0, args
    # C16: one frame's power row alone is over 227 KB: the wide path, whose power launch holds the span only
    assert log_mel_plan(120000, 160, 400, 64) == {"path": "wide", "smem_bytes": 4 * (15 * 160 + 400), "frames": 16,
                                                 "threads": 256}
    assert log_mel_plan(32768, 4096, 16384, 128)["path"] == "wide"
    big = log_mel_plan(120000, 160, 60000, 64)  # one frame's span is over 227 KB
    assert big["path"] == "wide" and big["smem_bytes"] == 0
    before = fused_log_mel.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_log_mel(torch.zeros((1, 200000), device="cuda"), n_fft=120000, win_length=60000)
    with pytest.raises(RuntimeError, match="reflect pad"):
        fused_log_mel(torch.zeros((1, 256), device="cuda"))
    assert fused_log_mel.launches == before


def test_filterbank_at_44k1_runs_the_kernel_on_card(cuda):
    """C11: n_fft 2048, hop 441 go through the kernel (one launch) and match the module on the CPU."""
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.kernels.frontend import fused_log_mel
    from thunder_tpu_torch.kernels.selftest import exact_float32

    exact_float32()
    module = FilterbankFeatures(sample_rate=44100, n_window_size=1103, n_window_stride=441, n_fft=2048)
    audio = (np.random.default_rng(8).standard_normal((2, 88200)) * 0.2).astype(np.float32)
    lengths = np.array([88200, 50000], np.int32)
    before = fused_log_mel.launches
    got, got_len = module(torch.as_tensor(audio, device="cuda"), torch.as_tensor(lengths, device="cuda"))
    torch.cuda.synchronize()
    assert fused_log_mel.launches == before + 1
    want, want_len = module(torch.as_tensor(audio), torch.as_tensor(lengths))
    assert torch.equal(got_len.cpu(), want_len)
    assert (got.cpu() - want).abs().max().item() <= 1e-2  # the kernel's 2e-3 over each feature's spread


def test_engine_runs_widths_of_100_and_2048_through_the_separable_kernel_on_card(cuda):
    """C10: 100 channels (padded to 104) and a 2048-wide block (two launches over slices of C_in) run the
    kernel in every repeat, and match the engine on the CPU."""
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import fused_separable_repeat, reset_launch_counts
    from thunder_tpu_torch.kernels.separable_conv import separable_plan
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule

    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(),
                              QuartznetEncoder(repeat=2, filters=(100, 2048), kernel_sizes=(33, 33)), Conv1dDecoder(29),
                              device="cuda")
    engine = InferenceEngine(module)
    repeats = [rp for block in engine._plan for rp in block.repeats if rp.kind == "separable"]
    widths = [(rp.pw.shape[0], rp.pw.shape[1]) for rp in repeats]
    assert (256, 100) in widths and (100, 100) in widths and (2048, 2048) in widths
    launches = sum(separable_plan(-(-c_in // 8) * 8, rp.kernel_size, rp.stride, rp.dilation)["parts"]
                   for (c_in, _), rp in zip(widths, repeats))
    assert launches > len(repeats)  # the 2048-wide repeats take two
    audio = (np.random.default_rng(9).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    lengths = np.array([16000, 9000], np.int32)
    reset_launch_counts()
    got, got_lens = engine(audio, lengths)
    torch.cuda.synchronize()
    assert fused_separable_repeat.launches == launches
    want, want_lens = InferenceEngine(module.to("cpu"))(audio, lengths)
    assert torch.equal(got_lens.cpu(), want_lens)
    valid = torch.arange(want.shape[1])[None, :] < want_lens[:, None]
    assert (got.float().cpu() - want).abs()[valid].max() / want.abs()[valid].max() < 0.1  # bf16 against float32


def test_wav2vec2_of_width_36_serves_and_trains_on_card(cuda):
    """C12: a hidden size that is not a multiple of 8 runs the add + LayerNorm kernels in bf16 on the card,
    serving and training, and matches the CPU path."""
    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import add_layer_norm, add_ln_train_backward, add_ln_train_forward
    from thunder_tpu_torch.kernels import reset_launch_counts
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule

    config = Wav2Vec2Config(hidden_size=36, num_hidden_layers=2, num_attention_heads=2, intermediate_size=72,
                            conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, hidden_dropout=0.1)
    audio = (np.random.default_rng(10).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    lengths = np.array([16000, 9000], np.int32)
    module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                              Wav2Vec2Encoder(config), LinearDecoder(32), device="cuda")
    reset_launch_counts()
    got, got_lens = InferenceEngine(module)(audio, lengths)
    torch.cuda.synchronize()
    sites = 2 * config.num_hidden_layers + 1  # two a layer and the encoder's, as 25 in wav2vec2-base
    assert add_layer_norm.launches == sites
    want, want_lens = InferenceEngine(module.to("cpu"))(audio, lengths)
    assert torch.equal(got_lens.cpu(), want_lens)
    valid = torch.arange(want.shape[1])[None, :] < want_lens[:, None]
    assert (got.float().cpu() - want).abs()[valid].max() / want.abs()[valid].max() < 0.1  # bf16 against float32
    train = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=False),
                             Wav2Vec2Encoder(config, dtype=torch.bfloat16), LinearDecoder(32, dtype=torch.bfloat16),
                             device="cuda")
    x, lens = torch.as_tensor(audio, device="cuda"), torch.as_tensor(lengths, device="cuda")
    reset_launch_counts()
    logits, _ = train.model(x, lens, train=True, generator=torch.Generator(device="cuda").manual_seed(0))
    logits.float().square().mean().backward()
    torch.cuda.synchronize()
    assert add_ln_train_forward.launches == sites
    assert add_ln_train_backward.launches == 2 * sites  # the backward and the sum of partials
    grad = train.model.encoder.layer0.layer_norm.scale.grad
    assert grad is not None and bool(torch.isfinite(grad).all()) and bool(grad.abs().sum() > 0)


@pytest.mark.parametrize("v,width", [(1025, 16), (29, 300), (1606, 16), (3000, 16), (1000, 64)])
def test_device_beam_past_8192_candidates_on_card(cuda, v, width):
    """C13: W*K above the JAX package's 8192 runs the scan kernel (one launch) and gives the CPU's hypotheses;
    and past one block of shared memory (V = 1606 and 3000 at W = 16, 1000 at W = 64: the chunked scan)."""
    from thunder_tpu_torch.kernels.beam import beam_scan
    from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device

    logits = np.random.default_rng(11).normal(0.0, 2.0, (2, 24, v)).astype(np.float32)
    kw = dict(lengths=[24, 17], blank=0, beam_width=width, max_tokens_per_step=None, nbest=2)
    before = beam_scan.launches
    got = beam_search_device(logits, device="cuda", **kw)
    assert beam_scan.launches == before + 1
    want = beam_search_device(logits, device="cpu", **kw)
    for g_row, w_row in zip(got, want):
        assert [ids.tolist() for ids, _ in g_row] == [ids.tolist() for ids, _ in w_row]
        np.testing.assert_allclose([s for _, s in g_row], [s for _, s in w_row], rtol=0, atol=2e-3)


#: ``ctc_training_case`` arguments (seed, B, T, V, labels) -> the kernels' plan (warps, states a lane); every row's
#: length is drawn from [T / 2, T]
CTC_SHAPES = {
    "training_shape": ((12, 16, 751, 29, 64), (3, 2)),  # QuartzNet15x5 training: S = 129
    "wav2vec2_shape": ((13, 8, 749, 32, 64), (3, 2)),  # wav2vec2-base training: S = 129
    "two_warps": ((14, 4, 300, 29, 32), (2, 2)),  # S = 65: a warp of one state
    "four_warps": ((15, 4, 400, 29, 127), (4, 2)),  # S = 255, the widest row of two states a lane
    "two_warps_of_8": ((16, 4, 400, 29, 128), (2, 8)),  # S = 257: two warps of eight states a lane
}


@pytest.mark.parametrize("case", ["edge", *CTC_SHAPES])
def test_ctc_kernels_match_plain_versions_on_card(cuda, case):
    """Forward (alpha, ll) and gradient of the kernel pair against the plain loops on the card: the edge case (one
    warp of one state a lane) and the plans of ``CTC_SHAPES``, rows shorter than T in each; the warps hand their
    edge states to each other through a ring in shared memory."""
    from thunder_tpu_torch.kernels.ctc import (
        alpha_reference,
        beta_reference,
        ctc_alpha,
        ctc_beta,
        ctc_plan,
        ll_from_alpha,
    )
    from thunder_tpu_torch.kernels.selftest import ctc_edge_case, ctc_training_case
    from thunder_tpu_torch.ops.ctc import extended_emissions

    if case == "edge":
        logits, targets, lens, tl = ctc_edge_case("cuda")
        plan = (1, 2)
    else:
        args, plan = CTC_SHAPES[case]
        logits, targets, lens, tl = ctc_training_case(*args, "cuda")
    lp_z, skip_ok = extended_emissions(torch.log_softmax(logits, dim=-1), targets, blank=0)
    assert tuple(ctc_plan(lp_z.shape[2]).values()) == plan
    assert bool((lens < lp_z.shape[0]).any())
    alpha = ctc_alpha(lp_z, skip_ok, lens, tl)
    want_alpha = alpha_reference(lp_z, skip_ok, lens, tl)
    ll, want_ll = ll_from_alpha(alpha, lens, tl), ll_from_alpha(want_alpha, lens, tl)
    torch.testing.assert_close(ll, want_ll, rtol=1e-6, atol=0)
    ghat = torch.where(ll < -1e29, 0.0, 1.0 / tl.clamp_min(1).float())  # zero_infinity
    dlp = ctc_beta(lp_z, alpha, skip_ok, lens, tl, ll, ghat)
    want = beta_reference(lp_z, want_alpha, skip_ok, lens, tl, want_ll, ghat)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dlp).all())
    torch.testing.assert_close(dlp, want, rtol=0, atol=1e-5 * want.abs().max().item())
    if case == "edge":
        assert (ll < -1e29).tolist() == [False] * 5 + [True]
        assert bool((dlp[:, 5] == 0).all())


@pytest.mark.parametrize("s_dim,t", [(257, 600), (801, 1000), (1025, 1200), (2049, 1200), (4097, 2300),
                                     (8193, 4500), (16385, 8700)])
def test_ctc_kernels_past_1024_states(cuda, s_dim, t):
    """Targets of 128 to 8192 labels: 2 to 17 warps of 8 states a lane, 17 warps of 16 (S = 8193) and of 32
    (S = 16385), against the plain loops. Over thousands of frames the two routes' float32 sums drift apart by
    more than at T = 751: rtol 1e-5."""
    from thunder_tpu_torch.kernels.ctc import alpha_reference, beta_reference, ctc_alpha, ctc_beta, ll_from_alpha
    from thunder_tpu_torch.kernels.selftest import ctc_long_case
    from thunder_tpu_torch.ops.ctc import extended_emissions

    logits, targets, lens, tl = ctc_long_case(16, s_dim, "cuda", t=t)
    lp_z, skip_ok = extended_emissions(torch.log_softmax(logits, dim=-1), targets, blank=0)
    assert lp_z.shape == (t, 2, s_dim)
    alpha = ctc_alpha(lp_z, skip_ok, lens, tl)
    want_alpha = alpha_reference(lp_z, skip_ok, lens, tl)
    ll, want_ll = ll_from_alpha(alpha, lens, tl), ll_from_alpha(want_alpha, lens, tl)
    assert bool((want_ll > -1e29).all())  # both alignments possible
    torch.testing.assert_close(ll, want_ll, rtol=1e-5, atol=0)
    ghat = 1.0 / tl.float()
    dlp = ctc_beta(lp_z, alpha, skip_ok, lens, tl, ll, ghat)
    want = beta_reference(lp_z, want_alpha, skip_ok, lens, tl, want_ll, ghat)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dlp).all())
    torch.testing.assert_close(dlp, want, rtol=0, atol=1e-4 * want.abs().max().item())


def test_ctc_kernels_raise_past_the_shared_row(cuda):
    """Past 32 warps of 32 lanes of 32 states (MAX_STATES) the wrapper raises before any launch."""
    from thunder_tpu_torch.kernels.ctc import MAX_STATES, ctc_alpha

    lp_z = torch.zeros(1, 1, MAX_STATES + 1, device="cuda")
    skip_ok = torch.zeros(1, MAX_STATES + 1, dtype=torch.bool, device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    before = ctc_alpha.launches
    with pytest.raises(ValueError, match="32 warps of 32 lanes"):
        ctc_alpha(lp_z, skip_ok, one, one)
    assert ctc_alpha.launches == before


def test_ctc_plan_matches_the_kernel(cuda):
    """The Python mirror of the CTC kernels' plan against ``thunder_ctc_plan``, and the kernel's refusals."""
    import ctypes

    from thunder_tpu_torch.kernels import _build
    from thunder_tpu_torch.kernels.ctc import MAX_STATES, ctc_plan

    out = (ctypes.c_int * 2)()
    lib = _build.load()
    for s_dim in [1, 2, 3, 19, 33, 65, 129, 255, 256, 257, 1025, 2049, 8192, 8193, 16385, 29054, MAX_STATES]:
        _build.check(lib.thunder_ctc_plan(s_dim, ctypes.addressof(out)), "thunder_ctc_plan")
        assert ctc_plan(s_dim) == {"warps": out[0], "states_per_lane": out[1]}, s_dim
    assert lib.thunder_ctc_plan(0, ctypes.addressof(out)) != 0
    assert lib.thunder_ctc_plan(MAX_STATES + 1, ctypes.addressof(out)) != 0


def test_one_train_step_on_card_launches_each_kernel_once(cuda):
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.trainer import Trainer

    tokens = list("abcdefghijklmnopqrstuvwxyz '")
    module = CTCModule.create(
        torch.Generator().manual_seed(0),
        FilterbankFeatures(num_time_masks=2, num_freq_masks=2),
        QuartznetEncoder(repeat=2, filters=(256,), kernel_sizes=(33,), dropout=0.1, dtype=torch.bfloat16),
        Conv1dDecoder(29, dtype=torch.bfloat16),
        BatchTextTransformer(tokens),
        device="cuda",
    )
    audio = (np.random.default_rng(0).standard_normal((2, 32000)) * 0.1).astype(np.float32)
    loader = [(audio, np.array([32000, 20000], np.int32), ["hello world", "the cat"])]
    reset_launch_counts()
    trainer = Trainer(device="cuda", fast_dev_run=True)
    trained = trainer.fit(module, loader)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    assert {k: v for k, v in counts.items() if v} == {"fused_log_mel": 1, "ctc_alpha": 1, "ctc_beta": 1}
    assert np.isfinite(trainer.logs[0]["loss/train_loss"])
    assert trained.device.type == "cuda"


@pytest.mark.parametrize(
    "b,t,v,width,k,floor,carried,ties",
    [(3, 29, 9, 8, 9, -12.0, False, False), (3, 23, 40, 6, 7, -10.0, False, False),
     (2, 21, 9, 1, 9, -12.0, False, False), (2, 12, 8, 6, 8, -2.0, False, False),
     (2, 19, 9, 5, 9, -12.0, True, False), (5, 64, 29, 40, 29, -12.0, False, False),
     (3, 15, 9, 8, 9, -12.0, False, True), (2, 10, 9, 40, 9, -1.5, False, False),
     (2, 6, 300, 16, 50, -12.0, False, False), (2, 12, 200, 64, 128, -12.0, False, False),
     (1, 1000, 29, 16, 29, -12.0, False, False), (2, 10, 1025, 16, 1025, -12.0, False, False),
     (2, 12, 29, 300, 29, -12.0, False, False),
     # past one block of shared memory (the chunked scan): a carried state, K < V, exact ties, a beam of one, and
     # fewer finite candidates than W = 40 on the ranking path
     (2, 19, 1700, 16, 1700, -12.0, True, False), (2, 8, 4000, 16, 2000, -12.0, False, False),
     (3, 15, 5000, 8, 5000, -12.0, False, True), (2, 6, 20000, 1, 20000, -12.0, False, False),
     (2, 10, 3000, 40, 3000, -1.5, False, False)],
)
def test_beam_kernels_match_plain_versions_at_small_shapes(cuda, b, t, v, width, k, floor, carried, ties):
    """K = V and K < V, a beam of one, frames the floor empties (flat frames), a carried state, W above a warp;
    exact ties (integer-valued logits), fewer finite candidates than W = 40 (a high floor), W*K = 800 and
    8192, one ``predict_long`` window (B = 1, T = 1000), and past 8192 candidates: V = K = 1025 at W = 16
    and W = 300."""
    from thunder_tpu_torch.kernels.beam import (
        beam_backtrace,
        beam_backtrace_reference,
        beam_scan,
        beam_scan_reference,
    )

    rng = np.random.default_rng(31)
    logits = rng.normal(0, 2, (b, t, v)).astype(np.float32)
    logits = torch.as_tensor(np.round(logits) if ties else logits, device="cuda")
    logits[:, 2:4] = 0.0  # flat frames: -log(V) for every token
    logp = torch.log_softmax(logits, dim=-1)
    lengths = torch.as_tensor([t] + [max(t - 9 * i, 0) for i in range(1, b)], dtype=torch.int32, device="cuda")
    kw = dict(blank=v - 1, beam_width=width, k_tokens=k)
    init = None
    if carried:
        _, _, _, init = beam_scan_reference(torch.log_softmax(logits[:, :7] * 1.5, -1), lengths.clamp(max=7), floor, **kw)
    got, want = beam_scan(logp, lengths, floor, init_state=init, **kw), beam_scan_reference(logp, lengths, floor,
                                                                                         init_state=init, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("parents", "exts"), got[:2], want[:2]):
        assert torch.equal(x, y), name
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=2e-3)
    for x, y in zip(got[3][2:], want[3][2:]):
        assert torch.equal(x, y)
    slots0 = torch.argsort(-want[2], dim=1, stable=True)[:, : min(3, width)].to(torch.int32)
    toks, origin = beam_backtrace(want[0], want[1], slots0)
    toks0, origin0 = beam_backtrace_reference(want[0], want[1], slots0)
    torch.cuda.synchronize()
    assert torch.equal(toks, toks0) and torch.equal(origin, origin0)


@pytest.mark.parametrize("b,t,w,paths,offset", [
    *[(4, t, w, paths, 0) for t in (1, 31, 32, 33, 751) for w in (1, 2, 3, 16, 64) for paths in ("one", "every")],
    (200, 751, 16, "one", 0), (200, 188, 16, "every", 0),  # more rows than SMs
    (3, 37, 3, "every", 1), (3, 41, 5, "every", 3), (3, 40, 300, "one", 2),  # span edges not on 16 bytes
    (2, 120, 300, "every", 0), (2, 0, 16, "one", 0), (2, 0, 16, "every", 0),
    (2, 4000, 16, "one", 1), (1, 5000, 16, "every", 0), (2, 3000, 5, "every", 0),  # rows past one span
    (2, 1001, 16, "every", 0), (1, 50, 6144, "one", 0),
])
def test_beam_backtrace_kernel_matches_the_plain_walk_at_its_edges(cuda, b, t, w, paths, offset):
    """Both routes of the staged backtrace (the composed and the serial walk, ``backtrace_plan``) against the plain
    walk, bit for bit, ``toks`` and ``origin``: slots outside [0, W) as parents and as start slots, T = 0, more rows
    than SMs, frames of 4W bytes whose spans start and end off 16 bytes (W = 3, 5, 300, and fields that start off
    16 bytes), rows longer than one span (the entry slots carried from span to span), one launch a call; and the
    serial walk (``thunder_beam_backtrace_serial``) at every one of these shapes, where the plan picks the composed
    walk too."""
    from thunder_tpu_torch.kernels import _build
    from thunder_tpu_torch.kernels.beam import backtrace_plan, beam_backtrace, beam_backtrace_reference

    n_out = 1 if paths == "one" else w
    parents, exts, slots0 = pointer_field(b * 7 + t + w, b, t, w, n_out, "cuda", offset)
    before = beam_backtrace.launches
    toks, origin = beam_backtrace(parents, exts, slots0)
    torch.cuda.synchronize()
    assert beam_backtrace.launches == before + 1
    want_toks, want_origin = beam_backtrace_reference(parents, exts, slots0)
    assert torch.equal(toks, want_toks) and torch.equal(origin, want_origin), backtrace_plan(w, n_out, t)
    toks.fill_(-99)
    origin.fill_(-99)
    _build.check(_build.load().thunder_beam_backtrace_serial(
        parents.data_ptr(), exts.data_ptr(), slots0.data_ptr(), toks.data_ptr(), origin.data_ptr(), b, t, w, n_out,
        torch.cuda.current_stream().cuda_stream), "thunder_beam_backtrace_serial")
    torch.cuda.synchronize()
    assert torch.equal(toks, want_toks) and torch.equal(origin, want_origin), "the serial walk"


def test_beam_backtrace_plan_matches_the_kernel(cuda):
    """The Python mirror of the backtrace's plan against ``thunder_beam_backtrace_plan``."""
    import ctypes

    from thunder_tpu_torch.kernels import _build
    from thunder_tpu_torch.kernels.beam import BACKTRACE_ROUTES, backtrace_plan

    out = (ctypes.c_int * 5)()
    for w, n_out, t in [(16, 1, 751), (16, 16, 1001), (16, 16, 188), (3, 3, 35), (3, 3, 36), (16, 35, 751),
                        (63, 64, 500), (64, 64, 751), (300, 3, 120), (1, 1, 1), (16, 1, 0), (16, 1, 4000),
                        (6144, 6144, 10), (6145, 1, 10), (7000, 7000, 20), (5, 5, 100000), (2, 200, 9)]:
        _build.check(_build.load().thunder_beam_backtrace_plan(w, n_out, t, ctypes.addressof(out)),
                     "thunder_beam_backtrace_plan")
        assert backtrace_plan(w, n_out, t) == {"route": BACKTRACE_ROUTES[out[0]], "threads": out[1], "span": out[2],
                                               "smem_bytes": out[3], "blocks_y": out[4]}, (w, n_out, t)


@pytest.mark.parametrize("rows", [1, 5992])
@pytest.mark.parametrize("d", [1, 36, 768, 2056])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.999])
def test_dropout_keep_mask_kernel_matches_its_plain_version(cuda, rows, d, rate):
    """The keep-mask kernel (a warp a row, float4 stores where d % 4 == 0) bit for bit against its plain version,
    one launch a call."""
    from thunder_tpu_torch.kernels.add_ln_train import dropout_keep_mask, dropout_keep_mask_reference

    seed = torch.tensor([20260821 + d], dtype=torch.int32, device="cuda")
    before = dropout_keep_mask.launches
    got = dropout_keep_mask((rows, d), seed, rate)
    torch.cuda.synchronize()
    assert dropout_keep_mask.launches == before + 1
    assert torch.equal(got, dropout_keep_mask_reference((rows, d), seed, rate))


def test_beam_scan_plan_matches_the_kernel_and_refuses_above_shared_memory(cuda):
    import ctypes

    from thunder_tpu_torch.kernels import _build
    from thunder_tpu_torch.kernels.beam import beam_scan, beam_scan_reference, scan_plan

    out = (ctypes.c_int * 4)()
    for width, k in [(1, 1), (1, 29), (16, 29), (16, 50), (40, 29), (64, 128), (2048, 4), (3058, 1), (16, 1606),
                     (16, 3000), (64, 1000), (33, 30000), (2901, 1), (2902, 1), (3000, 29), (7000, 5)]:
        _build.check(_build.load().thunder_beam_scan_plan(width, k, ctypes.addressof(out)), "thunder_beam_scan_plan")
        assert scan_plan(width, k) == {"threads": out[0], "smem_bytes": out[1], "chunk_runs": out[2],
                                       "workspace_bytes": 4 * out[3]}, (width, k)
    # above shared memory (W = 3,058 at K = 1): the workspace plan, exactly the plain version's pointers and state
    logp = torch.log_softmax(torch.randn((1, 4, 2), device="cuda", generator=torch.Generator("cuda").manual_seed(0)),
                             -1)
    lens = torch.full((1,), 4, device="cuda")
    kw = dict(blank=1, beam_width=3058, k_tokens=1)
    assert scan_plan(3058, 1)["workspace_bytes"] > 0
    before = beam_scan.launches
    got, want = beam_scan(logp, lens, -12.0, **kw), beam_scan_reference(logp, lens, -12.0, **kw)
    assert beam_scan.launches == before + 1
    for x, y in zip([*got[:2], *got[3][2:]], [*want[:2], *want[3][2:]]):
        assert torch.equal(x, y)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=2e-3)


def test_add_ln_train_backward_plan_matches_the_kernel(cuda):
    """The Python mirror of the backward's plan against ``thunder_add_ln_train_plan`` on this card."""
    import ctypes

    from thunder_tpu_torch.kernels import _build
    from thunder_tpu_torch.kernels.add_ln_train import backward_plan

    out = (ctypes.c_int * 4)()
    for rows, d in [(1, 768), (3, 768), (5992, 768), (100003, 768), (7, 36), (11992, 2048), (9, 2056)]:
        lib = _build.load()
        _build.check(lib.thunder_add_ln_train_plan(rows, d, ctypes.addressof(out)), "thunder_add_ln_train_plan")
        plan = backward_plan(rows, d, out[2])
        assert out[2] == torch.cuda.get_device_properties(0).multi_processor_count
        assert (plan["blocks"], plan["warps"], plan["smem_bytes"]) == (out[0], out[1], out[3]), (rows, d)


def test_beam_predict_on_card_goes_through_both_kernels(cuda):
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.kernels.beam import beam_backtrace, beam_backtrace_reference, beam_scan, beam_scan_reference
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    tokens = list("abcdefghijklmnopqrstuvwxyz '")
    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(),
                              QuartznetEncoder(repeat=2, filters=(256,), kernel_sizes=(33,)), Conv1dDecoder(29),
                              BatchTextTransformer(tokens), device="cuda")
    engine = InferenceEngine(module)
    audio = (np.random.default_rng(0).standard_normal((3, 32000)) * 0.2).astype(np.float32)
    lengths = np.array([32000, 20000, 400], np.int32)
    reset_launch_counts()
    texts = engine.predict(audio, lengths, beam_width=8, beam_backend="device")
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    assert counts["beam_scan"] == 1 and counts["beam_backtrace"] == 1 and counts["fused_log_mel"] == 1
    # the same logits through the plain versions on the card
    logits, _, out_lengths = engine.infer(audio, lengths)
    parents, exts, total, _ = beam_scan_reference(torch.log_softmax(logits.float(), -1), out_lengths, -12.0,
                                                  blank=module.blank_idx, beam_width=8, k_tokens=50)
    slots0 = torch.argsort(-total, dim=1, stable=True)[:, :1].to(torch.int32)
    toks, _ = beam_backtrace_reference(parents, exts, slots0)
    want = [module.text_transform.decode_prediction(row[row >= 0][None].cpu().numpy(), remove_repeated=False)[0]
            for row in toks[:, 0]]
    assert texts == want
    # predict_long: one scan and one backtrace per window (4 windows of 1.5 s, 1 s apart, over 4 s)
    reset_launch_counts()
    text = engine.predict_long(np.tile(audio[0], 2), chunk_seconds=1.5, overlap_seconds=0.5, beam_width=8,
                               beam_backend="device")
    torch.cuda.synchronize()
    assert isinstance(text, str) and set(text) <= set(tokens)
    assert (beam_scan.launches, beam_backtrace.launches) == (4, 4)


SEED = 20260821


@pytest.mark.parametrize(
    "b,t,heads,lengths,rate",
    [(2, 1, 2, [1, 0], 0.3), (3, 31, 1, [31, 17, 0], 0.1), (2, 749, 12, [749, 0], 0.1), (1, 1536, 2, [1500], 0.3),
     (2, 200, 3, [200, 64], 0.0), (1, 1664, 2, [1664], 0.1), (1, 1665, 2, [1665], 0.1),
     (1, 3001, 12, [3001], 0.1),
     # the backward's tile edges: 64-row tiles, 128-row blocks, lengths that end inside a tile, one head, a block
     # of keys wholly past a length (written as zeros)
     (2, 63, 1, [63, 40], 0.1), (1, 64, 1, [64], 0.0), (2, 65, 1, [65, 33], 0.1), (2, 127, 1, [127, 100], 0.3),
     (2, 128, 2, [128, 0], 0.1), (3, 129, 1, [129, 65, 1], 0.1), (2, 300, 1, [300, 97], 0.1)],
)
def test_training_attention_kernels_edge_shapes(cuda, b, t, heads, lengths, rate):
    """Forward and backward against the plain versions (8 bf16 ULP), the uniform row of a length 0 finite, and
    the same bits from two runs."""
    from thunder_tpu_torch.kernels.attention_train import (
        mha_train_backward,
        mha_train_backward_reference,
        mha_train_forward,
        mha_train_forward_reference,
    )
    from thunder_tpu_torch.kernels.selftest import attention_train_case, ulp_bf16_error

    qkv, lens, ct = attention_train_case(41, b, t, heads, lengths, "cuda", zero_padded_cotangent=False)
    seed = torch.tensor([SEED], dtype=torch.int32, device="cuda")
    out, stats = mha_train_forward(qkv, lens, seed, heads, rate)
    dqkv = mha_train_backward(qkv, out, stats, ct, lens, seed, heads, rate)
    again = mha_train_backward(qkv, *mha_train_forward(qkv, lens, seed, heads, rate), ct, lens, seed, heads, rate)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(dqkv).all())
    assert torch.equal(dqkv, again)
    out_p, stats_p = mha_train_forward_reference(qkv, lens, seed, heads, rate)
    assert ulp_bf16_error(out, out_p) <= 8.0
    torch.testing.assert_close(stats, stats_p, rtol=1e-4, atol=1e-4)
    assert ulp_bf16_error(dqkv, mha_train_backward_reference(qkv, out, stats, ct, lens, seed, heads, rate)) <= 8.0


@pytest.mark.parametrize("b,t,heads,lengths", [(1, 1, 1, [1]), (3, 33, 3, [33, 26, 0]), (2, 65, 5, [65, 64]),
                                               (2, 129, 1, [129, 37]), (2, 300, 1, [300, 97]), (1, 1665, 2, [1665])])
def test_attention_kernels_at_heads_of_80_edge_shapes(cuda, b, t, heads, lengths):
    """Heads of 80 (two TMA boxes a tile): the serving kernel within 4 bf16 ULP of its plain version and the
    training kernels at rate 0 within 8, on T of 1, T off the 64-row tiles and the 192-row backward blocks, odd
    head counts and a row of length 0; the training kernels give the same bits from two runs."""
    from thunder_tpu_torch.kernels.attention import mha_from_qkv, mha_from_qkv_reference
    from thunder_tpu_torch.kernels.attention_train import (
        mha_train_backward,
        mha_train_backward_reference,
        mha_train_forward,
        mha_train_forward_reference,
    )
    from thunder_tpu_torch.kernels.selftest import attention_train_case, ulp_bf16_error

    qkv, lens, ct = attention_train_case(45, b, t, heads, lengths, "cuda", zero_padded_cotangent=False, dh=80)
    seed = torch.tensor([SEED], dtype=torch.int32, device="cuda")
    served = mha_from_qkv(qkv, lens, heads)
    out, stats = mha_train_forward(qkv, lens, seed, heads)
    dqkv = mha_train_backward(qkv, out, stats, ct, lens, seed, heads)
    again = mha_train_backward(qkv, *mha_train_forward(qkv, lens, seed, heads), ct, lens, seed, heads)
    torch.cuda.synchronize()
    assert served.shape == out.shape == (b, t, heads * 80) and dqkv.shape == qkv.shape
    assert all(bool(torch.isfinite(x).all()) for x in (served, out, dqkv)) and torch.equal(dqkv, again)
    assert ulp_bf16_error(served, mha_from_qkv_reference(qkv, lens, heads)) <= 4.0
    out_p, stats_p = mha_train_forward_reference(qkv, lens, seed, heads)
    assert ulp_bf16_error(out, out_p) <= 8.0
    torch.testing.assert_close(stats, stats_p, rtol=1e-4, atol=1e-4)
    assert ulp_bf16_error(dqkv, mha_train_backward_reference(qkv, out, stats, ct, lens, seed, heads)) <= 8.0


def test_attention_kernels_refuse_dropout_at_heads_of_80_and_other_widths(cuda):
    """Heads of 80 train only at rate 0: the wrappers raise above it, before any launch; widths other than 64 and
    80 raise in every wrapper."""
    from thunder_tpu_torch.kernels.attention import mha_from_qkv
    from thunder_tpu_torch.kernels.attention_train import mha_train, mha_train_backward, mha_train_forward
    from thunder_tpu_torch.kernels.selftest import attention_train_case

    qkv, lens, ct = attention_train_case(46, 2, 70, 2, [70, 40], "cuda", dh=80)
    seed = torch.tensor([SEED], dtype=torch.int32, device="cuda")
    out, stats = mha_train_forward(qkv, lens, seed, 2)
    launched = (mha_train_forward.launches, mha_train_backward.launches)
    with pytest.raises(ValueError, match="dropout only at dh = 64"):
        mha_train_forward(qkv, lens, seed, 2, 0.1)
    with pytest.raises(ValueError, match="dropout only at dh = 64"):
        mha_train_backward(qkv, out, stats, ct, lens, seed, 2, 0.1)
    with pytest.raises(ValueError, match="dropout only at dh = 64"):
        mha_train(qkv.clone().requires_grad_(True), lens, seed, 2, 0.1)
    assert (mha_train_forward.launches, mha_train_backward.launches) == launched
    wide, _, _ = attention_train_case(47, 1, 64, 2, [64], "cuda", dh=96)
    with pytest.raises(ValueError, match="dh = 64 or 80"):
        mha_from_qkv(wide, lens[:1], 2)
    with pytest.raises(ValueError, match="dh = 64 or 80"):
        mha_train_forward(wide, lens[:1], seed, 2)


@pytest.mark.parametrize("rows,d,rate", [((7,), 128, 0.1), ((1001,), 768, 0.1), ((3, 67), 1024, 0.3), ((9,), 2048, 0.1),
                                         ((130,), 1032, 0.0), ((1,), 8, 0.5), ((5,), 36, 0.1), ((3, 5), 2056, 0.2),
                                         ((17,), 1, 0.0), ((9,), 4100, 0.1), ((8, 749), 768, 0.1), ((3,), 768, 0.1),
                                         ((2, 3001), 1536, 0.1), ((600,), 36, 0.1)])
def test_add_ln_train_kernels_edge_shapes(cuda, rows, d, rate):
    """Row counts that are no multiple of a warp's rows or a block, every instantiated width, and widths the
    registers do not hold (not a multiple of 8, over 2048); the same bits twice."""
    from thunder_tpu_torch.kernels.add_ln_train import (
        add_ln_train_backward,
        add_ln_train_backward_reference,
        add_ln_train_forward,
        add_ln_train_forward_reference,
        dropout_keep_mask,
        dropout_keep_mask_reference,
    )
    from thunder_tpu_torch.kernels.selftest import add_ln_train_case, ulp_bf16_error

    x, y, scale, bias, ct = add_ln_train_case(42, rows, d, "cuda")
    seed = torch.tensor([SEED], dtype=torch.int32, device="cuda")
    run = lambda: (add_ln_train_forward(x, y, scale, bias, seed, rate),  # noqa: E731
                   *add_ln_train_backward(x, y, scale, seed, ct, rate))
    got, again = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = (add_ln_train_forward_reference(x, y, scale, bias, seed, rate),
            *add_ln_train_backward_reference(x, y, scale, seed, ct, rate))
    for g, w in zip(got[:3], want[:3]):
        assert ulp_bf16_error(g, w) <= 8.0
    for g, w in zip(got[3:], want[3:]):
        assert (g - w).abs().max().item() <= 0.01 * max(w.abs().max().item(), 1e-9)
    assert torch.equal(dropout_keep_mask(x.shape, seed, rate), dropout_keep_mask_reference(x.shape, seed, rate))


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("t", [31, 749])
def test_training_kernels_with_row_offsets_equal_the_whole_batch_on_card(cuda, parts, t):
    """A data-parallel rank's rows: the training kernels on each slice of a batch, with its rows' offset, give the
    whole batch's keep mask, add + dropout + LayerNorm output, dx, dy, attention output, statistics and packed
    dqkv bit for bit (the slices' dscale and dbias sum to the whole's within float32 order), and the plain
    versions with the same offsets within the existing 8 bf16 ULP."""
    from thunder_tpu_torch.kernels.selftest import row_offset_check

    result = row_offset_check(parts, 8, t, 12, 0.1, "cuda")
    assert all(result[k] for k in ("mask_bits", "add_ln_bits", "dx_dy_bits", "attn_bits", "stats_bits", "dqkv_bits",
                                   "mask_vs_plain_bits")), result
    assert result["vs_plain"] <= 8.0 and result["dparams_rel"] <= 1e-5, result


def test_training_autograd_functions_give_the_plain_backward_on_card(cuda):
    from thunder_tpu_torch.kernels.add_ln_train import add_ln_dropout_train, add_ln_train_backward_reference
    from thunder_tpu_torch.kernels.attention_train import (
        mha_train,
        mha_train_backward_reference,
        mha_train_forward,
    )
    from thunder_tpu_torch.kernels.selftest import add_ln_train_case, attention_train_case, ulp_bf16_error

    seed = torch.tensor([SEED], dtype=torch.int32, device="cuda")
    qkv, lens, ct = attention_train_case(43, 2, 333, 4, [333, 150], "cuda")
    leaf = qkv.clone().requires_grad_(True)
    out = mha_train(leaf, lens, seed, 4, 0.1)
    out.backward(ct)
    out_k, stats = mha_train_forward(qkv, lens, seed, 4, 0.1)
    assert torch.equal(out.detach(), out_k)
    assert ulp_bf16_error(leaf.grad, mha_train_backward_reference(qkv, out_k, stats, ct, lens, seed, 4, 0.1)) <= 8.0

    x, y, scale, bias, ct = add_ln_train_case(44, (2, 99), 768, "cuda")
    leaves = [a.clone().requires_grad_(True) for a in (x, y, scale, bias)]
    add_ln_dropout_train(*leaves, seed, 0.1).backward(ct)
    want = add_ln_train_backward_reference(x, y, scale, seed, ct, 0.1)
    for leaf, w in zip(leaves[:2], want[:2]):
        assert leaf.grad.dtype == torch.bfloat16 and ulp_bf16_error(leaf.grad, w) <= 8.0
    for leaf, w in zip(leaves[2:], want[2:]):
        assert leaf.grad.dtype == torch.float32
        assert (leaf.grad - w).abs().max().item() <= 0.01 * w.abs().max().item()


def test_training_wrappers_raise_on_card_for_what_the_kernels_do_not_take(cuda):
    from thunder_tpu_torch.kernels.add_ln_train import add_ln_train_forward
    from thunder_tpu_torch.kernels.attention_train import mha_train_forward

    seed = torch.zeros(1, dtype=torch.int32, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        mha_train_forward(torch.zeros(1, 4, 192, device="cuda"), lens, seed, 1)
    with pytest.raises(ValueError, match="dh = 64"):
        mha_train_forward(torch.zeros(1, 4, 96, device="cuda", dtype=torch.bfloat16), lens, seed, 1)
    with pytest.raises(ValueError, match="65535"):
        mha_train_forward(torch.zeros(1, 4, 3 * 65536 * 64, device="cuda", dtype=torch.bfloat16), lens, seed, 65536)
    with pytest.raises(ValueError, match="seed"):
        mha_train_forward(torch.zeros(1, 4, 192, device="cuda", dtype=torch.bfloat16), lens, seed.cpu(), 1)
    x = torch.zeros(4, 12, device="cuda", dtype=torch.bfloat16)  # any width goes; a scale that does not fit raises
    with pytest.raises(ValueError, match="shapes"):
        add_ln_train_forward(x, x, torch.ones(13, device="cuda"), torch.zeros(13, device="cuda"), seed)
    x = torch.zeros(4, 16, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        add_ln_train_forward(x, x, torch.ones(16, device="cuda"), torch.zeros(16, device="cuda"), seed)


def test_small_wav2vec2_train_step_on_card_launches_the_training_kernels(cuda):
    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.trainer import Trainer

    tokens = list("abcdefghijklmnopqrstuvwxyz '")
    config = Wav2Vec2Config(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                            conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=False),
                              Wav2Vec2Encoder(config, dtype=torch.bfloat16, freeze_feature_extractor=True),
                              LinearDecoder(29, dtype=torch.bfloat16), BatchTextTransformer(tokens), device="cuda")
    audio = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    loader = [(audio, np.array([16000, 9000], np.int32), ["hello world", "the cat"])]
    reset_launch_counts()
    trainer = Trainer(device="cuda", fast_dev_run=True)
    trained = trainer.fit(module, loader)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    assert {k: v for k, v in counts.items() if v} == {
        "mha_train_forward": 2, "mha_train_backward": 4, "add_ln_train_forward": 5, "add_ln_train_backward": 10,
        "ctc_alpha": 1, "ctc_beta": 1}
    assert np.isfinite(trainer.logs[0]["loss/train_loss"])
    before, after = module.model.state_dict(), trained.model.state_dict()
    frozen = "encoder.feature_extractor."
    assert all(not torch.equal(before[k], after[k]) for k in before if not k.startswith(frozen))
    # the frozen extractor has no gradient and moves by weight decay alone
    key = frozen + "conv0.kernel"
    torch.testing.assert_close(after[key], before[key] * (1 - 1e-3 * 1e-2), rtol=1e-6, atol=0)
    assert not torch.equal(after[key], before[key])


@pytest.mark.parametrize("mode", [dict(posconv_dense=True), dict(int8_weights=True), dict(int8_compute=True),
                                  dict(int8_weights=True, int8_compute=True)], ids=lambda m: "+".join(m))
def test_small_wav2vec2_serving_modes_on_card_match_cpu(cuda, mode):
    """The engine's serving modes on a small wav2vec2 (64-channel extractor, so that ``int8_compute`` takes its
    convs 1 and 2): the same kernel launches as float mode, the int8 products through ``torch._int_mm``, within
    0.1 of the same mode in float32 on the CPU."""
    from thunder_tpu_torch import quantization
    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule

    config = Wav2Vec2Config(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                            conv_dim=(64, 64, 64), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                              Wav2Vec2Encoder(config), LinearDecoder(32), device="cuda")
    audio = (np.random.default_rng(0).standard_normal((3, 16000)) * 0.2).astype(np.float32)
    lengths = np.array([16000, 9000, 400], np.int32)
    engine = InferenceEngine(module, **mode)
    reset_launch_counts()
    products = quantization.int8_mm.launches
    got, got_lens = engine(audio, lengths)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    assert {k: v for k, v in counts.items() if v} == {"mha_from_qkv": 2, "add_layer_norm": 5}
    assert quantization.int8_mm.launches - products == (4 * 2 + 2 if mode.get("int8_compute") else 0)
    want, want_lens = InferenceEngine(module.to("cpu"), **mode)(audio, lengths)
    assert torch.equal(got_lens.cpu(), want_lens)
    valid = torch.arange(want.shape[1])[None, :] < want_lens[:, None]
    dev = (got.float().cpu() - want).abs()[valid].max() / want.abs()[valid].max()
    assert dev < 0.1  # bf16 on the card against float32 on the CPU


def test_small_quartznet_int8_weights_on_card_match_cpu(cuda):
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import fused_log_mel, fused_separable_repeat, reset_launch_counts
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule

    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(),
                              QuartznetEncoder(repeat=2, filters=(256,), kernel_sizes=(33,)), Conv1dDecoder(29),
                              device="cuda")
    audio = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    lengths = np.array([16000, 9000], np.int32)
    engine = InferenceEngine(module, int8_weights=True)
    assert engine.weight_bytes() < 0.6 * InferenceEngine(module).weight_bytes()
    reset_launch_counts()
    got, got_lens = engine(audio, lengths)
    assert (fused_log_mel.launches, fused_separable_repeat.launches) == (1, 4)
    want, want_lens = InferenceEngine(module.to("cpu"), int8_weights=True)(audio, lengths)
    assert torch.equal(got_lens.cpu(), want_lens)
    valid = torch.arange(want.shape[1])[None, :] < want_lens[:, None]
    dev = (got.float().cpu() - want).abs()[valid].max() / want.abs()[valid].max()
    assert dev < 0.1


@pytest.mark.parametrize("m,k,n", [(1, 768, 2304), (16, 768, 768), (17, 3072, 768), (11984, 768, 3072),
                                   (5, 13, 3)])
def test_int8_mm_on_card_is_the_exact_product(cuda, m, k, n):
    """``torch._int_mm`` through ``int8_mm``'s padding (rows to 17, widths to multiples of 8) equals the plain
    version's int64 product on the same card tensors, bit for bit."""
    from thunder_tpu_torch import quantization

    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    before = quantization.int8_mm.launches
    got = quantization.int8_mm(a, b)
    assert quantization.int8_mm.launches == before + 1 and got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, quantization.int8_mm_reference(a, b))


@pytest.mark.parametrize("kind", ["matmul", "conv"])
def test_dynamic_int8_products_on_card_equal_the_cpu(cuda, kind):
    """The float32 quantize passes, the exact integer product and the float32 rescale are each correctly rounded
    elementwise, so the card's dynamic products equal the CPU's bit for bit on the same input."""
    from thunder_tpu_torch import quantization

    rng = np.random.default_rng(1)
    if kind == "matmul":
        x = torch.as_tensor(rng.standard_normal((300, 768)).astype(np.float32)).to(torch.bfloat16)
        q, scale = quantization.quantize_array(rng.standard_normal((768, 3072)).astype(np.float32) * 0.05)
        args = (torch.as_tensor(q), torch.as_tensor(scale.reshape(-1)))
        fn = quantization.dynamic_int8_matmul
    else:
        x = torch.as_tensor(rng.standard_normal((2, 999, 512)).astype(np.float32)).to(torch.bfloat16)
        q, scale = quantization.quantize_array(rng.standard_normal((3, 512, 512)).astype(np.float32) * 0.05)
        args = (torch.as_tensor(q), torch.as_tensor(scale.reshape(-1)), 2)
        fn = quantization.dynamic_int8_conv
    got = fn(x.cuda(), *(a.cuda() if isinstance(a, torch.Tensor) else a for a in args))
    assert torch.equal(got.cpu(), fn(x, *args))


def test_log_mel_wide_path_at_an_fft_size_of_no_power_of_two_on_card(cuda):
    """C16: the wide path with n_fft 30,000 (the basis's phase step mod n_fft rounds 2 r / n_fft) against the
    plain version, at 2e-3, in two launches."""
    from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_plan, log_mel_reference
    from thunder_tpu_torch.kernels.selftest import exact_float32

    exact_float32()
    kw = dict(n_fft=30000, hop_length=3000, win_length=15000, n_mels=80)
    assert log_mel_plan(30000, 3000, 15000, 80)["path"] == "wide"
    audio = torch.as_tensor(np.random.default_rng(2).standard_normal((3, 40000)).astype(np.float32) * 0.2,
                            device="cuda")
    before = fused_log_mel.launches
    got = fused_log_mel(audio, **kw)
    assert fused_log_mel.launches == before + 2
    assert (got - log_mel_reference(audio, **kw)).abs().max().item() <= 2e-3


FIXTURES = Path(__file__).parent / "fixtures"


@pytest.mark.parametrize("name", ["tiny_quartznet", "tiny_citrinet"])
def test_fixtures_load_on_card_and_match_cpu(cuda, name):
    from thunder_tpu_torch import load_pretrained
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import fused_log_mel, fused_separable_repeat, reset_launch_counts

    module = load_pretrained(str(FIXTURES / f"{name}.nemo"))
    assert module.device.type == "cuda" and next(module.model.parameters()).is_cuda
    engine = InferenceEngine(module)
    repeats = sum(rp.kind == "separable" for block in engine._plan for rp in block.repeats)
    audio = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    lengths = np.array([16000, 9000], np.int32)
    reset_launch_counts()
    got, got_lens = engine(audio, lengths)
    assert (fused_log_mel.launches, fused_separable_repeat.launches) == (1, repeats)
    want, want_lens = InferenceEngine(module.to("cpu"))(audio, lengths)
    assert torch.equal(got_lens.cpu(), want_lens)
    valid = torch.arange(want.shape[1])[None, :] < want_lens[:, None]
    assert (got.float().cpu() - want).abs()[valid].max() / want.abs()[valid].max() < 0.1


@pytest.mark.parametrize("name", ["tiny_quartznet", "tiny_citrinet"])
def test_bundle_round_trip_on_card_is_bit_equal(cuda, name, tmp_path):
    from thunder_tpu_torch import load_inference_bundle, load_pretrained, save_inference_bundle
    from thunder_tpu_torch.engine import InferenceEngine

    module = load_pretrained(str(FIXTURES / f"{name}.nemo"))
    restored = load_inference_bundle(save_inference_bundle(str(tmp_path / "bundle"), module))
    assert restored.device.type == "cuda"
    audio = (np.random.default_rng(1).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    lengths = np.array([16000, 12000], np.int32)
    a, _ = InferenceEngine(module)(audio, lengths)
    b, _ = InferenceEngine(restored)(audio, lengths)
    assert torch.equal(a, b)
    assert InferenceEngine(restored).predict(audio, lengths) == InferenceEngine(module).predict(audio, lengths)


def test_frozen_paths_step_on_card_leaves_the_extractor_bit_equal(cuda):
    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer
    from thunder_tpu_torch.training.trainer import Trainer

    config = Wav2Vec2Config(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                            conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=False),
                              Wav2Vec2Encoder(config, dtype=torch.bfloat16), LinearDecoder(29, dtype=torch.bfloat16),
                              BatchTextTransformer(list("abcdefghijklmnopqrstuvwxyz '")), device="cuda")
    module.frozen_paths = [("encoder", "feature_extractor")]
    audio = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    loader = [(audio, np.array([16000, 9000], np.int32), ["hello world", "the cat"])] * 2
    before = {k: v.clone() for k, v in module.model.state_dict().items()}
    after = Trainer(device="cuda").fit(module, loader).model.state_dict()
    frozen = [k for k in before if k.startswith("encoder.feature_extractor.")]
    assert frozen and all(torch.equal(after[k], before[k]) for k in frozen)
    assert all(not torch.equal(after[k], before[k]) for k in before if k not in frozen)


def test_hf_checkpoint_loads_on_card(cuda, tmp_path):
    """A tiny HF wav2vec2 (dh 64, so the serving kernels run) saved with ``save_pretrained``, loaded on the card:
    the attention and add + LayerNorm launches of one forward, within 0.1 of float32 on the CPU."""
    transformers = pytest.importorskip("transformers")
    import json

    from thunder_tpu_torch import load_pretrained
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import add_layer_norm, mha_from_qkv, reset_launch_counts

    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "a": 5, "b": 6, "c": 7}
    cfg = transformers.Wav2Vec2Config(vocab_size=len(vocab), hidden_size=128, num_hidden_layers=2,
                                      num_attention_heads=2, intermediate_size=256, conv_dim=(32, 32, 32),
                                      conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                                      num_conv_pos_embedding_groups=4)
    torch.manual_seed(0)
    transformers.Wav2Vec2ForCTC(cfg).eval().save_pretrained(tmp_path)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    transformers.Wav2Vec2CTCTokenizer(str(tmp_path / "vocab.json"), pad_token="<pad>", unk_token="<unk>",
                                      word_delimiter_token="|").save_pretrained(tmp_path)
    transformers.Wav2Vec2FeatureExtractor(do_normalize=True).save_pretrained(tmp_path)
    module = load_pretrained(str(tmp_path))
    assert module.device.type == "cuda" and module.frozen_paths == [("encoder", "feature_extractor")]
    audio = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    lengths = np.array([16000, 9000], np.int32)
    reset_launch_counts()
    got, got_lens = InferenceEngine(module)(audio, lengths)
    assert (mha_from_qkv.launches, add_layer_norm.launches) == (2, 5)
    want, want_lens = InferenceEngine(module.to("cpu"))(audio, lengths)
    assert torch.equal(got_lens.cpu(), want_lens)
    valid = torch.arange(want.shape[1])[None, :] < want_lens[:, None]
    assert (got.float().cpu() - want).abs()[valid].max() / want.abs()[valid].max() < 0.1


def _small_w2v2_module(remat: bool):
    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    config = Wav2Vec2Config(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                            conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    return CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=False),
                            Wav2Vec2Encoder(config, dtype=torch.bfloat16, freeze_feature_extractor=True, remat=remat),
                            LinearDecoder(29, dtype=torch.bfloat16), BatchTextTransformer(list("abcdefghijklmnopqrstuvwxyz '")),
                            device="cuda")


def _small_citrinet_module(remat: bool):
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.models import CitrinetEncoder, Conv1dDecoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    encoder = CitrinetEncoder(filters=(256, 256, 256), kernel_sizes=(11, 13, 15), strides=(1, 2, 2), feat_in=80,
                              repeat=2, dropout=0.1, dtype=torch.bfloat16, remat=remat)
    return CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(nfilt=80, num_time_masks=1),
                            encoder, Conv1dDecoder(29, dtype=torch.bfloat16),
                            BatchTextTransformer(list("abcdefghijklmnopqrstuvwxyz '")), device="cuda")


def _remat_step(module, audio, lengths, texts):
    """One forward + backward of the train step from the generator's seed 5: ``(loss, buffers, generator
    state, launches)``."""
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.ops.ctc import calculate_ctc
    from thunder_tpu_torch.training.trainer import _device_batch

    generator = torch.Generator(device="cuda").manual_seed(5)
    batch = _device_batch(module, audio, lengths, texts)
    reset_launch_counts()
    logits, out_lengths = module.model(batch[0], batch[1], train=True, generator=generator)
    loss = calculate_ctc(logits, batch[2], out_lengths, batch[3], module.blank_idx)
    loss.backward()
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS if w.launches}
    return loss.detach(), {k: v.clone() for k, v in module.model.named_buffers()}, generator.get_state(), counts


@pytest.mark.parametrize("family", ["wav2vec2", "citrinet"])
def test_remat_on_card_is_bit_transparent_and_relaunches_the_forward(cuda, family):
    make = _small_w2v2_module if family == "wav2vec2" else _small_citrinet_module
    audio = (np.random.default_rng(0).standard_normal((2, 32000)) * 0.2).astype(np.float32)
    lengths, texts = np.array([32000, 21000], np.int32), ["hello world", "the cat"]
    loss0, buffers0, gen0, counts0 = _remat_step(make(False), audio, lengths, texts)
    loss1, buffers1, gen1, counts1 = _remat_step(make(True), audio, lengths, texts)
    assert torch.equal(loss0, loss1) and torch.isfinite(loss1)
    assert buffers0.keys() == buffers1.keys() and all(torch.equal(buffers0[k], buffers1[k]) for k in buffers0)
    assert torch.equal(gen0, gen1)
    if family == "wav2vec2":  # 2 layers: the attention and two add + LN forwards of each once more
        assert counts0 == {"mha_train_forward": 2, "mha_train_backward": 4, "add_ln_train_forward": 5,
                           "add_ln_train_backward": 10, "ctc_alpha": 1, "ctc_beta": 1}
        assert counts1 == {**counts0, "mha_train_forward": 4, "add_ln_train_forward": 9}
    else:  # the frontend and the loss are outside the blocks
        assert counts0 == counts1 == {"fused_log_mel": 1, "ctc_alpha": 1, "ctc_beta": 1}


def test_checkpoint_on_card_restores_bit_equal_and_resumes(cuda, tmp_path):
    from thunder_tpu_torch.training import checkpointing
    from thunder_tpu_torch.training.optim import onecycle
    from thunder_tpu_torch.training.trainer import FinetuneEncoderDecoder, Trainer

    audio = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.2).astype(np.float32)
    loader = [(audio, np.array([16000, 9000], np.int32), ["hello world", "the cat"])] * 2

    def trainer(epochs, **kw):
        return Trainer(max_epochs=epochs, device="cuda", log_every=1, lr_scheduler_builder=onecycle,
                       lr_scheduler_kwargs={"max_lr": 1e-3, "total_steps": 4},
                       callbacks=[FinetuneEncoderDecoder(unfreeze_encoder_at_epoch=1)], **kw)

    module = _small_w2v2_module(remat=True)
    first = trainer(1, checkpoint_dir=str(tmp_path / "ck"))
    trained = first.fit(module, loader)
    folder = tmp_path / "ck" / "step_2"
    payload = checkpointing.restore_checkpoint(str(folder))
    assert payload["step"] == 2 and payload["generator"].device.type == "cpu"
    assert all(torch.equal(payload["model"][k], v.cpu()) for k, v in trained.model.state_dict().items())
    train_step, generator, _ = trainer(1).train_step_for(module.to("cuda"), loader)
    checkpointing.load_train_state(payload, train_step, generator)
    again = checkpointing.train_state(train_step, generator)
    assert torch.equal(again["generator"], payload["generator"])
    for name, state in payload["optimizer"]["state"].items():
        assert all(torch.equal(again["optimizer"]["state"][name][k], v) for k, v in state.items()), name
    resumed = trainer(1, resume_from=str(folder))
    resumed.fit(module, loader)
    assert len(resumed.logs) == 2 and all(np.isfinite(e["loss/train_loss"]) for e in resumed.logs)


def test_streaming_pool_on_card_equals_predict_long(cuda):
    """A ``StreamingPool`` of 4 streams on a small QuartzNet engine built ``batch_invariant`` (greedy and the device
    beam, padded to 4 rows a forward) gives each stream the text of ``predict_long`` on the same grid, which
    decodes at one row; a
    forward makes 1 log-mel launch and one separable repeat a repeat, the device beam one scan and one backtrace
    a window a stream."""
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.streaming import StreamingPool
    from thunder_tpu_torch.text import BatchTextTransformer

    tt = BatchTextTransformer(list("abcdefghijklmnopqrstuvwxyz '"))
    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(),
                              QuartznetEncoder(repeat=2, filters=(256,), kernel_sizes=(33,)), Conv1dDecoder(29), tt,
                              device="cuda")
    engine = InferenceEngine(module, batch_invariant=True)
    rng = np.random.default_rng(0)
    feeds = [(rng.standard_normal(int(s * 16000)) * 0.2).astype(np.float32) for s in (3.3, 4.1, 2.6, 5.0)]
    for beam in ({}, {"beam_width": 8, "beam_backend": "device"}):
        kw = dict(chunk_seconds=1.0, overlap_seconds=0.25, **beam)
        want = [engine.predict_long(f, **kw) for f in feeds]
        pool = StreamingPool(engine, batch_size=4, **kw)
        sids = [pool.open() for _ in feeds]
        reset_launch_counts()
        for start in range(0, max(f.size for f in feeds), 1600):
            for sid, f in zip(sids, feeds):
                if start < f.size:
                    pool.push(sid, f[start: start + 1600])
        assert [pool.flush(sid) for sid in sids] == want
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
        windows = sum(len(range(0, max(f.size - 4000, 1), 12000)) for f in feeds)
        assert counts["fused_separable_repeat"] == 4 * counts["fused_log_mel"] > 0  # stem, 2 body repeats, tail
        assert counts["beam_scan"] == counts["beam_backtrace"] == (windows if beam else 0)


def test_align_on_card_equals_its_cpu_run(cuda):
    """``CTCModule.align`` on the card: 1 log-mel launch; its Viterbi states and scores equal the plain CPU run of
    ``ctc_forced_align`` on the card's float32 log-probs bit for bit; a text too long for its frames is ``-inf``."""
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.ops.ctc import ctc_forced_align
    from thunder_tpu_torch.text import BatchTextTransformer

    tt = BatchTextTransformer(list("abcdefghijklmnopqrstuvwxyz '"))
    module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(),
                              QuartznetEncoder(repeat=2, filters=(256,), kernel_sizes=(33,)), Conv1dDecoder(29), tt,
                              device="cuda")
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((3, 48000)) * 0.2).astype(np.float32)
    lengths = np.array([48000, 30000, 16000], np.int32)
    texts = ["the cat sat", "a dog ran off", "ab" * 40]  # the last: 80 tokens in 51 frames
    reset_launch_counts()
    spans, scores = module.align(audio, texts, lengths)
    torch.cuda.synchronize()
    assert {w.__name__: w.launches for w in KERNEL_WRAPPERS}["fused_log_mel"] == 1
    assert np.isfinite(scores[:2]).all() and np.isneginf(scores[2])
    assert ["".join(t for t, _, _ in row) for row in spans] == texts
    logits, _, out_lengths = module.infer(audio, lengths)
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets, target_lengths = tt.encode(texts)
    card = ctc_forced_align(logp, out_lengths, torch.as_tensor(targets, device="cuda"),
                            torch.as_tensor(target_lengths, device="cuda"), module.blank_idx)
    cpu = ctc_forced_align(logp.cpu(), out_lengths.cpu(), torch.as_tensor(targets), torch.as_tensor(target_lengths),
                           module.blank_idx)
    for got, want in zip(card, cpu):
        assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(scores, cpu[2].numpy())


def test_custom_ops_equal_their_wrappers_on_card(cuda):
    """The three ops an exported predict graph calls (``thunder_tpu::fused_log_mel``, ``mha_from_qkv``,
    ``add_layer_norm``): each op's output equals its wrapper's bit for bit on the card, each call launches its
    kernel once, and ``torch.library.opcheck`` passes on card tensors."""
    from thunder_tpu_torch.kernels import add_layer_norm, fused_log_mel, mha_from_qkv, reset_launch_counts

    gen = torch.Generator(device="cuda").manual_seed(23)
    audio = torch.randn((2, 16000), device="cuda", generator=gen) * 0.2
    qkv = torch.randn((2, 49, 3 * 1024), device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.tensor([49, 30], dtype=torch.int32, device="cuda")
    x, y = (torch.randn((2, 49, 1024), device="cuda", generator=gen).to(torch.bfloat16) for _ in range(2))
    scale, bias = torch.rand(1024, device="cuda", generator=gen) + 0.5, torch.randn(1024, device="cuda", generator=gen)
    cases = [(fused_log_mel, torch.ops.thunder_tpu.fused_log_mel.default, (audio,), (audio, 16000, 512, 160, 320, 64, 0.97)),
             (mha_from_qkv, torch.ops.thunder_tpu.mha_from_qkv.default, (qkv, lens, 16), (qkv, lens, 16)),
             (add_layer_norm, torch.ops.thunder_tpu.add_layer_norm.default, (x, y, scale, bias),
              (x, y, scale, bias, 1e-5))]
    for wrapper, op, wrapper_args, op_args in cases:
        reset_launch_counts()
        got, want = op(*op_args), wrapper(*wrapper_args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), op
        assert wrapper.launches == 2, (op, wrapper.launches)
        torch.library.opcheck(op, op_args)


def test_exported_tiny_wav2vec2_serves_on_card(cuda, tmp_path):
    """``aot_export`` on the card of a bf16 wav2vec2 of hidden 128 in 2 heads of 64 (2 layers), loaded back by
    ``aot_load`` from its file: ``preds`` and lengths equal the live module's, and a call launches what the live
    forward launches (2 attention, 5 add + LayerNorm)."""
    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.export import aot_export, aot_load
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule

    cfg = Wav2Vec2Config(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                         conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                         num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    module = CTCModule.create(torch.Generator().manual_seed(3), Wav2Vec2Preprocess(mask_input=True),
                              Wav2Vec2Encoder(cfg, dtype=torch.bfloat16), LinearDecoder(5, dtype=torch.bfloat16),
                              device="cuda")
    rng = np.random.default_rng(4)
    audio = (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32)
    lengths = np.array([4000, 2900], np.int32)
    path = tmp_path / "predict.pt2"
    aot_export(module, 2, 4000, path=str(path))
    loaded = aot_load(path)
    counts = lambda: {w.__name__: w.launches for w in KERNEL_WRAPPERS}  # noqa: E731
    reset_launch_counts()
    _, want, want_lengths = module.infer(audio, lengths)
    live = counts()
    reset_launch_counts()
    preds, out_lengths = loaded.call(audio, lengths)
    torch.cuda.synchronize()
    assert counts() == live and live["mha_from_qkv"] == 2 and live["add_layer_norm"] == 5
    assert preds.device.type == "cuda" and torch.equal(preds, want) and torch.equal(out_lengths, want_lengths)


# ---- Trainer(steps_per_execution=K): the graphed train step against the eager one


def _small_quartznet_module(remat: bool = False):
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    return CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(num_time_masks=1, num_freq_masks=1),
                            QuartznetEncoder(repeat=2, filters=(64, 64), kernel_sizes=(33, 33), dropout=0.1,
                                             remat=remat),
                            Conv1dDecoder(29), BatchTextTransformer(list("abcdefghijklmnopqrstuvwxyz '")),
                            device="cuda")


def _scan_loader(samples, seed: int = 0):
    """Batches of 2 rows, one a length of ``samples``."""
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((2, n)) * 0.2).astype(np.float32), np.array([n, n * 3 // 4], np.int32),
             ["hello world", "the cat"]) for n in samples]


def _scan_fit(make, loader, k: int, epochs: int = 1, **kw):
    """A ``fit`` under deterministic algorithms: ``(trainer, losses, train state, launches)``."""
    from chip_smoke import deterministic_algorithms
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from thunder_tpu_torch.training.trainer import Trainer

    trainer = Trainer(max_epochs=epochs, device="cuda", log_every=1, seed=0, steps_per_execution=k, **kw)
    module = make()
    with deterministic_algorithms():
        reset_launch_counts()
        trainer.fit(module, loader)
        torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS if w.launches}
    losses = [e["loss/train_loss"] for e in trainer.logs if "loss/train_loss" in e]
    return trainer, losses, trainer.train_state(), counts


def _assert_same_state(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _assert_same_state(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_state(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def _kinds(loader, accumulate: int = 1, frozen_steps: int = 0) -> int:
    """The step kinds a graphed fit meets: (shape, update, frozen)."""
    kinds = set()
    for i, (audio, _, _) in enumerate(loader):
        update = (i + 1) % accumulate == 0
        kinds.add((audio.shape, update, update and i // accumulate < frozen_steps))
    return len(kinds)


SCAN_CASES = {
    "quartznet": (_small_quartznet_module, {}),
    "quartznet_remat_accumulate": (lambda: _small_quartznet_module(remat=True),
                                   dict(accumulate_grad_batches=2, gradient_clip_norm=1.0,
                                        lr_scheduler_kwargs={"max_lr": 1e-3, "total_steps_arg": "total_steps"})),
    "wav2vec2": (lambda: _small_w2v2_module(remat=False), {}),
    "wav2vec2_remat_finetune": (lambda: _small_w2v2_module(remat=True), {"finetune": True}),
}


def _scan_case(case: str, loader) -> tuple:
    """A SCAN_CASES entry over ``loader``: ``(make, Trainer arguments, epochs, the step kinds a graphed fit
    meets)``; the fine-tuning case runs two epochs, the first with the encoder frozen."""
    from thunder_tpu_torch.training.optim import onecycle
    from thunder_tpu_torch.training.trainer import FinetuneEncoderDecoder

    make, kw = SCAN_CASES[case]
    kw = dict(kw)
    if kw.pop("finetune", False):
        kw["callbacks"] = [FinetuneEncoderDecoder(unfreeze_encoder_at_epoch=1)]
    if "lr_scheduler_kwargs" in kw:
        kw["lr_scheduler_builder"] = onecycle
    epochs = 2 if "callbacks" in kw else 1
    frozen_steps = len(loader) if epochs == 2 else 0
    return make, kw, epochs, _kinds(loader * epochs, kw.get("accumulate_grad_batches", 1), frozen_steps)


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_graphed_train_steps_on_card_are_bit_equal_to_eager_steps(cuda, case):
    """``steps_per_execution=4`` against 1 from the same weights and seed: per-step losses, every parameter and
    running statistic, the optimizer's state and the generator's state bit-equal; the same launches (the
    replays add their capture's); every step past its kind's first replays a graph."""
    loader = _scan_loader([16000] * 5 + [12000] + [16000] * 2)
    make, kw, epochs, kinds = _scan_case(case, loader)
    _, losses1, state1, counts1 = _scan_fit(make, loader, 1, epochs, **kw)
    trainer, losses4, state4, counts4 = _scan_fit(make, loader, 4, epochs, **kw)
    assert losses4 == losses1 and all(np.isfinite(losses1))
    _assert_same_state(state4, state1)
    assert counts4 == counts1 and counts1
    assert (trainer.eager_steps, trainer.replayed_steps) == (kinds, len(loader) * epochs - kinds)


def test_graphed_train_step_past_the_bound_runs_eagerly_and_counts(cuda, monkeypatch):
    from thunder_tpu_torch.training import trainer as trainer_module

    monkeypatch.setattr(trainer_module, "TRAIN_GRAPHS", 1)
    loader = _scan_loader([16000, 16000, 12000, 12000, 16000, 12000])
    _, losses1, state1, _ = _scan_fit(_small_quartznet_module, loader, 1)
    trainer, losses2, state2, _ = _scan_fit(_small_quartznet_module, loader, 2)
    assert losses2 == losses1
    _assert_same_state(state2, state1)
    assert (trainer.eager_steps, trainer.replayed_steps) == (1 + 3, 2)  # 16000 graphed; each 12000 step eager


def test_graphed_train_step_replays_after_a_call_on_another_stream(cuda):
    """Steps of a ``GraphedTrainStep`` on the default stream, then on a second stream, then back: the losses and
    weights of the same steps of a ``TrainStep`` on the default stream, and the generator's state too."""
    from chip_smoke import deterministic_algorithms
    from thunder_tpu_torch.training.trainer import GraphedTrainStep, TrainStep, _device_batch, Trainer

    loader = _scan_loader([16000] * 5, seed=1)
    results = []
    for k in (1, 2):
        module = _small_quartznet_module()
        step, generator, _ = Trainer(device="cuda", steps_per_execution=k).train_step_for(module, loader)
        assert isinstance(step, GraphedTrainStep if k == 2 else TrainStep)
        other = torch.cuda.Stream()
        losses = []
        with deterministic_algorithms():
            for i, (audio, lengths, texts) in enumerate(loader):
                batch = _device_batch(module, audio, lengths, texts)
                if i in (2, 3):  # the graphed step orders itself after the last stream's work; the eager one not
                    if k == 1:
                        other.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(other):
                        losses.append(step(*batch, generator))
                    if k == 1:
                        torch.cuda.current_stream().wait_stream(other)
                else:
                    losses.append(step(*batch, generator))
            torch.cuda.synchronize()
        results.append(([loss.item() for loss in losses], {k: v.clone() for k, v in module.model.state_dict().items()},
                        generator.get_state(), getattr(step, "replayed_steps", 0)))
    (losses1, weights1, gen1, _), (losses2, weights2, gen2, replayed) = results
    assert losses2 == losses1 and torch.equal(gen2, gen1) and replayed == 4
    assert all(torch.equal(weights2[name], value) for name, value in weights1.items())


def test_graphed_train_step_survives_cleared_gradients_and_a_loaded_optimizer_state(cuda):
    """With accumulation 2, the gradients cleared (``zero_grad(set_to_none=True)``) between a micro step and its
    update, and the optimizer's state loaded from itself later: the graphed step's losses, weights and generator
    equal the eager step's under the same calls, and the load makes the next step of each kind eager again."""
    from chip_smoke import deterministic_algorithms
    from thunder_tpu_torch.training.trainer import Trainer, _device_batch

    loader = _scan_loader([16000] * 8, seed=2)
    results = []
    for k in (1, 2):
        module = _small_quartznet_module()
        step, generator, _ = Trainer(device="cuda", steps_per_execution=k, accumulate_grad_batches=2).train_step_for(
            module, loader)
        losses = []
        with deterministic_algorithms():
            for i, (audio, lengths, texts) in enumerate(loader):
                if i == 5:  # mid-accumulation: the update sees this batch's gradient alone
                    module.model.zero_grad(set_to_none=True)
                if i == 6:
                    step.optimizer.load_state_dict(step.optimizer.state_dict())
                losses.append(step(*_device_batch(module, audio, lengths, texts), generator))
            torch.cuda.synchronize()
        results.append(([loss.item() for loss in losses], {n: v.clone() for n, v in module.model.state_dict().items()},
                        generator.get_state(), (step.eager_steps, getattr(step, "replayed_steps", 0))))
    (losses1, weights1, gen1, _), (losses2, weights2, gen2, dispatch) = results
    assert losses2 == losses1 and torch.equal(gen2, gen1)
    assert all(torch.equal(weights2[name], value) for name, value in weights1.items())
    assert dispatch == (4, 4)  # micro and update kinds eager at steps 0-1 and again at 6-7, after the load


# ---- the graphed train step on a one-rank NCCL mesh


@pytest.fixture()
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL process group over a ``FileStore`` and its mesh; destroyed after the test."""
    import torch.distributed as dist

    from thunder_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_graphed_mesh_fit_on_card_is_bit_equal_to_the_eager_mesh_and_the_meshless_fit(nccl_mesh, case):
    """``Trainer(mesh=..., steps_per_execution=4)`` against the eager mesh fit (K = 1) and the meshless graphed fit
    (K = 4), in each of the meshless cases (remat, accumulation 2 with the norm clip and ``onecycle``, the
    fine-tuning freeze): per-step losses, the train state (parameters, running statistics, optimizer and generator
    state) and the launches bit-equal; every step past a kind's first (a micro step's without the gradients' sum,
    an update's with it) replays a graph with its collectives in it."""
    loader = _scan_loader([16000] * 5 + [12000] + [16000] * 2, seed=3)
    make, kw, epochs, kinds = _scan_case(case, loader)
    _, losses1, state1, counts1 = _scan_fit(make, loader, 1, epochs, mesh=nccl_mesh, **kw)
    trainer, losses4, state4, counts4 = _scan_fit(make, loader, 4, epochs, mesh=nccl_mesh, **kw)
    meshless, losses_plain, state_plain, counts_plain = _scan_fit(make, loader, 4, epochs, **kw)
    assert losses4 == losses1 == losses_plain and all(np.isfinite(losses1))
    _assert_same_state(state4, state1)
    _assert_same_state(state4, state_plain)
    assert counts4 == counts1 == counts_plain and counts1
    steps = len(loader) * epochs
    assert (trainer.eager_steps, trainer.replayed_steps) == (kinds, steps - kinds)
    assert (meshless.eager_steps, meshless.replayed_steps) == (kinds, steps - kinds)


def test_graphed_rows_step_of_a_larger_data_axis_replays_other_weights_bit_equal_on_card(nccl_mesh):
    """Rank 0 of a data axis larger than the one-rank mesh (the all-reduce over one rank returns the share): 4 local
    rows of a global batch of 8, the last a padding row (weight 0, zero lengths), with another total weight on each
    call and the weighted and the unweighted kind in turns. The graphed ``rows_step`` replays each kind past its
    first step and equals the eager one bit for bit: the factor and the weights are graph inputs, not constants."""
    from chip_smoke import deterministic_algorithms
    from thunder_tpu_torch.training.checkpointing import train_state
    from thunder_tpu_torch.training.trainer import GraphedTrainStep, Trainer, _BATCH_DTYPES

    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((4, 16000)) * 0.2).astype(np.float32)
    lengths = np.array([16000, 15000, 12000, 0], np.int32)
    padded = np.array([1, 1, 1, 0], np.float32)
    calls = [(padded, 6.0), (padded, 7.0), (np.ones(4, np.float32), 8.0), (padded, 5.0), (np.ones(4, np.float32),
                                                                                           9.0), (padded, 6.5)]
    runs = []
    for k in (1, 2):
        module = _small_quartznet_module()
        targets, target_lengths = module.text_transform.encode(["hello world", "the cat", "a dog", ""], pad_to=32)
        batch = tuple(torch.as_tensor(np.asarray(a), dtype=t, device="cuda")
                      for a, t in zip((audio, lengths, targets, target_lengths), _BATCH_DTYPES))
        step, generator, _ = Trainer(device="cuda", steps_per_execution=k, mesh=nccl_mesh).train_step_for(
            module, [None], nccl_mesh)
        with deterministic_algorithms():
            losses = [step.rows_step(batch, weights, total, 8, generator) for weights, total in calls]
            torch.cuda.synchronize()
        runs.append(([loss.item() for loss in losses], train_state(step, generator), step))
    (losses1, state1, _), (losses2, state2, step) = runs
    assert isinstance(step, GraphedTrainStep)
    assert losses2 == losses1 and all(np.isfinite(losses1))
    _assert_same_state(state2, state1)
    assert (step.eager_steps, step.replayed_steps) == (2, len(calls) - 2)


def test_a_mesh_step_whose_capture_fails_raises_on_card(nccl_mesh, monkeypatch):
    """A host read in the forward fails the capture of the kind's graph: the step raises (no eager step takes its
    place), after the kind's one eager step, and no graph is kept."""
    from thunder_tpu_torch.training.trainer import Trainer, _device_batch

    module = _small_quartznet_module()
    forward = module.model.forward

    def reads_the_host(audio, *args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            float(audio.sum())
        return forward(audio, *args, **kwargs)

    monkeypatch.setattr(module.model, "forward", reads_the_host)
    loader = _scan_loader([16000] * 2)
    step, generator, _ = Trainer(device="cuda", steps_per_execution=2, mesh=nccl_mesh).train_step_for(
        module, loader, nccl_mesh)
    batch, weights = _device_batch(module, *loader[0], nccl_mesh)
    with pytest.raises(RuntimeError):
        step(*batch, generator, sample_weights=weights)
    torch.cuda.synchronize()
    assert (step.eager_steps, step.replayed_steps, len(step._graphs)) == (1, 0, 0)
