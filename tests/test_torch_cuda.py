"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a CUDA device).

Each kernel is held against its plain PyTorch version on the same device, with
the check names and tolerances of ``thunder_tpu_torch.kernels.selftest``; a
small QuartzNet and a small wav2vec2 run through the engine on the card and
on the CPU, with the launch counts of one forward; the attention and add +
LayerNorm kernels are held to their plain versions at the wav2vec2-base
serving shape (16 x 15 s: T = 749, 12 heads), with ragged rows and a row of
length 0; the CTC kernel pair is held to its plain loops on the edge case and
at the training shape; and one ``Trainer.fit`` step on the card launches each
kernel of the training path once. The beam scan and backtrace kernels are
held to their plain versions at small shapes (besides their checks at the
serving shapes), and a beam ``predict`` on the card makes one launch of each.

On a machine with an NVIDIA Hopper card and nvcc, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which the port does not need.)
This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from thunder_tpu_torch.kernels.selftest import KERNEL_CHECKS, run_selftests

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
    assert counts == {"fused_log_mel": 0, "fused_separable_repeat": 0, "ctc_alpha": 0, "ctc_beta": 0,
                      "mha_from_qkv": 2, "add_layer_norm": 5, "beam_scan": 0, "beam_backtrace": 0}
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


def test_attention_kernel_rejects_too_long_a_panel(cuda):
    from thunder_tpu_torch.kernels.attention import MAX_FRAMES, mha_from_qkv
    from thunder_tpu_torch.kernels.selftest import attention_case

    qkv, lens = attention_case(25, 1, MAX_FRAMES + 1, 1, [MAX_FRAMES + 1], "cuda")
    with pytest.raises(ValueError, match="frames"):
        mha_from_qkv(qkv, lens, 1)


@pytest.mark.parametrize("rows,d", [(1, 8), (33, 2048), (5, 1024)])
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
    [(3, 100, 24, 40, 4, 1, 1), (2, 77, 8, 8, 87, 1, 2), (5, 129, 520, 136, 7, 2, 1), (1, 1, 64, 256, 33, 2, 1)],
)
def test_separable_repeat_ragged_shapes_on_card(cuda, b, t, c, co, k, stride, dilation):
    from thunder_tpu_torch.kernels.selftest import exact_float32, _separable_check

    exact_float32()
    result = _separable_check(5, b, t, c, co, k, stride, dilation, ragged=True)("cuda")
    assert result["max_err"] <= 8.0, result


@pytest.mark.parametrize("time,win,n_mels", [(12345, 320, 64), (8000, 400, 80)])
def test_log_mel_other_configs_on_card(cuda, time, win, n_mels):
    from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_reference
    from thunder_tpu_torch.kernels.selftest import exact_float32

    exact_float32()
    audio = torch.as_tensor(np.random.default_rng(3).standard_normal((3, time)).astype(np.float32) * 0.3, device="cuda")
    got = fused_log_mel(audio, win_length=win, n_mels=n_mels)
    want = log_mel_reference(audio, win_length=win, n_mels=n_mels)
    assert got.shape == want.shape == (3, time // 160 + 1, n_mels)
    assert (got - want).abs().max().item() <= 2e-3


@pytest.mark.parametrize("case", ["edge", "training_shape"])
def test_ctc_kernels_match_plain_versions_on_card(cuda, case):
    """Forward (alpha, ll) and gradient of the kernel pair against the plain loops on the card."""
    from thunder_tpu_torch.kernels.ctc import alpha_reference, beta_reference, ctc_alpha, ctc_beta, ll_from_alpha
    from thunder_tpu_torch.kernels.selftest import ctc_edge_case, ctc_training_case
    from thunder_tpu_torch.ops.ctc import extended_emissions

    if case == "edge":
        logits, targets, lens, tl = ctc_edge_case("cuda")
    else:  # QuartzNet15x5 training: T = 751, V = 29, targets padded to 64 labels (S = 129)
        logits, targets, lens, tl = ctc_training_case(12, 16, 751, 29, 64, "cuda")
    lp_z, skip_ok = extended_emissions(torch.log_softmax(logits, dim=-1), targets, blank=0)
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
    assert counts == {"fused_log_mel": 1, "fused_separable_repeat": 0, "ctc_alpha": 1, "ctc_beta": 1,
                      "mha_from_qkv": 0, "add_layer_norm": 0, "beam_scan": 0, "beam_backtrace": 0}
    assert np.isfinite(trainer.logs[0]["loss/train_loss"])
    assert trained.device.type == "cuda"


@pytest.mark.parametrize(
    "b,t,v,width,k,floor,carried",
    [(3, 29, 9, 8, 9, -12.0, False), (3, 23, 40, 6, 7, -10.0, False), (2, 21, 9, 1, 9, -12.0, False),
     (2, 12, 8, 6, 8, -2.0, False), (2, 19, 9, 5, 9, -12.0, True), (5, 64, 29, 40, 29, -12.0, False)],
)
def test_beam_kernels_match_plain_versions_at_small_shapes(cuda, b, t, v, width, k, floor, carried):
    """K = V and K < V, a beam of one, frames the floor empties (flat frames), a carried state, W above a warp."""
    from thunder_tpu_torch.kernels.beam import (
        beam_backtrace,
        beam_backtrace_reference,
        beam_scan,
        beam_scan_reference,
    )

    rng = np.random.default_rng(31)
    logits = torch.as_tensor(rng.normal(0, 2, (b, t, v)).astype(np.float32), device="cuda")
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
