"""The port's FLOPs accounting (``thunder_tpu_torch/flops.py``) against the JAX package's (CPU).

- Every analytic counter gives the JAX package's integer, at ``tests/test_flops.py``'s arguments and at
  wav2vec2-large-960h's widths (hidden 1024, 24 layers, FFN 4096): 9.51 TFLOP forward at 16 x 15 s, 10.40 at
  8 x 30 s, 13.09 for a step at 8 x 15 s with the extractor frozen.
- ``counted_flops`` (PyTorch's ``FlopCounterMode``) stands where the JAX tests put ``xla_flops``: the analytic
  count of the port's float32 forward must lie at or below it (within 0.1 %) and above 0.85 of it for QuartzNet
  with its frontend, 0.80 for the bare wav2vec2 and Citrinet encoders, the relations ``tests/test_flops.py``
  asserts against XLA's count. The counter sees nothing inside a custom op, so QuartzNet's frontend runs its
  plain log-mel here (``use_fused_kernel=False``: the products that the op's CPU implementation runs); its
  count is pinned apart, since its product contracts over the 320 window samples where the analytic count
  takes all 512 of ``n_fft``.
- ``peak_flops`` reads ``THUNDER_PEAK_TFLOPS`` and is None on the CPU; ``mfu`` divides by it.
"""

import numpy as np
import pytest
import torch

import thunder_tpu.flops as jax_flops
import thunder_tpu_torch.flops as flops

torch.set_num_threads(2)

LARGE = dict(hidden_size=1024, num_hidden_layers=24, intermediate_size=4096)
SMALL_W2V = dict(hidden_size=192, num_hidden_layers=2, intermediate_size=384, conv_dim=(64,) * 7)
CITRINET_SMALL = dict(filters=(64, 64, 128), kernel_sizes=(11, 13, 15), strides=(2, 1, 2), repeat=2)
SECONDS_15 = 240000

CASES = [
    ("dense_flops", (64, 128, 10), {}),
    ("conv1d_flops", (3, 64, 64, 100), {"groups": 64}),
    ("conv1d_flops", (1, 256, 512, 50), {"batch": 4}),
    ("filterbank_flops", (16000,), {"batch": 2}),
    ("filterbank_flops", (SECONDS_15,), {"nfilt": 80, "batch": 16}),
    ("quartznet_forward_flops", (101,), {"repeat_blocks": 1, "batch": 2}),
    ("quartznet_forward_flops_split", (1501,), {"batch": 64, "repeat_blocks": 3}),
    ("quartznet_forward_flops_split", (751,), {"batch": 16, "repeat_blocks": 1}),
    ("quartznet_train_flops", (SECONDS_15,), {"repeat_blocks": 3}),
    ("citrinet_forward_flops", (101,), {**CITRINET_SMALL, "num_classes": 0, "batch": 2}),
    ("citrinet_forward_flops_split", (1501,), {"num_classes": 29, "batch": 16}),
    ("citrinet_train_flops", (SECONDS_15,), {"num_classes": 29, "batch": 16}),
    ("wav2vec2_forward_flops", (16000,), {**SMALL_W2V, "num_classes": 0, "batch": 2}),
    ("wav2vec2_forward_flops", (SECONDS_15,), {"batch": 16}),
    ("wav2vec2_forward_flops", (SECONDS_15,), {**LARGE, "batch": 16}),
    ("wav2vec2_forward_flops", (2 * SECONDS_15,), {**LARGE, "batch": 8}),
    ("wav2vec2_extractor_flops", (SECONDS_15,), {"batch": 16}),
    ("wav2vec2_train_flops", (SECONDS_15,), {"batch": 8}),
    ("wav2vec2_train_flops", (SECONDS_15,), {**LARGE, "batch": 8, "frozen_extractor": True}),
    ("wav2vec2_train_flops", (SECONDS_15,), {**LARGE, "batch": 8, "frozen_extractor": False}),
]


@pytest.mark.parametrize("name,args,kwargs", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_counter_gives_the_jax_integer(name, args, kwargs):
    got, want = getattr(flops, name)(*args, **kwargs), getattr(jax_flops, name)(*args, **kwargs)
    assert got == want
    assert all(type(g) is int for g in (got if isinstance(got, tuple) else (got,)))


def test_citrinet_256_constants_are_the_jax_packages():
    assert flops.CITRINET_256_FILTERS == jax_flops.CITRINET_256_FILTERS
    assert flops.CITRINET_256_KERNELS == jax_flops.CITRINET_256_KERNELS
    assert flops.CITRINET_256_STRIDES == jax_flops.CITRINET_256_STRIDES


def test_wav2vec2_large_960h_sizes():
    """The sizes the card's wav2vec2-large phases report their MFU against, in TFLOP."""
    tflop = lambda n: round(n / 1e12, 2)  # noqa: E731
    assert tflop(flops.wav2vec2_forward_flops(SECONDS_15, **LARGE, batch=16)) == 9.51
    assert tflop(flops.wav2vec2_forward_flops(2 * SECONDS_15, **LARGE, batch=8)) == 10.40
    assert tflop(flops.wav2vec2_train_flops(SECONDS_15, **LARGE, batch=8, frozen_extractor=True)) == 13.09
    assert tflop(flops.wav2vec2_extractor_flops(SECONDS_15, batch=16)) == 1.18


def test_primitives_equal_the_counted_flops():
    """A convolution's count includes its padded taps, as the formula does; a product's is exact."""
    x, w = torch.zeros(2, 64, 100), torch.zeros(128, 64, 3)
    conv = lambda x, w: torch.nn.functional.conv1d(x, w, padding=1)  # noqa: E731
    assert flops.counted_flops(conv, x, w) == flops.conv1d_flops(3, 64, 128, 100, batch=2)
    a, b = torch.zeros(50, 64), torch.zeros(64, 32)
    assert flops.counted_flops(torch.matmul, a, b) == flops.dense_flops(64, 32, 50)


def _within(analytic: int, counted: int, floor: float) -> None:
    assert analytic <= counted * 1.001, (analytic, counted)
    assert analytic >= floor * counted, (analytic, counted)


def test_quartznet_analytic_vs_counted():
    """The encoder and decoder under the relation; the frontend's count pinned apart: the port's windowed-DFT
    product contracts over the window's ``win_length`` samples (its basis is zero elsewhere), where
    ``filterbank_flops`` counts all ``n_fft``, so the frontend runs fewer FLOPs than its analytic count."""
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule

    frontend = FilterbankFeatures(dither=0.0, use_fused_kernel=False)
    model = CTCModule.create(torch.Generator().manual_seed(0), frontend, QuartznetEncoder(repeat_blocks=1),
                             Conv1dDecoder(29), device="cpu").model
    batch, samples = 2, 16000
    audio, lengths = torch.zeros(batch, samples), torch.full((batch,), samples, dtype=torch.int32)
    frames, bins = samples // 160 + 1, 512 // 2 + 1
    with torch.no_grad():
        feats, feat_lengths = model.audio_transform(audio, lengths)
        counted_frontend = flops.counted_flops(model.audio_transform, audio, lengths)
        counted = flops.counted_flops(lambda f, n: model.decoder(model.encoder(f, n)[0]), feats, feat_lengths)
    assert counted_frontend == batch * (flops.dense_flops(320, 2 * bins, frames) + flops.dense_flops(bins, 64, frames))
    assert counted_frontend < flops.filterbank_flops(samples, batch=batch)
    _within(flops.quartznet_forward_flops(frames, repeat_blocks=1, batch=batch), counted, 0.85)


def test_wav2vec2_analytic_vs_counted():
    from thunder_tpu_torch.models import Wav2Vec2Config, Wav2Vec2Encoder

    encoder = Wav2Vec2Encoder(Wav2Vec2Config(**{k: v for k, v in SMALL_W2V.items()}, num_attention_heads=4)).eval()
    batch, samples = 2, 16000
    audio = torch.as_tensor(np.random.default_rng(0).standard_normal((batch, samples)).astype(np.float32))
    with torch.no_grad():
        counted = flops.counted_flops(encoder, audio, torch.full((batch,), samples, dtype=torch.int32))
    analytic = flops.wav2vec2_forward_flops(samples, **SMALL_W2V, num_classes=0, batch=batch)
    _within(analytic, counted, 0.80)


def test_citrinet_analytic_vs_counted():
    from thunder_tpu_torch.models import CitrinetEncoder

    encoder = CitrinetEncoder(**CITRINET_SMALL, feat_in=80).eval()
    batch, frames = 2, 101
    with torch.no_grad():
        counted = flops.counted_flops(encoder, torch.zeros(batch, frames, 80),
                                      torch.full((batch,), frames, dtype=torch.int32))
    analytic = flops.citrinet_forward_flops(frames, **CITRINET_SMALL, num_classes=0, batch=batch)
    _within(analytic, counted, 0.80)


def test_peak_and_mfu(monkeypatch):
    monkeypatch.delenv("THUNDER_PEAK_TFLOPS", raising=False)
    assert flops.peak_flops("cpu") is None
    assert flops.mfu(50e12, 1.0, peak=None if torch.cuda.is_available() else flops.peak_flops()) is None
    monkeypatch.setenv("THUNDER_PEAK_TFLOPS", "100")
    assert flops.peak_flops() == 100e12 and flops.peak_flops("cpu") == 100e12
    # 50 TFLOPs of work in 1 s on a 100 TFLOPS card -> 0.5
    assert flops.mfu(50e12, 1.0) == pytest.approx(0.5)
    assert flops.mfu(50e12, 0.0) is None
    assert flops.mfu(50e12, 2.0, peak=989e12) == pytest.approx(50e12 / 2.0 / 989e12)


def test_peak_of_an_h100_by_its_name(monkeypatch):
    """The card's entry, keyed by ``torch.cuda.get_device_name``: the H100 SXM's dense bf16 989 TFLOP/s."""
    monkeypatch.delenv("THUNDER_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.peak_flops("cuda:0") == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert flops.peak_flops("cuda:0") is None
