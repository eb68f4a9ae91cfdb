"""The port's log-mel frontend against the JAX package on the CPU.

On the CPU the ``fused_log_mel`` wrapper runs its plain version; it is held
against the JAX Pallas kernel in interpret mode and against the JAX XLA
pipeline at 2e-3 absolute (the on-chip ``frontend_log_mel`` tolerance), at
the path's default and at 44.1 kHz (hop 441, n_fft 2048), 48 kHz (hop 480,
win 1200), hop 161 and the dense path's n_fft 400; at n_fft 32,768 and
20,000 (the card kernel's wide path) against the XLA pipeline through
``jnp.fft.rfft``. The whole ``FilterbankFeatures`` module is held at 1e-4
(float32 on both sides).

The kernel's host tables are checked here (the mel bands against the dense
filterbank, the twiddles against numpy's float64 exponentials), and so is a
numpy model of its FFT path (:func:`fft_path_model`: the span load with the
preemphasis and the reflect pad, the packing, the Stockham stages in the
kernel's order of radices, the split step and the band sums, with the
kernel's indexing), so that an index error shows before the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.kernels.frontend_pallas import fused_log_mel as jax_fused_log_mel
from thunder_tpu.ops.stft import mel_features as jax_mel_features
from thunder_tpu.ops.stft import preemphasis as jax_preemphasis
from thunder_tpu_torch.audio import FilterbankFeatures
from thunder_tpu_torch.kernels.frontend import (
    fft_twiddles,
    fused_log_mel,
    log_mel_frames,
    log_mel_reference,
    mel_bands,
    packed_tables,
)
from thunder_tpu_torch.ops.stft import hann_window, mel_filterbank, next_pow2

torch.set_num_threads(2)


@pytest.mark.parametrize("time", [16000, 12345, 170 * 160])
def test_fused_log_mel_matches_jax_kernel_and_xla(time):
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((2, time)) * 0.3).astype(np.float32)
    got = fused_log_mel(torch.as_tensor(audio)).numpy()
    kernel = np.asarray(jax_fused_log_mel(jnp.asarray(audio), interpret=True))
    xla = np.asarray(jax_mel_features(jax_preemphasis(jnp.asarray(audio)), 16000, 512, 160, 320, 64))
    assert got.shape == kernel.shape == xla.shape == (2, time // 160 + 1, 64)
    np.testing.assert_allclose(got, kernel, atol=2e-3, rtol=0)
    np.testing.assert_allclose(got, xla, atol=2e-3, rtol=0)


def test_fused_log_mel_other_config():
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((1, 8000)) * 0.3).astype(np.float32)
    got = fused_log_mel(torch.as_tensor(audio), win_length=400, n_mels=80).numpy()
    want = np.asarray(jax_fused_log_mel(jnp.asarray(audio), win_length=400, n_mels=80, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_filterbank_matches_jax_module(sample_audio):
    audio, lengths = sample_audio
    jax_mod = JaxFilterbank(use_fused_kernel=False)
    want, want_len = jax_mod.apply({}, jnp.asarray(audio), jnp.asarray(lengths), train=False)
    got, got_len = FilterbankFeatures()(torch.as_tensor(audio), torch.as_tensor(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # padding frames are exactly zero after the masked normalization
    assert not got[3, int(got_len[3]) :].any()


def test_filterbank_zero_length_row():
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32)
    lengths = np.array([4000, 0], np.int32)
    want, want_len = JaxFilterbank(use_fused_kernel=False).apply({}, jnp.asarray(audio), jnp.asarray(lengths))
    got, got_len = FilterbankFeatures()(torch.as_tensor(audio), torch.as_tensor(lengths))
    assert got_len.tolist() == np.asarray(want_len).tolist() == [26, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_filterbank_train_mode_is_not_ported_yet():
    """Train mode is ported now (``tests/test_torch_training.py`` holds it to JAX);
    what stays refused is drawing its randomness from anything but an explicit generator."""
    with pytest.raises(ValueError, match="generator"):
        FilterbankFeatures()(torch.zeros(1, 1600), torch.tensor([1600]), train=True)
    with pytest.raises(ValueError, match="generator"):
        FilterbankFeatures(dither=0.0, num_time_masks=1)(torch.zeros(1, 1600), torch.tensor([1600]), train=True)
    with pytest.raises(ValueError, match="no backward"):
        fused_log_mel(torch.zeros(1, 1600, requires_grad=True))


def test_fused_log_mel_refuses_what_it_cannot_run():
    with pytest.raises(ValueError):
        fused_log_mel(torch.zeros(2, 1600, dtype=torch.float64))
    with pytest.raises(ValueError):
        fused_log_mel(torch.zeros(1600))
    # neither CPU nor CUDA: raise, never compute elsewhere
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_log_mel(torch.zeros(2, 1600, device="meta"))


#: the other configurations: (sample_rate, hop, win, n_fft or None for next_pow2(win), n_mels)
OTHER_CONFIGS = {
    "44k1_hop441_n2048": (44100, 441, 1103, 2048, 64),
    "48k_hop480_win1200": (48000, 480, 1200, None, 64),
    "16k_hop161": (16000, 161, 320, 512, 64),
    "16k_dense_n400": (16000, 160, 400, 400, 80),
}


@pytest.mark.parametrize("name", sorted(OTHER_CONFIGS))
def test_other_configs_match_jax_kernel_xla_and_module(name):
    """About 1 s of audio a row at each configuration: the wrapper against the JAX kernel (interpret mode)
    and its XLA pipeline at 2e-3, the module against the JAX module at 1e-4."""
    sr, hop, win, n_fft, n_mels = OTHER_CONFIGS[name]
    fft = n_fft or next_pow2(win)
    rng = np.random.default_rng(4)
    time = sr + 37
    audio = (rng.standard_normal((2, time)) * 0.3).astype(np.float32)
    kw = dict(sample_rate=sr, n_fft=fft, hop_length=hop, win_length=win, n_mels=n_mels)
    got = fused_log_mel(torch.as_tensor(audio), **kw).numpy()
    kernel = np.asarray(jax_fused_log_mel(jnp.asarray(audio), interpret=True, **kw))
    xla = np.asarray(jax_mel_features(jax_preemphasis(jnp.asarray(audio)), sr, fft, hop, win, n_mels))
    assert got.shape == kernel.shape == xla.shape == (2, time // hop + 1, n_mels)
    np.testing.assert_allclose(got, kernel, atol=2e-3, rtol=0)
    np.testing.assert_allclose(got, xla, atol=2e-3, rtol=0)

    lengths = np.array([time, time // 2], np.int32)
    mod_kw = dict(sample_rate=sr, n_window_size=win, n_window_stride=hop, n_fft=n_fft, nfilt=n_mels)
    want, want_len = JaxFilterbank(use_fused_kernel=False, **mod_kw).apply({}, jnp.asarray(audio), jnp.asarray(lengths))
    module = FilterbankFeatures(**mod_kw)
    feats, feat_len = module(torch.as_tensor(audio), torch.as_tensor(lengths))
    np.testing.assert_array_equal(feat_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(feats.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("sr,n_fft,n_mels", [(16000, 512, 64), (16000, 400, 80), (44100, 2048, 64), (8000, 32, 20)])
def test_mel_bands_reproduce_the_dense_filterbank(sr, n_fft, n_mels):
    bands, weights = mel_bands(n_fft, n_mels, sr)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sr)
    assert bands.shape == (3, n_mels) and bands.dtype == np.int32 and weights.dtype == np.float32
    first, count, offset = bands
    assert (np.diff(offset) == count[:-1]).all() and offset[-1] + count[-1] == weights.size
    assert weights.size < fb.size / 4  # each bin lies in at most two slaney triangles
    power = np.random.default_rng(5).random((7, n_fft // 2 + 1)).astype(np.float32)
    banded = np.stack([power[:, f:f + c] @ weights[o:o + c] for f, c, o in zip(first, count, offset)], axis=1)
    want = power.astype(np.float64) @ fb.astype(np.float64)
    np.testing.assert_allclose(banded, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_fft", [32, 512, 2048, 4096])
def test_fft_twiddles_are_float64_exponentials_cast_to_float32(n_fft):
    want = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft).astype(np.complex64)
    table = fft_twiddles(n_fft)
    assert table.shape == (n_fft, 2) and table.dtype == np.float32
    np.testing.assert_array_equal(table[:, 0], want.real)
    np.testing.assert_array_equal(table[:, 1], want.imag)


def test_packed_tables_hold_each_part_padded_to_16_bytes():
    tables = packed_tables(16000, 512, 320, 64)
    bands, weights = mel_bands(512, 64, 16000)
    parts = [fft_twiddles(512).ravel(), hann_window(320), bands.ravel().view(np.float32), weights]
    offset = 0
    for part in parts:
        np.testing.assert_array_equal(tables[offset:offset + part.size].view(np.uint32), part.view(np.uint32))
        offset += -(-part.size // 4) * 4
    assert tables.dtype == np.float32 and tables.size == offset
    dense = packed_tables(16000, 400, 400, 80)  # no twiddles or window: the dense path reads its basis
    assert dense.size == -(-3 * 80 // 4) * 4 + -(-mel_bands(400, 80, 16000)[1].size // 4) * 4


def fft_path_model(audio, sample_rate, n_fft, hop, win, n_mels, preemph=0.97):
    """``csrc/log_mel.cu``'s FFT path in numpy float32, tile by tile with the kernel's indexing."""
    f32, c64 = np.float32, np.complex64
    batch, time = audio.shape
    n_frames = log_mel_frames(time, n_fft, hop)
    ft = min(64, 4096 // (n_fft // 2))  # the plan's frames a tile wherever the span fits, as at these sizes
    m, lpad = n_fft // 2, (n_fft - win) // 2
    log_m = m.bit_length() - 1
    table = fft_twiddles(n_fft)
    tw = (table[:, 0] + 1j * table[:, 1]).astype(c64)
    window = hann_window(win)
    bands, weights = mel_bands(n_fft, n_mels, sample_rate)
    out = np.zeros((batch, n_frames, n_mels), f32)
    for b in range(batch):
        x = audio[b]
        for f0 in range(0, n_frames, ft):
            # the span: preemphasis and the reflect pad on the load, 0 past the padded end
            p = f0 * hop + lpad + np.arange((ft - 1) * hop + win)
            j = p - m
            j = np.where(j < 0, -j, np.where(j >= time, 2 * (time - 1) - j, j))
            inside = p < time + 2 * m
            j = np.where(inside, j, 0)
            y = np.where(j == 0, x[0], x[j] - f32(preemph) * x[np.maximum(j - 1, 0)])
            span = np.where(inside, y, 0).astype(f32)
            # the first stage's loads: z[i] = w x[2i] + i w x[2i+1] over the window's samples only
            n = np.arange(n_fft) - lpad
            ok = (n >= 0) & (n < win)
            frames = np.zeros((ft, n_fft), f32)
            for f in range(ft):
                frames[f, ok] = window[n[ok]] * span[f * hop + n[ok]]
            src = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(c64)
            ns = 1
            for radix in {0: [], 1: [2], 2: [4], 3: [2, 4]}[log_m % 4] + [16] * (log_m // 4):
                q = m // radix
                jb = np.arange(q)
                jj = jb % ns
                v = np.stack([src[:, jb + r * q] * tw[(r * jj) * (n_fft // (ns * radix))] for r in range(radix)], -1)
                dft = np.exp(-2j * np.pi * np.outer(np.arange(radix), np.arange(radix)) / radix).astype(c64)
                v = v @ dft  # (ft, q, R): the R-point DFT of each butterfly
                dst = np.empty_like(src)
                base = (jb // ns) * ns * radix + jj
                for r in range(radix):
                    dst[:, base + r * ns] = v[..., r]
                src, ns = dst, ns * radix
            # the split step: bins 0..N/2 of the real FFT
            k = np.arange(m + 1)
            zk, zc = src[:, k % m], np.conj(src[:, (m - k) % m])
            x_k = c64(0.5) * (zk + zc) + tw[k] * (c64(-0.5j) * (zk - zc))
            power = (x_k.real * x_k.real + x_k.imag * x_k.imag).astype(f32)
            rows = min(ft, n_frames - f0)
            for mel, (first, count, off) in enumerate(bands.T):
                acc = power[:rows, first:first + count] @ weights[off:off + count]
                out[b, f0:f0 + rows, mel] = np.log(acc + f32(2.0**-24))
    return out


@pytest.mark.parametrize("n_fft,hop,win,time,n_mels", [(32, 160, 32, 1000, 20), (32, 160, 20, 100, 20),
                                                       (512, 160, 320, 4000, 64), (2048, 441, 1103, 8000, 64)])
def test_numpy_model_of_the_fft_path_matches_the_plain_version(n_fft, hop, win, time, n_mels):
    """Held in mel energy to 1e-5 of each frame's largest: float32 rounds both sides to about 5e-7 of it,
    while the preemphasis leaves the lowest bands some 30 dB under the peak, so that their log differs by
    up to 2e-5 between any two float32 orders of summation; an index error moves a band by far more."""
    audio = (np.random.default_rng(6).standard_normal((2, time)) * 0.3).astype(np.float32)
    got = fft_path_model(audio, 16000, n_fft, hop, win, n_mels)
    want = log_mel_reference(torch.as_tensor(audio), 16000, n_fft, hop, win, n_mels).numpy()
    assert got.shape == want.shape == (2, time // hop + 1, n_mels)
    scale = np.exp(want).max(axis=-1, keepdims=True)
    assert (np.abs(np.exp(got) - np.exp(want)) / scale).max() < 1e-5
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_fused_log_mel_refuses_short_clips_as_the_plain_version_does():
    with pytest.raises(RuntimeError, match="[Pp]adding"):
        fused_log_mel(torch.zeros(1, 256))
    assert fused_log_mel(torch.zeros(1, 257)).shape == (1, 2, 64)


@pytest.mark.parametrize("n_fft,win,hop,n_mels", [(32768, 2048, 4096, 128), (20000, 1200, 480, 80)])
def test_plain_log_mel_at_a_large_fft_matches_jax_xla(n_fft, win, hop, n_mels):
    """C16: an FFT size past the card kernel's one-block tile (its "wide" path) through the plain version, which
    multiplies each frame's windowed samples only, against the JAX package's XLA pipeline through
    ``jnp.fft.rfft`` (its windowed-basis product would need an (n_fft, n_fft + 2) table), at the kernel's 2e-3."""
    rng = np.random.default_rng(n_fft)
    audio = (rng.standard_normal((2, 3 * n_fft // 2 + 123)) * 0.3).astype(np.float32)
    got = fused_log_mel(torch.as_tensor(audio), n_fft=n_fft, hop_length=hop, win_length=win, n_mels=n_mels).numpy()
    want = np.asarray(jax_mel_features(jax_preemphasis(jnp.asarray(audio)), 16000, n_fft, hop, win, n_mels,
                                       method="fft"))
    assert got.shape == want.shape == (2, log_mel_frames(audio.shape[1], n_fft, hop), n_mels)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
