"""thunder_tpu_torch.ops against thunder_tpu.ops: same numpy inputs, float32, CPU.

Both sides use full-precision float32 matmuls and convolutions, so the bound
is float32 reduction-order noise: atol 1e-5, and 1e-4 on log-mel values.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.data.collate import bucket_length as jax_bucket_length
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu_torch.data.collate import bucket_length
from thunder_tpu_torch.ops import conv as tconv
from thunder_tpu_torch.ops import ctc as tctc
from thunder_tpu_torch.ops import masking as tmask
from thunder_tpu_torch.ops import stft as tstft
from thunder_tpu_torch.text import BatchTextTransformer

# the package namespace re-exports functions named like its modules (ops.stft)
jconv, jctc, jmask, jstft = (importlib.import_module(f"thunder_tpu.ops.{m}") for m in ("conv", "ctc", "masking", "stft"))

torch.set_num_threads(2)

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("max_length", [1, 7, 13])
def test_lengths_to_mask(max_length):
    lengths = np.array([0, 3, 7, 13], np.int32)
    got = tmask.lengths_to_mask(_t(lengths), max_length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmask.lengths_to_mask(jnp.asarray(lengths), max_length)))


@pytest.mark.parametrize("time_axis,fill", [(1, 0.0), (1, -3.0), (2, 0.0)])
def test_apply_mask(time_axis, fill):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 6)).astype(np.float32)
    lengths = np.array([5, 2, 0], np.int32)
    want = jmask.apply_mask(jnp.asarray(x), jnp.asarray(lengths), time_axis=time_axis, fill_value=fill)
    _close(tmask.apply_mask(_t(x), _t(lengths), time_axis=time_axis, fill_value=fill), want)


@pytest.mark.parametrize("masked", [True, False])
def test_normalize_tensor(masked):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 40, 8)) * 2.0 + 0.5).astype(np.float32)
    lengths = np.array([40, 17, 1], np.int32)
    mask = np.arange(40)[None, :, None] < lengths[:, None, None] if masked else None
    want = jmask.normalize_tensor(jnp.asarray(x), None if mask is None else jnp.asarray(mask), div_guard=1e-5, axis=1)
    got = tmask.normalize_tensor(_t(x), None if mask is None else _t(mask), div_guard=1e-5, axis=1)
    _close(got, want, atol=1e-4)


def test_masked_mean_std():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 30, 4)).astype(np.float32)
    mask = np.arange(30)[None, :, None] < np.array([30, 11])[:, None, None]
    want = jmask.masked_mean_std(jnp.asarray(x), jnp.asarray(mask), axis=1)
    got = tmask.masked_mean_std(_t(x), _t(mask), axis=1)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("k,s,d", [(33, 2, 1), (33, 1, 1), (87, 1, 2), (1, 1, 1), (4, 1, 1)])
def test_same_padding_and_output_length(k, s, d):
    assert tconv.get_same_padding(k, s, d) == jconv.get_same_padding(k, s, d)
    pad = tconv.get_same_padding(k, s, d)
    lengths = np.array([0, 1, 2, 99, 751, 1501], np.int32)
    want = np.asarray(jconv.conv_output_length(jnp.asarray(lengths), k, s, pad, d))
    np.testing.assert_array_equal(tconv.conv_output_length(_t(lengths), k, s, pad, d).numpy(), want)
    np.testing.assert_array_equal(tconv.conv_output_length(lengths, k, s, pad, d), want)
    assert tconv.conv_output_length(1501, k, s, pad, d) == want[-1]


def test_same_padding_rejects_stride_and_dilation():
    with pytest.raises(ValueError):
        tconv.get_same_padding(3, 2, 2)


@pytest.mark.parametrize(
    "k,stride,dilation,groups,bias",
    [(5, 1, 1, 1, False), (33, 2, 1, 1, True), (87, 1, 2, 1, False), (33, 1, 1, 6, False), (13, 2, 1, 6, True)],
)
def test_conv1d(k, stride, dilation, groups, bias):
    rng = np.random.default_rng(3)
    c_in, c_out = 6, 6 if groups > 1 else 10
    x = rng.standard_normal((2, 180, c_in)).astype(np.float32)
    w = (rng.standard_normal((k, c_in // groups, c_out)) * 0.2).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32) if bias else None
    pad = tconv.get_same_padding(k, stride, dilation)
    kw = dict(stride=stride, padding=pad, dilation=dilation, groups=groups)
    want = jconv.conv1d(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b), **kw)
    got = tconv.conv1d(_t(x), _t(w), None if b is None else _t(b), **kw)
    assert got.shape == want.shape
    _close(got, want)


def test_preemphasis_and_power_spectrum():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32)
    _close(tstft.preemphasis(_t(x)), jstft.preemphasis(jnp.asarray(x)))
    want = jstft.power_spectrum(jnp.asarray(x), 512, 160, 320)
    got = tstft.power_spectrum(_t(x), 512, 160, 320)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("time,win,n_mels", [(16000, 320, 64), (12345, 320, 64), (8000, 400, 80)])
def test_mel_features(time, win, n_mels):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, time)) * 0.3).astype(np.float32)
    pre = jstft.preemphasis(jnp.asarray(x))
    want = jstft.mel_features(pre, 16000, 512, 160, win, n_mels)
    got = tstft.mel_features(tstft.preemphasis(_t(x)), 16000, 512, 160, win, n_mels)
    assert got.shape == want.shape
    _close(got, want, atol=1e-4)


def test_power_spectrum_lengths_zero_maps_to_zero():
    lengths = np.array([0, 1, 159, 160, 16000, 12345], np.int32)
    want = np.asarray(jstft.power_spectrum_lengths(jnp.asarray(lengths), 160))
    got = tstft.power_spectrum_lengths(_t(lengths), 160)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0 and got.dtype == torch.int32


def test_numpy_helpers_are_the_same():
    np.testing.assert_array_equal(tstft.mel_filterbank(257, 64, 16000), jstft.mel_filterbank(257, 64, 16000))
    np.testing.assert_array_equal(tstft.hann_window(320), jstft.hann_window(320))
    for a, b in zip(tstft._rdft_basis(512), jstft._rdft_basis(512)):
        np.testing.assert_array_equal(a, b)
    assert tstft.next_pow2(320) == jstft.next_pow2(320) == 512


def test_greedy_decode_and_collapse():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 20, 5)).astype(np.float32)
    ids = tctc.greedy_decode(_t(logits))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jctc.greedy_decode(jnp.asarray(logits))))
    lengths = np.array([20, 7, 0])
    for g, w in zip(tctc.collapse_ctc(ids.numpy(), lengths), jctc.collapse_ctc(np.asarray(ids), lengths)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 16000, 16001, 240000])
def test_bucket_length(n):
    assert bucket_length(n, 16000) == jax_bucket_length(n, 16000)


@pytest.mark.parametrize(
    "specials", [{}, dict(unknown_token="?", start_token="<s>", end_token="</s>"), dict(pad_token="<pad>")]
)
def test_text_transform_matches_jax(specials):
    tokens = list("abcdefghijklmnopqrstuvwxyz '")
    port, ref = BatchTextTransformer(tokens, **specials), JaxText(tokens, **specials)
    assert port.vocab.itos == ref.vocab.itos and port.vocab.blank_idx == ref.vocab.blank_idx
    texts = ["hello world", "", "it's 9 o'clock"]
    for got, want in zip(port.encode(texts), ref.encode(texts)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.encode(texts, pad_to=20, return_length=False), ref.encode(texts, pad_to=20, return_length=False))
    with pytest.raises(ValueError):
        port.encode(texts, pad_to=3)
    ids = np.random.default_rng(7).integers(0, port.num_tokens, size=(4, 30))
    for remove_repeated in (True, False):
        assert port.decode_prediction(ids, remove_repeated) == ref.decode_prediction(ids, remove_repeated)
