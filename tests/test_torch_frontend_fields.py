"""The frontend's remaining options in the port against the JAX package (CPU, float32).

- ``stft(method="matmul" | "fft")``, ``convolution_stft``, ``power_spectrum`` and
  ``mel_features`` with each method: within 1e-4 of the JAX functions
  (absolute, on spectra of unit-scale audio; 2e-3 on the log-mel, the
  on-chip ``frontend_log_mel`` tolerance); the two methods within 1e-3 of each
  other.
- ``masked_feature_normalize``: within 1e-5 of the JAX function, zero past each
  row's length.
- ``FilterbankFeatures`` with ``stft_method``, ``use_fused_kernel``,
  ``dft_precision`` and ``dtype``: each setting within 1e-4 of the JAX module
  with the same fields (the port's plain path when ``use_fused_kernel=False``,
  the kernel's plain version otherwise); ``dft_precision`` refused with the JAX
  message; a NeMo config whose ``augment_params`` set the fields and an
  inference bundle whose ``config.json`` sets them build the same frontend.
"""

import importlib
import json
import tarfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu_torch import export
from thunder_tpu_torch.audio import FilterbankFeatures
from thunder_tpu_torch.compat import nemo
from thunder_tpu_torch.ops import masking, stft

# the JAX package's namespace re-exports functions named like its modules (ops.stft)
jax_masking, jax_stft = (importlib.import_module(f"thunder_tpu.ops.{m}") for m in ("masking", "stft"))

torch.set_num_threads(2)

FIELDS = {
    "plain_matmul": dict(use_fused_kernel=False, stft_method="matmul"),
    "plain_fft": dict(use_fused_kernel=False, stft_method="fft"),
    "fused": dict(use_fused_kernel=None, dft_precision="highest"),
    "default_3x": dict(dft_precision="3x"),
    "bf16_out": dict(use_fused_kernel=False, dtype="bfloat16"),
}


def _audio(seed=0, time=12345):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, time)) * 0.3).astype(np.float32), np.array([time, 7000], np.int32)


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("n_fft,hop,win", [(512, 160, 320), (400, 160, 400), (2048, 441, 1764)])
def test_stft_methods_match_jax(method, n_fft, hop, win):
    audio, _ = _audio(1)
    x, xt = jnp.asarray(audio), torch.as_tensor(audio)
    want = jax_stft.stft(x, n_fft, hop, win, method=method)
    got = stft.stft(xt, n_fft, hop, win, method=method)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    other = stft.stft(xt, n_fft, hop, win, method="fft" if method == "matmul" else "matmul")
    for g, o in zip(got, other):
        np.testing.assert_allclose(g.numpy(), o.numpy(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(stft.power_spectrum(xt, n_fft, hop, win, method=method).numpy(),
                               np.asarray(jax_stft.power_spectrum(x, n_fft, hop, win, method=method)),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(stft.mel_features(xt, 16000, n_fft, hop, win, 64, method=method).numpy(),
                               np.asarray(jax_stft.mel_features(x, 16000, n_fft, hop, win, 64, method=method)),
                               atol=2e-3, rtol=0)
    if method == "matmul":
        for g, w in zip(stft.convolution_stft(xt, n_fft, hop, win), jax_stft.convolution_stft(x, n_fft, hop, win)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_stft_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="matmul"):
        stft.stft(torch.zeros(1, 800), 512, 160, 320, method="dft")


@pytest.mark.parametrize("div_guard", [1e-5, 1e-2])
def test_masked_feature_normalize_matches_jax(div_guard):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 40, 8)) * 2 + 1).astype(np.float32)
    lengths = np.array([40, 17, 1], np.int32)
    want = np.asarray(jax_masking.masked_feature_normalize(jnp.asarray(x), jnp.asarray(lengths), div_guard=div_guard))
    got = masking.masked_feature_normalize(torch.as_tensor(x), torch.as_tensor(lengths), div_guard=div_guard).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert not got[1, 17:].any() and not got[2, 1:].any()


@pytest.mark.parametrize("name", list(FIELDS))
def test_filterbank_fields_match_jax(name):
    fields = FIELDS[name]
    jax_fields = {**fields, "dtype": jnp.dtype(fields["dtype"])} if "dtype" in fields else fields
    audio, lengths = _audio(3)
    want, want_lengths = JaxFilterbank(**jax_fields).apply({}, jnp.asarray(audio), jnp.asarray(lengths))
    module = FilterbankFeatures(**fields)
    got, got_lengths = module(torch.as_tensor(audio), torch.as_tensor(lengths))
    np.testing.assert_array_equal(got_lengths.numpy(), np.asarray(want_lengths))
    assert got.dtype == getattr(torch, str(jnp.dtype(want.dtype)))
    atol = 1e-4 if got.dtype == torch.float32 else 2**-7 * float(np.abs(np.asarray(want, np.float32)).max())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=0)
    assert (module.stft_method, module.use_fused_kernel, module.dft_precision) == (
        fields.get("stft_method", "matmul"), fields.get("use_fused_kernel"), fields.get("dft_precision", "auto"))


def test_filterbank_refuses_a_dft_precision_as_jax_does():
    with pytest.raises(ValueError) as want:
        JaxFilterbank(dft_precision="bf16")
    with pytest.raises(ValueError) as got:
        FilterbankFeatures(dft_precision="bf16")
    assert str(got.value) == str(want.value)


def test_plain_path_does_not_launch_the_kernel(monkeypatch):
    from thunder_tpu_torch.audio import frontend

    def refuse(*args, **kwargs):
        raise AssertionError("the log-mel kernel's wrapper ran")

    monkeypatch.setattr(frontend, "fused_log_mel", refuse)
    audio, lengths = _audio(4)
    feats, _ = FilterbankFeatures(use_fused_kernel=False)(torch.as_tensor(audio), torch.as_tensor(lengths))
    assert bool(torch.isfinite(feats).all())
    with pytest.raises(AssertionError, match="wrapper ran"):
        FilterbankFeatures()(torch.as_tensor(audio), torch.as_tensor(lengths))


def test_nemo_config_and_bundle_that_set_the_fields_build(tmp_path):
    fixture = Path(__file__).parent / "fixtures" / "tiny_quartznet.nemo"
    with tarfile.open(fixture) as tar:
        config = yaml.safe_load(tar.extractfile("model_config.yaml"))
    path = tmp_path / "model_config.yaml"
    path.write_text(yaml.safe_dump(config))
    augment = dict(stft_method="fft", use_fused_kernel=False, dft_precision="3x")
    _, frontend, _ = nemo.load_components_from_quartznet_config(path, augment_params=augment)
    assert (frontend.stft_method, frontend.use_fused_kernel, frontend.dft_precision) == ("fft", False, "3x")
    audio, lengths = _audio(5)
    want, _ = JaxFilterbank(nfilt=frontend.nfilt, n_fft=frontend.n_fft, n_window_size=frontend.n_window_size,
                            n_window_stride=frontend.n_window_stride, dither=frontend.dither,
                            **augment).apply({}, jnp.asarray(audio), jnp.asarray(lengths))
    got, _ = frontend(torch.as_tensor(audio), torch.as_tensor(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)

    module = export.load_inference_bundle(export.save_inference_bundle(str(tmp_path / "bundle"),
                                                                      _quartznet_module(fixture)), device="cpu")
    bundle = tmp_path / "bundle"
    written = json.loads((bundle / "config.json").read_text())
    written["frontend"].update(stft_method="fft", use_fused_kernel=False, dft_precision="highest", dtype="float32")
    (bundle / "config.json").write_text(json.dumps(written))
    loaded = export.load_inference_bundle(str(bundle), device="cpu")
    front = loaded.model.audio_transform
    assert (front.stft_method, front.use_fused_kernel, front.dft_precision, front.dtype) == (
        "fft", False, "highest", torch.float32)
    base, _ = module.model.audio_transform(torch.as_tensor(audio), torch.as_tensor(lengths))
    plain, _ = front(torch.as_tensor(audio), torch.as_tensor(lengths))
    np.testing.assert_allclose(plain.numpy(), base.numpy(), atol=2e-3, rtol=0)


def _quartznet_module(fixture):
    from thunder_tpu_torch import registry

    return registry.load_pretrained(str(fixture), device="cpu")
