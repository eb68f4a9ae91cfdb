"""The port's log-mel frontend against the JAX package on the CPU.

On the CPU the ``fused_log_mel`` wrapper runs its plain version; it is held
against the JAX Pallas kernel in interpret mode and against the JAX XLA
pipeline at 2e-3 absolute (the on-chip ``frontend_log_mel`` tolerance). The
whole ``FilterbankFeatures`` module is held at 1e-4 (float32 on both sides).
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
from thunder_tpu_torch.kernels.frontend import fused_log_mel

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FilterbankFeatures()(torch.zeros(1, 1600), torch.tensor([1600]), train=True)


def test_fused_log_mel_refuses_what_it_cannot_run():
    with pytest.raises(ValueError):
        fused_log_mel(torch.zeros(2, 1600, dtype=torch.float64))
    with pytest.raises(ValueError):
        fused_log_mel(torch.zeros(1600))
    # neither CPU nor CUDA: raise, never compute elsewhere
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_log_mel(torch.zeros(2, 1600, device="meta"))
