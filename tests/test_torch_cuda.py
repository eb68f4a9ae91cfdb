"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a CUDA device).

Each kernel is held against its plain PyTorch version on the same device, with
the check names and tolerances of ``thunder_tpu_torch.kernels.selftest``, and
a small QuartzNet runs through the engine on the card and on the CPU.

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
