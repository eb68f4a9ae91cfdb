"""The port's separable repeat against the JAX package's repeat kernels on the CPU.

On the CPU ``fused_separable_repeat`` runs its plain version. It is held
against ``fused_separable_conv`` and ``fused_repeat_tm`` in Pallas interpret
mode (float32: atol 1e-4; the repeat_tm case also at bf16, where both sides
round the depthwise sum and the output to bf16 at the same points: 8 bf16
ULP, the on-chip tolerance), and, for the stride-2 stem and the dilation-2
tail that the TPU kernels do not take, against ``thunder_tpu.ops.conv.conv1d``
followed by a matmul.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.kernels.repeat_tm import fused_repeat_tm
from thunder_tpu.kernels.separable_conv import fused_separable_conv
from thunder_tpu.ops.conv import conv1d as jax_conv1d
from thunder_tpu_torch.kernels.selftest import ulp_bf16_error
from thunder_tpu_torch.kernels.separable_conv import fused_separable_repeat, output_length
from thunder_tpu_torch.ops.conv import get_same_padding

torch.set_num_threads(2)


def _case(seed, b, t, c, co, k, lengths=None):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, c)) * 0.5).astype(np.float32)
    lengths = np.full(b, t, np.int32) if lengths is None else np.asarray(lengths, np.int32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    dw = (rng.standard_normal((k, c)) * 0.1).astype(np.float32)
    pw = (rng.standard_normal((c, co)) * 0.05).astype(np.float32)
    scale = rng.standard_normal(co).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    return x, lengths, dw, pw, scale, bias


def _port(x, out_lengths, dw, pw_folded, bias, k, stride=1, dilation=1, relu=True, dtype=torch.float32):
    t = lambda a, d=dtype: torch.tensor(np.asarray(a)).to(d)  # noqa: E731
    return fused_separable_repeat(
        t(x), torch.as_tensor(out_lengths, dtype=torch.int32), t(dw), t(pw_folded), t(bias, torch.float32), k,
        stride=stride, dilation=dilation, relu=relu,
    )


@pytest.mark.parametrize("t,k,relu", [(128, 5, True), (200, 33, False), (256, 33, True), (130, 5, False)])
def test_matches_fused_separable_conv(t, k, relu):
    x, lengths, dw, pw, scale, bias = _case(0, 2, t, 128, 128, k)
    want = fused_separable_conv(
        jnp.asarray(x), jnp.asarray(dw), jnp.asarray(pw), jnp.asarray(scale), jnp.asarray(bias),
        kernel_size=k, relu=relu, interpret=True,
    )
    got = _port(x, lengths, dw, pw * scale[None, :], bias, k, relu=relu)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _repeat_tm(x, lengths, dw, pw, scale, bias, k, relu, dtype):
    out = fused_repeat_tm(
        jnp.asarray(np.transpose(x, (1, 0, 2)), dtype), jnp.asarray(lengths), jnp.asarray(dw, dtype),
        jnp.asarray(pw, dtype), jnp.asarray(scale), jnp.asarray(bias), kernel_size=k, relu=relu, interpret=True,
    )
    return np.transpose(np.asarray(out.astype(jnp.float32)), (1, 0, 2))


@pytest.mark.parametrize("t,k,relu", [(128, 5, True), (256, 33, False)])
def test_matches_fused_repeat_tm_ragged(t, k, relu):
    # 2 real rows of ragged length; the kernel's batch tile is 16, so 14 rows of length 0
    lengths = np.zeros(16, np.int32)
    lengths[:2] = [t, t // 2 + 3]
    x, lengths, dw, pw, scale, bias = _case(1, 16, t, 128, 128, k, lengths)
    want = _repeat_tm(x, lengths, dw, pw, scale, bias, k, relu, jnp.float32)
    got = _port(x, lengths, dw, pw * scale[None, :], bias, k, relu=relu).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert not got[1, lengths[1] :].any() and not got[2:].any()


def test_matches_fused_repeat_tm_bf16_rounding_points():
    lengths = np.zeros(16, np.int32)
    lengths[:2] = [256, 141]
    x, lengths, dw, pw, scale, bias = _case(2, 16, 256, 128, 128, 33, lengths)
    # both sides take the same bf16 weights, with the BN scale already folded in
    pw_folded = np.asarray(jnp.asarray(pw * scale[None, :], jnp.bfloat16).astype(jnp.float32))
    want = _repeat_tm(x, lengths, dw, pw_folded, np.ones_like(scale), bias, 33, True, jnp.bfloat16)
    got = _port(x, lengths, dw, pw_folded, bias, 33, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = torch.tensor(want)
    assert ulp_bf16_error(got, want) <= 8.0
    # same rounding points: only f32 summation order differs, so almost every
    # nonzero element is bit-identical (skipping the depthwise rounding changes ~8 %)
    nonzero = (got != 0) | (want != 0)
    assert (got.float() != want)[nonzero].float().mean().item() < 0.01


@pytest.mark.parametrize("k,stride,dilation,c,co", [(33, 2, 1, 64, 256), (87, 1, 2, 128, 128), (13, 2, 1, 8, 16)])
def test_strided_and_dilated_match_conv1d_then_matmul(k, stride, dilation, c, co):
    t = 190
    x, lengths, dw, pw, scale, bias = _case(3, 2, t, c, co, k, [t, 101])
    pad = get_same_padding(k, stride, dilation)
    out_lengths = (lengths + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    y = jax_conv1d(jnp.asarray(x), jnp.asarray(dw)[:, None, :], stride=stride, padding=pad, dilation=dilation, groups=c)
    want = np.maximum(np.asarray(jnp.matmul(y, jnp.asarray(pw))) * scale + bias, 0.0)
    want[np.arange(want.shape[1])[None, :] >= out_lengths[:, None]] = 0.0
    got = _port(x, out_lengths, dw, pw * scale[None, :], bias, k, stride=stride, dilation=dilation)
    assert got.shape == (2, output_length(t, k, stride, dilation), co) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_cpu_path_counts_no_launch_and_rejects_bad_shapes():
    before = fused_separable_repeat.launches
    x, lengths, dw, pw, scale, bias = _case(4, 2, 64, 16, 16, 5)
    _port(x, lengths, dw, pw, bias, 5)
    assert fused_separable_repeat.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError):
        _port(x, lengths, dw[:3], pw, bias, 5)  # taps do not match kernel_size
    with pytest.raises(ValueError):
        _port(x, lengths[:1], dw, pw, bias, 5)  # one length for two rows
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_separable_repeat(
            torch.zeros(2, 64, 16, device="meta"), torch.zeros(2, dtype=torch.int32, device="meta"),
            torch.zeros(5, 16, device="meta"), torch.zeros(16, 16, device="meta"), torch.zeros(16, device="meta"), 5,
        )
