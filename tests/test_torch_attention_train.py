"""The training attention of the port against the JAX package (CPU).

Inputs come from ``numpy.random.default_rng``. On the CPU the port's wrappers
run their plain versions; the JAX kernel runs in interpret mode, which has no
Mosaic PRNG, so the comparison with the Pallas kernel is at rate 0 (T a
multiple of 128 there) and the dropout path is held to the JAX selftest's
float32 reference ``_attn_train_ref`` given the port's own mask. Tolerances:

- float32, against the Pallas forward and its ``jax.grad`` (T = 256, 4 heads,
  lengths 256 and 199; and T = 1792, 2 heads, B = 1, past the 1664 frames
  that the port's first forward kernel held) and against ``_attn_train_ref`` (T = 199, any T): 1e-5,
  the JAX package's own limit for this kernel;
- float32 at rate 0.3 against ``_attn_train_ref(mask=, keep=)``, forward and
  gradient: 1e-5;
- bfloat16 against the same float32 references: 2 bf16 ULP at the
  reference's largest magnitude (the plain version rounds q, P, dS, dO' and
  the outputs where the kernels do).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.kernels.attn_train import mha_train as jax_mha_train
from thunder_tpu.kernels.selftest import _attn_train_ref
from thunder_tpu_torch.kernels import KERNEL_WRAPPERS
from thunder_tpu_torch.kernels.attention import mha_from_qkv_reference
from thunder_tpu_torch.kernels.attention_train import (
    attention_keep_mask,
    mha_train,
    mha_train_backward,
    mha_train_backward_reference,
    mha_train_forward,
)

torch.set_num_threads(2)

SEED = torch.tensor([20260821], dtype=torch.int32)


def _case(seed, b, t, heads, lengths, zero_padded_cotangent=True):
    rng = np.random.default_rng(seed)
    h = heads * 64
    qkv = rng.standard_normal((b, t, 3 * h)).astype(np.float32) * 0.3
    lengths = np.asarray(lengths, np.int32)
    ct = rng.standard_normal((b, t, h)).astype(np.float32)
    if zero_padded_cotangent:  # as any length-masked loss gives it
        ct = ct * (np.arange(t)[None, :] < lengths[:, None])[:, :, None]
    return qkv, lengths, ct


def _port(qkv, lengths, ct, heads, rate, dtype=torch.float32):
    leaf = torch.tensor(qkv).to(dtype).requires_grad_(True)
    out = mha_train(leaf, torch.tensor(lengths), SEED, heads, rate)
    out.backward(torch.tensor(ct).to(dtype))
    return out.detach(), leaf.grad


def _jax_reference(qkv, lengths, ct, heads, mask=None, keep=1.0):
    lens = jnp.asarray(lengths)
    fn = lambda x: _attn_train_ref(x, lens, heads, mask=mask, keep=keep)  # noqa: E731
    want = fn(jnp.asarray(qkv))
    grad = jax.grad(lambda x: jnp.vdot(fn(x), jnp.asarray(ct)))(jnp.asarray(qkv))
    return torch.tensor(np.asarray(want)), torch.tensor(np.asarray(grad))


def _ulp(want: torch.Tensor) -> float:
    return 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)


def test_rate_0_matches_the_pallas_kernel_in_interpret_mode():
    _check_rate_0_against_pallas(2, 256, 4, [256, 199])


def test_rate_0_matches_the_pallas_kernel_past_the_old_cap():
    _check_rate_0_against_pallas(1, 1792, 2, [1750])


def _check_rate_0_against_pallas(b, t, heads, lengths):
    qkv, lengths, ct = _case(0, b, t, heads, lengths)
    seed = jnp.zeros((1,), jnp.int32)
    lens = jnp.asarray(lengths)
    want = jax_mha_train(jnp.asarray(qkv), lens, seed, heads=heads, interpret=True)
    want_grad = jax.grad(lambda x: jnp.vdot(jax_mha_train(x, lens, seed, heads=heads, interpret=True), jnp.asarray(ct)))(
        jnp.asarray(qkv))
    got, grad = _port(qkv, lengths, ct, heads, 0.0)
    # every query row, the padded ones too: they attend the valid keys like any row
    torch.testing.assert_close(got, torch.tensor(np.asarray(want)), rtol=0, atol=1e-5)
    torch.testing.assert_close(grad, torch.tensor(np.asarray(want_grad)), rtol=0, atol=1e-5)
    assert grad.abs().max().item() > 1e-3 and grad.shape == qkv.shape


@pytest.mark.parametrize("t,heads,lengths", [(199, 2, [199, 142]), (1, 1, [1, 1]), (130, 3, [130, 1])])
def test_rate_0_matches_the_float32_reference_at_any_length(t, heads, lengths):
    qkv, lengths, ct = _case(1, 2, t, heads, lengths)
    want, want_grad = _jax_reference(qkv, lengths, ct, heads)
    got, grad = _port(qkv, lengths, ct, heads, 0.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_path_matches_the_float32_reference_with_the_same_mask(dtype):
    heads, rate, t = 2, 0.3, 160
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    qkv, lengths, ct = _case(2, 2, t, heads, [t, t - 31], zero_padded_cotangent=False)
    qkv, ct = (torch.tensor(a).to(tdt).float().numpy() for a in (qkv, ct))  # the values both sides see
    mask = attention_keep_mask(SEED, 2, heads, t, rate)
    assert abs(mask.float().mean().item() - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / mask.numel())
    want, want_grad = _jax_reference(qkv, lengths, ct, heads, mask=jnp.asarray(mask.numpy(), jnp.float32), keep=1 - rate)
    got, grad = _port(qkv, lengths, ct, heads, rate, tdt)
    assert got.dtype == tdt and grad.dtype == tdt
    torch.testing.assert_close(got.float(), want, rtol=0, atol=1e-5 if dtype == "float32" else 2 * _ulp(want))
    torch.testing.assert_close(grad.float(), want_grad, rtol=0, atol=1e-5 if dtype == "float32" else 2 * _ulp(want_grad))
    # another seed drops other probabilities
    other = mha_train(torch.tensor(qkv).to(tdt), torch.tensor(lengths), SEED + 1, heads, rate)
    assert not torch.equal(other, got)


def test_rate_0_forward_is_the_serving_kernels_plain_version():
    qkv, lengths, _ = _case(3, 3, 77, 2, [77, 40, 0])
    qkv, lengths = torch.tensor(qkv).to(torch.bfloat16), torch.tensor(lengths)
    out, stats = mha_train_forward(qkv, lengths, SEED, 2, 0.0)
    assert torch.equal(out, mha_from_qkv_reference(qkv, lengths, 2))
    assert stats.shape == (2, 3, 2, 77) and stats.dtype == torch.float32
    # a row of length 0 averages every key: m is the mask value, z the number of keys, and all of it stays finite
    assert bool((stats[1, 2] == 77).all()) and bool((stats[0, 2] == torch.finfo(torch.float32).min).all())
    assert bool(torch.isfinite(out).all())


def test_row_of_length_0_stays_finite_forward_and_backward():
    qkv, lengths, ct = _case(4, 3, 50, 2, [50, 7, 0], zero_padded_cotangent=False)
    for rate in (0.0, 0.1):
        got, grad = _port(qkv, lengths, ct, 2, rate, torch.bfloat16)
        assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(grad).all())
        assert grad[2].abs().max().item() > 0  # the uniform row still passes gradient to v


def test_autograd_function_calls_the_explicit_backward_on_the_saved_output():
    heads, rate = 2, 0.1
    qkv, lengths, ct = _case(5, 2, 64, heads, [64, 20])
    _, grad = _port(qkv, lengths, ct, heads, rate, torch.bfloat16)
    q, lens, c = torch.tensor(qkv).to(torch.bfloat16), torch.tensor(lengths), torch.tensor(ct).to(torch.bfloat16)
    out, stats = mha_train_forward(q, lens, SEED, heads, rate)
    assert torch.equal(grad, mha_train_backward_reference(q, out, stats, c, lens, SEED, heads, rate))
    assert torch.equal(grad, mha_train_backward(q, out, stats, c, lens, SEED, heads, rate))
    # delta comes from the saved, rounded output: another output gives another gradient
    assert not torch.equal(grad, mha_train_backward(q, out * 1.5, stats, c, lens, SEED, heads, rate))


def _backward_with_the_scale_folded(qkv, out, stats, dout, lengths, seed, heads, rate):
    """``mha_train_backward_reference`` as the kernels order it: q enters the products unscaled, and q kᵀ
    and dSᵀ q are multiplied by 0.125 in float32."""
    dt, (b, t, h3) = qkv.dtype, qkv.shape
    q, k, v = (a.reshape(b, t, heads, 64).transpose(1, 2).float() for a in qkv.split(h3 // 3, dim=-1))
    do, o = (a.reshape(b, t, heads, 64).transpose(1, 2).float() for a in (dout, out))
    valid = torch.arange(t)[None, :] < lengths[:, None]
    mask = torch.where(valid, 0.0, torch.finfo(torch.float32).min)[:, None, None, :]
    e = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * 0.125 + mask - stats[0][..., None])
    inv_z = 1.0 / stats[1][..., None]
    delta = (do * o).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do, v.transpose(-1, -2))
    pd = e.to(dt).float()
    inv_keep = torch.ones(())
    if rate > 0.0:
        keep = attention_keep_mask(seed, b, heads, t, rate)
        inv_keep = 1.0 / (1.0 - torch.tensor(rate, dtype=torch.float32))
        dp, pd = torch.where(keep, dp * inv_keep, 0.0), torch.where(keep, pd, 0.0)
    ds = (e * (dp - delta) * inv_z).to(dt).float()
    dq = torch.matmul(ds, k) * 0.125
    dk = torch.matmul(ds.transpose(-1, -2), q) * 0.125
    dv = torch.matmul(pd.transpose(-1, -2), (do * (inv_z * inv_keep)).to(dt).float())
    return torch.cat([a.transpose(1, 2).reshape(b, t, h3 // 3) for a in (dq, dk, dv)], dim=-1).to(dt)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_scale_folded_into_the_products_gives_the_plain_backward_bit_for_bit(rate):
    """0.125 is a power of two: bf16(q * 0.125) is exact and scales every partial sum exactly, so the
    kernels' order (q unscaled, the scale on q kᵀ and dSᵀ q) is the plain version's bits."""
    heads = 2
    qkv, lengths, ct = _case(7, 3, 97, heads, [97, 50, 0], zero_padded_cotangent=False)
    q, lens, c = torch.tensor(qkv).to(torch.bfloat16), torch.tensor(lengths), torch.tensor(ct).to(torch.bfloat16)
    out, stats = mha_train_forward(q, lens, SEED, heads, rate)
    want = mha_train_backward_reference(q, out, stats, c, lens, SEED, heads, rate)
    got = _backward_with_the_scale_folded(q, out, stats, c, lens, SEED, heads, rate)
    assert torch.equal(got, want)
    assert min(part.abs().max().item() for part in want.split(heads * 64, dim=-1)) > 1e-3


def test_wrappers_raise_on_bad_arguments_and_launch_nothing_on_the_cpu():
    qkv, lengths, ct = _case(6, 2, 16, 2, [16, 9])
    qkv, lengths, ct = torch.tensor(qkv), torch.tensor(lengths), torch.tensor(ct)
    before = [w.launches for w in KERNEL_WRAPPERS]
    out, stats = mha_train_forward(qkv, lengths, SEED, 2, 0.1)
    mha_train_backward(qkv, out, stats, ct, lengths, SEED, 2, 0.1)
    assert [w.launches for w in KERNEL_WRAPPERS] == before
    with pytest.raises(ValueError, match="packed"):
        mha_train(qkv[..., :380], lengths, SEED, 2)
    with pytest.raises(ValueError, match="packed"):
        mha_train(qkv, lengths, SEED, 5)
    with pytest.raises(ValueError, match="lengths"):
        mha_train(qkv, lengths[:1], SEED, 2)
    with pytest.raises(ValueError, match="dropout_rate"):
        mha_train(qkv, lengths, SEED, 2, 1.0)
    with pytest.raises(ValueError, match="seed"):
        mha_train(qkv, lengths, torch.zeros((), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="do not fit"):
        mha_train_backward(qkv, out, stats[:, :1], ct, lengths, SEED, 2)
    with pytest.raises(ValueError, match="do not fit"):
        mha_train_backward(qkv, out, stats, ct[:, :3], lengths, SEED, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mha_train_forward(qkv.to("meta"), lengths.to("meta"), SEED.to("meta"), 2)
