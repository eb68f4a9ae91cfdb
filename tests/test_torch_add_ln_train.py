"""The training add + dropout + LayerNorm of the port against the JAX package (CPU), and the shared dropout hash.

Inputs come from ``numpy.random.default_rng``. On the CPU the port's wrappers
run their plain versions; the JAX side runs its Pallas kernels in interpret
mode, which has no Mosaic PRNG, so the comparison with JAX is at rate 0 and
the dropout path is held to a float32 reference that applies the port's own
mask. Tolerances:

- rate 0 in float32 against the Pallas forward and its ``jax.grad``: 2e-5
  absolute for the output, dx and dy, 1e-4 of the largest entry for the
  ``dscale``/``dbias`` sums over 512 rows (float32 order);
- rate 0 in bfloat16: 1 bf16 ULP at the output's largest magnitude for the
  output, dx and dy (both sides round once), 1e-3 relative for the sums;
- rate 0.1 and 0.3 against autograd of the float32 reference with the same
  mask: 1e-5 in float32; in bfloat16 1 ULP;
- the hash: a kept fraction within 5 sigma of ``1 - rate``, exact equality
  wherever two ways of asking for the same bits are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.kernels.add_ln_train import add_ln_dropout_train as jax_add_ln_dropout_train
from thunder_tpu_torch.kernels import KERNEL_WRAPPERS, dropout_hash
from thunder_tpu_torch.kernels.add_ln_train import (
    add_ln_dropout_train,
    add_ln_train_backward,
    add_ln_train_backward_reference,
    add_ln_train_forward,
    backward_plan,
    backward_rows,
    dropout_keep_mask,
    dropout_keep_mask_reference,
)
from thunder_tpu_torch.kernels.attention_train import attention_keep_mask
from thunder_tpu_torch.kernels.selftest import add_ln_f32_reference

torch.set_num_threads(2)

SEED = torch.tensor([20260821], dtype=torch.int32)


def _case(seed, shape, d):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*shape, d)) * 2.0).astype(np.float32)
    y = rng.standard_normal((*shape, d)).astype(np.float32)
    scale = (rng.standard_normal(d) + 1.0).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    ct = rng.standard_normal((*shape, d)).astype(np.float32)
    return x, y, scale, bias, ct


def _port_value_and_grads(x, y, scale, bias, ct, rate, dtype):
    leaves = [torch.tensor(a).to(dtype).requires_grad_(True) for a in (x, y)]
    leaves += [torch.tensor(a).requires_grad_(True) for a in (scale, bias)]
    out = add_ln_dropout_train(*leaves, SEED, rate)
    out.backward(torch.tensor(ct).to(dtype))
    return out.detach(), [leaf.grad for leaf in leaves]


def _ulp(want: torch.Tensor) -> float:
    return 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rate_0_matches_the_pallas_kernels_in_interpret_mode(dtype):
    x, y, scale, bias, ct = _case(0, (2, 256), 128)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    seed = jnp.zeros((1,), jnp.int32)
    args = (jnp.asarray(x, jdt), jnp.asarray(y, jdt), jnp.asarray(scale), jnp.asarray(bias))
    want = jax_add_ln_dropout_train(*args, seed, interpret=True)
    want_grads = jax.grad(
        lambda *a: jnp.vdot(jax_add_ln_dropout_train(*a, seed, interpret=True).astype(jnp.float32), jnp.asarray(ct, jdt).astype(jnp.float32)),
        argnums=(0, 1, 2, 3))(*args)
    got, grads = _port_value_and_grads(x, y, scale, bias, ct, 0.0, tdt)
    as_t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    assert got.dtype == tdt and grads[0].dtype == tdt and grads[2].dtype == torch.float32
    for g, w in zip([got, *grads[:2]], [want, *want_grads[:2]]):
        w = as_t(w)
        torch.testing.assert_close(g.float(), w, rtol=0, atol=2e-5 if dtype == "float32" else _ulp(w))
    for g, w in zip(grads[2:], want_grads[2:]):
        w = as_t(w)
        torch.testing.assert_close(g, w, rtol=0, atol=(1e-4 if dtype == "float32" else 1e-3) * w.abs().max().item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_path_matches_the_float32_reference_with_the_same_mask(rate, dtype):
    x, y, scale, bias, ct = _case(1, (3, 37), 72)  # no multiple of any block
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got, grads = _port_value_and_grads(x, y, scale, bias, ct, rate, tdt)
    mask = dropout_keep_mask(x.shape, SEED, rate)
    assert 0.0 < mask.mean().item() < 1.0
    leaves = [torch.tensor(a).to(tdt).float().requires_grad_(True) for a in (x, y)]
    leaves += [torch.tensor(a).requires_grad_(True) for a in (scale, bias)]
    want = add_ln_f32_reference(*leaves, mask, rate)
    want_grads = torch.autograd.grad(want, leaves, torch.tensor(ct).to(tdt).float())
    for g, w in zip([got, *grads[:2]], [want.detach(), *want_grads[:2]]):
        torch.testing.assert_close(g.float(), w, rtol=0, atol=1e-5 if dtype == "float32" else _ulp(w))
    for g, w in zip(grads[2:], want_grads[2:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * w.abs().max().item())
    # the dropped entries of y get no gradient, the kept ones the residual's times 1 / (1 - rate)
    assert bool((grads[1][mask == 0] == 0).all())


def test_autograd_function_calls_the_explicit_backward():
    x, y, scale, bias, ct = _case(2, (5,), 64)
    _, grads = _port_value_and_grads(x, y, scale, bias, ct, 0.1, torch.bfloat16)
    bf = lambda a: torch.tensor(a).to(torch.bfloat16)  # noqa: E731
    want = add_ln_train_backward_reference(bf(x), bf(y), torch.tensor(scale), SEED, bf(ct), 0.1)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    assert all(torch.equal(g, w) for g, w in zip(add_ln_train_backward(bf(x), bf(y), torch.tensor(scale), SEED, bf(ct), 0.1), want))


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_hash_keeps_its_rate(rate):
    mask = dropout_keep_mask((700, 768), SEED, rate)
    assert set(mask.unique().tolist()) == {0.0, 1.0}
    n = mask.numel()
    assert abs(mask.mean().item() - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / n)
    heads = attention_keep_mask(SEED, 2, 3, 300, rate)
    assert heads.shape == (2, 3, 300, 300)
    assert abs(heads.float().mean().item() - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / heads.numel())
    # neighbours along a row, along a column and across streams are uncorrelated (5 sigma of a product's mean)
    c = heads.float() - (1 - rate)
    for a, b in ((c[..., 1:], c[..., :-1]), (c[..., 1:, :], c[..., :-1, :]), (c[:, 1:], c[:, :-1])):
        assert abs((a * b).mean().item()) < 5 * rate * (1 - rate) / np.sqrt(a.numel())


def test_hash_depends_on_seed_stream_and_row_and_not_on_tiling():
    rate = 0.3
    full = attention_keep_mask(SEED, 2, 2, 160, rate)
    assert not torch.equal(full, attention_keep_mask(SEED + 1, 2, 2, 160, rate))
    assert not torch.equal(full[0, 0], full[0, 1]) and not torch.equal(full[0, 1], full[1, 0])
    assert not torch.equal(full[0, 0, 0], full[0, 0, 1])
    # any tiling of the queries asks for the same bits: a row range equals the same rows cut from the whole mask
    rows = torch.arange(37, 101)
    assert torch.equal(attention_keep_mask(SEED, 2, 2, 160, rate, rows=rows), full[:, :, 37:101])
    whole = dropout_keep_mask((300, 64), SEED, rate)
    part = dropout_hash.keep_mask(SEED, torch.zeros((), dtype=torch.long), torch.arange(256, 300)[:, None],
                                  torch.arange(64)[None, :], rate)
    assert torch.equal(part, whole[256:] > 0)
    assert not torch.equal(whole, dropout_keep_mask((300, 64), SEED + 7, rate))
    # a leading batch axis only reshapes the flattened rows
    assert torch.equal(dropout_keep_mask((3, 100, 64), SEED, rate).reshape(300, 64), whole)
    assert bool((dropout_keep_mask((4, 8), SEED, 0.0) == 1).all())
    # the counters do not wrap: a stream, row and column near 2**31 stay distinct from their low bits
    big = dropout_hash.keep_mask(SEED, torch.tensor([5, 5 + 2**31])[:, None], torch.tensor(3), torch.arange(4096), 0.5)
    assert not torch.equal(big[0], big[1])


def test_hash_matches_a_direct_uint32_computation():
    """The int64 arithmetic with split multiplies against numpy's uint32 arithmetic, which wraps as the card's does."""
    def mix(x):
        x = x.astype(np.uint32)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
        return x

    seed, stream, rate = 20260821, 17, 0.3
    rows, cols = np.arange(50, dtype=np.uint32)[:, None], np.arange(90, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        key = mix(mix(np.uint32(seed) ^ np.array(stream, np.uint32) * np.uint32(0x9E3779B1)) ^ rows)
        bits = mix(key ^ cols * np.uint32(0x85EBCA6B))
    want = (bits >> np.uint32(9)).astype(np.float32) * np.float32(2.0**-23) >= np.float32(rate)
    got = dropout_hash.keep_mask(SEED, torch.tensor(stream), torch.arange(50)[:, None], torch.arange(90)[None, :], rate)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rate", [0.0, 2.0**-23, 0.1, 0.3, 0.5, 1 - 2.0**-23])
def test_integer_threshold_equals_the_float_compare_on_every_23_bit_value(rate):
    """The kernels test ``keep`` as ``bits >> 9 >= threshold(rate)`` (``dropout_hash.cuh::threshold``, ``keep_at``);
    the plain versions as ``(bits >> 9) * 2**-23 >= rate`` in float32. The two agree on all 2**23 values of
    ``bits >> 9``, and ``keep_at`` equals ``keep_from_keys`` on hashed keys and columns."""
    top = torch.arange(2**23)
    thr = dropout_hash.threshold(rate)
    assert torch.equal(dropout_hash.keep_from_bits(top, rate), top >= thr)
    assert 0 <= thr <= 2**23 - 1
    keys = dropout_hash.row_keys(SEED, torch.zeros((), dtype=torch.long), torch.arange(40)[:, None])
    cols = torch.arange(3000)[None, :]
    assert torch.equal(dropout_hash.keep_at(keys, cols, thr), dropout_hash.keep_from_keys(keys, cols, rate))


def test_wrappers_raise_on_bad_arguments_and_launch_nothing_on_the_cpu():
    x, y, scale, bias, ct = (torch.tensor(a) for a in _case(3, (4,), 16))
    before = [w.launches for w in KERNEL_WRAPPERS]
    add_ln_train_forward(x, y, scale, bias, SEED, 0.1)
    add_ln_train_backward(x, y, scale, SEED, ct, 0.1)
    dropout_keep_mask(x.shape, SEED, 0.1)
    assert [w.launches for w in KERNEL_WRAPPERS] == before
    with pytest.raises(ValueError, match="shapes"):
        add_ln_train_forward(x, y[:, :8], scale, bias, SEED)
    with pytest.raises(ValueError, match="bias"):
        add_ln_train_forward(x, y, scale, bias[:8], SEED)
    with pytest.raises(ValueError, match="dout"):
        add_ln_train_backward(x, y, scale, SEED, ct[:2])
    with pytest.raises(ValueError, match="dropout_rate"):
        add_ln_dropout_train(x, y, scale, bias, SEED, 1.0)
    with pytest.raises(ValueError, match="seed"):
        add_ln_dropout_train(x, y, scale, bias, SEED.long())
    with pytest.raises(ValueError, match="seed"):
        dropout_keep_mask(x.shape, torch.zeros(2, dtype=torch.int32), 0.1)
    meta = [a.to("meta") for a in (x, y, scale, bias)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        add_ln_train_forward(*meta, SEED.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        dropout_keep_mask((4, 16), SEED.to("meta"), 0.1)
    with pytest.raises(ValueError, match="generator"):
        dropout_hash.new_seed(None, "cpu", 0.1)
    seed = dropout_hash.new_seed(torch.Generator().manual_seed(0), "cpu", 0.1)
    assert seed.shape == (1,) and seed.dtype == torch.int32 and 0 <= int(seed) < 2**31 - 1
    assert torch.equal(seed, dropout_hash.new_seed(torch.Generator().manual_seed(0), "cpu", 0.1))
    assert int(dropout_hash.new_seed(None, "cpu", 0.0)) == 0  # nothing is drawn at rate 0
    assert torch.equal(dropout_keep_mask_reference((4, 16), SEED, 0.1), dropout_keep_mask((4, 16), SEED, 0.1))


@pytest.mark.parametrize("rows", [1, 3, 7, 8, 511, 5992, 11992, 100003])
def test_backward_plan_covers_every_row_once(rows):
    """The mirror of the backward kernel's plan on 132 SMs: the warps of the blocks take every row once, each
    block at least one (so each partial row of dscale/dbias is written), and no warp more than the plan says."""
    plan = backward_plan(rows, 768, 132)
    assert plan["partial_rows"] == plan["blocks"] <= 2 * 132 and plan["warps"] == 8
    covered = np.zeros(rows, np.int64)
    for block in range(plan["blocks"]):
        taken = [backward_rows(rows, plan["blocks"], block, warp) for warp in range(plan["warps"])]
        assert sum(len(r) for r in taken) >= 1
        assert max(len(r) for r in taken) <= plan["rows_a_warp"]
        for r in taken:
            covered[list(r)] += 1
    assert (covered == 1).all()


def test_backward_plan_fills_the_card_at_the_train_step():
    """wav2vec2-base's step (8 x 749 rows of 768): two blocks on each of 132 SMs, a workspace of at most 2 MB
    (one partial row a block), and shared memory for two blocks an SM."""
    plan = backward_plan(5992, 768, 132)
    assert plan["blocks"] >= 264
    assert plan["workspace_bytes"] <= 2 * 2**20
    assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024 and plan["rows_a_warp"] == 3
    assert backward_plan(5992, 2056, 132)["smem_bytes"] == 0  # the width the register rows do not take


@pytest.mark.parametrize("parts", [2, 4])
def test_slices_with_their_row_offsets_equal_the_whole_input_bit_for_bit(parts):
    # a data-parallel rank's rows: each slice of a (B, T, D) input, with the flattened index of its first row as
    # its offset, gets the whole input's mask, forward and gradients bit for bit
    x, y, scale, bias, ct = _case(7, (8, 9), 48)
    rate = 0.1
    whole_mask = dropout_keep_mask((8, 9, 48), SEED, rate)
    whole_out, whole_grads = _port_value_and_grads(x, y, scale, bias, ct, rate, torch.bfloat16)
    rows = 8 // parts
    dscale = dbias = 0
    for p in range(parts):
        sl = slice(p * rows, (p + 1) * rows)
        offset = p * rows * 9
        assert torch.equal(dropout_keep_mask((rows, 9, 48), SEED, rate, row_offset=offset), whole_mask[sl])
        assert torch.equal(dropout_keep_mask_reference((rows, 9, 48), SEED, rate, offset), whole_mask[sl])
        leaves = [torch.tensor(a[sl]).to(torch.bfloat16).requires_grad_(True) for a in (x, y)]
        leaves += [torch.tensor(a).requires_grad_(True) for a in (scale, bias)]
        out = add_ln_dropout_train(*leaves, SEED, rate, row_offset=offset)
        out.backward(torch.tensor(ct[sl]).to(torch.bfloat16))
        assert torch.equal(out.detach(), whole_out[sl])
        assert torch.equal(leaves[0].grad, whole_grads[0][sl]) and torch.equal(leaves[1].grad, whole_grads[1][sl])
        dscale, dbias = dscale + leaves[2].grad, dbias + leaves[3].grad
    # the parameters' gradients are the sums of the slices' (to float32 order)
    torch.testing.assert_close(dscale, whole_grads[2], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dbias, whole_grads[3], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="row_offset"):
        dropout_keep_mask((2, 48), SEED, rate, row_offset=-1)
