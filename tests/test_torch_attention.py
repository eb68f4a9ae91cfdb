"""The plain versions of the attention and add + LayerNorm kernels against the JAX package (CPU).

Inputs come from numpy seeds and go to both sides. The JAX side runs the
Pallas kernels in interpret mode (``mha_from_qkv``, ``add_layer_norm``) or the
float32 reference of ``thunder_tpu/kernels/selftest.py`` (``-inf`` masking,
highest precision). Errors are in bf16 ULPs at the reference's largest
magnitude (``ulp_bf16_error``):

- plain attention vs the Pallas kernel, every query row: 2 ULP, and finite
  on both sides for a row of length 0; the same at T = 1792 (B = 1, 2
  heads), past the 1664 frames that the port's first kernel held;
- plain attention vs the float32 reference at T = 199, valid rows: 4 ULP,
  the JAX check's own limit;
- plain add + LayerNorm vs the Pallas kernel at (8, 128, 768): 2 ULP.

The wrappers' own behaviour on the CPU (plain version, no launch, shape
checks) is tested here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.kernels.add_ln import add_layer_norm as jax_add_layer_norm
from thunder_tpu.kernels.attn_onepanel import mha_from_qkv as jax_mha_from_qkv
from thunder_tpu_torch.kernels.add_ln import add_layer_norm, add_layer_norm_reference
from thunder_tpu_torch.kernels import attention, attention_train
from thunder_tpu_torch.kernels.attention import check_launch_shape, mha_from_qkv, mha_from_qkv_reference
from thunder_tpu_torch.kernels.selftest import add_ln_case, attention_case, ulp_bf16_error

torch.set_num_threads(2)


def _jax_bf16(t: torch.Tensor) -> jax.Array:
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _torch(a) -> torch.Tensor:
    return torch.as_tensor(np.array(jnp.asarray(a, jnp.float32)))


@pytest.mark.parametrize("lengths", [[256, 199], [199, 0]], ids=["ragged", "length-0 row"])
def test_plain_attention_matches_pallas_interpret(lengths):
    qkv, lens = attention_case(4, 2, 256, 4, lengths, "cpu")
    got = mha_from_qkv(qkv, lens, heads=4)
    want = _torch(jax_mha_from_qkv(_jax_bf16(qkv), jnp.asarray(lens.numpy()), heads=4, block_q=128, interpret=True))
    assert got.shape == want.shape == (2, 256, 256) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    for row in range(2):
        assert ulp_bf16_error(got[row], want[row]) <= 2.0, row
    if 0 in lengths:
        # a row of length 0 averages every key: every query of it gets the same output
        empty = got[lengths.index(0)].float()
        torch.testing.assert_close(empty, empty[:1].expand_as(empty), rtol=0, atol=0)


def test_plain_attention_past_the_old_cap_matches_pallas_interpret():
    qkv, lens = attention_case(26, 1, 1792, 2, [1750], "cpu")
    got = mha_from_qkv(qkv, lens, heads=2)
    want = _torch(jax_mha_from_qkv(_jax_bf16(qkv), jnp.asarray(lens.numpy()), heads=2, block_q=128, interpret=True))
    assert got.shape == want.shape == (1, 1792, 128)
    assert ulp_bf16_error(got, want) <= 2.0


def test_wrappers_set_no_frame_cap():
    """The kernels hold no score panel: no ``MAX_FRAMES``, only the launch's own limits."""
    assert not hasattr(attention, "MAX_FRAMES") and not hasattr(attention_train, "MAX_FRAMES")
    check_launch_shape("the attention kernel", 16, 1_000_000, 12)
    for batch, t, heads in ((1, 2**31, 12), (65536, 749, 12), (1, 749, 65536), (1, 0, 12)):
        with pytest.raises(ValueError, match="2\\*\\*31"):
            check_launch_shape("the attention kernel", batch, t, heads)


def test_plain_attention_matches_f32_reference_at_t199():
    b, t, heads, dh = 2, 199, 4, 64
    qkv, lens = attention_case(9, b, t, heads, [199, 142], "cpu")
    got = mha_from_qkv_reference(qkv, lens, heads)
    # thunder_tpu/kernels/selftest.py::_attn_onepanel_err's reference, on the same bf16 qkv
    q, k, v = jnp.split(jnp.asarray(qkv.float().numpy()), 3, axis=-1)
    split = lambda a: a.reshape(b, t, heads, dh)  # noqa: E731
    q, k, v = split(q) * dh**-0.5, split(k), split(v)
    scores = jnp.einsum("bthd,bshd->bhts", q, k, precision="highest")
    lengths = jnp.asarray(lens.numpy())
    valid = (jnp.arange(t)[None, :] < lengths[:, None])[:, None, None, :]
    probs = jax.nn.softmax(jnp.where(valid, scores, -jnp.inf), axis=-1)
    want = jnp.einsum("bhts,bshd->bthd", probs, v, precision="highest").reshape(b, t, heads * dh)
    mask = (jnp.arange(t)[None, :] < lengths[:, None])[:, :, None]
    want = _torch(jnp.where(mask, want, 0.0))
    got = torch.where(torch.as_tensor(np.array(mask)), got.float(), 0.0)
    assert ulp_bf16_error(got, want) <= 4.0


def test_plain_add_ln_matches_pallas_interpret():
    x, y, scale, bias = add_ln_case(5, (8, 128), 768, "cpu")
    got = add_layer_norm(x, y, scale, bias, eps=1e-5)
    want = _torch(jax_add_layer_norm(_jax_bf16(x), _jax_bf16(y), jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()),
                                     eps=1e-5, interpret=True))
    assert got.shape == (8, 128, 768) and got.dtype == torch.bfloat16
    assert ulp_bf16_error(got, want) <= 2.0


def test_wrappers_run_plain_versions_on_cpu_without_launching():
    qkv, lens = attention_case(1, 2, 33, 2, [33, 5], "cpu")
    x, y, scale, bias = add_ln_case(2, (3, 7), 64, "cpu")
    before = (mha_from_qkv.launches, add_layer_norm.launches)
    torch.testing.assert_close(mha_from_qkv(qkv, lens, 2), mha_from_qkv_reference(qkv, lens, 2), rtol=0, atol=0)
    torch.testing.assert_close(add_layer_norm(x, y, scale, bias), add_layer_norm_reference(x, y, scale, bias),
                               rtol=0, atol=0)
    assert (mha_from_qkv.launches, add_layer_norm.launches) == before


def test_wrappers_reject_bad_shapes_and_devices():
    qkv, lens = attention_case(1, 2, 8, 2, [8, 8], "cpu")
    with pytest.raises(ValueError, match="packed"):
        mha_from_qkv(qkv[..., :-1], lens, 2)
    with pytest.raises(ValueError, match="lengths"):
        mha_from_qkv(qkv, lens[:1], 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mha_from_qkv(qkv.to("meta"), lens.to("meta"), 2)
    x, y, scale, bias = add_ln_case(2, (3,), 64, "cpu")
    with pytest.raises(ValueError, match="shapes"):
        add_layer_norm(x, y[:, :32], scale, bias)
    with pytest.raises(ValueError, match="cuda or cpu"):
        add_layer_norm(x.to("meta"), y.to("meta"), scale.to("meta"), bias.to("meta"))


def test_f32_attention_and_add_ln_plain_versions_match_f32_math():
    """In float32 the plain versions are the textbook functions (no rounding points left)."""
    rng = np.random.default_rng(3)
    qkv = torch.as_tensor(rng.standard_normal((2, 20, 3 * 128)).astype(np.float32))
    lens = torch.tensor([20, 11], dtype=torch.int32)
    q, k, v = (a.reshape(2, 20, 2, 64).transpose(1, 2) for a in qkv.split(128, dim=-1))
    mask = (torch.arange(20)[None, :] < lens[:, None])[:, None, None, :]
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask).transpose(1, 2).reshape(2, 20, 128)
    torch.testing.assert_close(mha_from_qkv_reference(qkv, lens, 2), want, rtol=1e-5, atol=1e-5)
    x, y = (torch.as_tensor(rng.standard_normal((4, 96)).astype(np.float32)) for _ in range(2))
    scale, bias = (torch.as_tensor(rng.standard_normal(96).astype(np.float32)) for _ in range(2))
    want = torch.nn.functional.layer_norm(x + y, (96,), scale, bias, eps=1e-5)
    torch.testing.assert_close(add_layer_norm_reference(x, y, scale, bias), want, rtol=1e-5, atol=1e-5)
