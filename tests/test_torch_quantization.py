"""The port's ``quantization`` module against the JAX package's (CPU).

Fixtures after ``tests/test_quantization.py``: a small wav2vec2 (hidden 32,
2 layers, a 3-conv extractor of 64 channels, so that ``int8_compute`` takes
its convs 1 and 2) and a small QuartzNet, both initialised in the JAX
package; their variables go through the bridge into the port's names.
Tolerances:

- ``quantize_array``, ``quantize_tree``, ``quantize_tree_compute``,
  ``dequantize_variables`` and ``quantization_summary``: bit-equal (the same
  numpy recipe), the same leaves selected;
- ``dynamic_int8_matmul`` and ``dynamic_int8_conv`` on the same float input:
  the int8 operands bit-equal, the output within 1e-6 relative of the JAX
  function's (integer sums are exact; only the float32 rescale rounds);
- ``int8_mm``: equal to the exact integer product at every row count,
  padded to what ``torch._int_mm`` takes on the card.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu import quantization as jq
from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.audio import Wav2Vec2Preprocess as JaxPreprocess
from thunder_tpu.models import Conv1dDecoder as JaxDecoder
from thunder_tpu.models import LinearDecoder as JaxLinearDecoder
from thunder_tpu.models import QuartznetEncoder as JaxQuartznet
from thunder_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from thunder_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu_torch import quantization as q
from thunder_tpu_torch.bridge import from_flax_variables

torch.set_num_threads(2)

W2V = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64, conv_dim=(64, 64, 64),
           conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def w2v_params():
    tt = JaxText(tokens=list("abc "))
    module = JaxModule.create(jax.random.PRNGKey(0), audio_transform=JaxPreprocess(),
                              encoder=JaxEncoder(config=JaxConfig(**W2V)),
                              decoder=JaxLinearDecoder(num_classes=tt.num_tokens), text_transform=tt, sample_len=4000)
    return _numpy(module.variables["params"]["encoder"])


@pytest.fixture(scope="module")
def quartznet_variables():
    tt = JaxText(tokens=list("abc "))
    module = JaxModule.create(jax.random.PRNGKey(0), audio_transform=JaxFilterbank(dither=0.0),
                              encoder=JaxQuartznet(repeat=2, filters=(64, 64), kernel_sizes=(33, 39)),
                              decoder=JaxDecoder(num_classes=tt.num_tokens), text_transform=tt, sample_len=4000)
    return _numpy(module.variables)


def _port_names(flat_jax: dict) -> dict:
    """A flat flax tree of arrays under the port's names: the path joined with ".", without the ``conv`` level
    that flax's ``nn.Conv`` adds above a kernel (the bridge's rule, for the quantized leaves too)."""
    out = {}
    for path, value in flat_jax.items():
        path = list(path)
        for i in range(len(path) - 1):
            if path[i] == "conv" and path[i + 1] in ("kernel", "bias"):
                del path[i]
                break
        out[".".join(path)] = np.asarray(value)
    return out


def _assert_trees_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        g = got[name].numpy() if isinstance(got[name], torch.Tensor) else np.asarray(got[name])
        assert g.dtype == value.dtype and g.shape == value.shape, (name, g.dtype, value.dtype, g.shape, value.shape)
        np.testing.assert_array_equal(g, value, err_msg=name)


@pytest.mark.parametrize("shape", [(64, 48), (1, 40, 24), (3, 16, 8), (7,)], ids=str)
def test_quantize_array_is_bit_equal(shape):
    rng = np.random.default_rng(len(shape))
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if w.ndim > 1:
        w[..., 1] = 0.0  # a column of zeros: the 1e-12 floor of its scale
    got_q, got_s = q.quantize_array(torch.as_tensor(w))
    want_q, want_s = jq.quantize_array(w)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32 and got_s.shape == want_s.shape
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s, want_s)


def test_quantize_tree_selects_the_jax_leaves(w2v_params, quartznet_variables):
    for params in (w2v_params, quartznet_variables["params"]):
        want = _port_names(flax.traverse_util.flatten_dict(jq.quantize_tree(params)))
        got = q.quantize_tree(from_flax_variables({"params": params}))
        _assert_trees_equal(got, want)
        assert any(name.endswith(".__q8_values") for name in got)


@pytest.mark.parametrize("extractor_convs", [True, False])
def test_quantize_tree_compute_selects_the_jax_leaves(w2v_params, extractor_convs):
    want = _port_names(flax.traverse_util.flatten_dict(jq.quantize_tree_compute(w2v_params, extractor_convs)))
    got = q.quantize_tree_compute(from_flax_variables({"params": w2v_params}), extractor_convs)
    _assert_trees_equal(got, want)
    assert ("feature_extractor.conv1.kernel_q8" in got) == extractor_convs
    assert "feature_extractor.conv0.kernel" in got and "fp_projection.kernel" in got
    assert "layer1.attention.qkv_proj.kernel_q8" in got and "layer1.output_dense.kernel_scale" in got


def test_variables_round_trip_and_summary_match_jax(quartznet_variables):
    jax_q = jq.quantize_variables(quartznet_variables)
    state = from_flax_variables(quartznet_variables)
    port_q = q.quantize_variables(state)
    want = _port_names(flax.traverse_util.flatten_dict(jax_q["params"]))
    _assert_trees_equal({k: v for k, v in port_q.items() if not k.endswith((".mean", ".var"))}, want)
    assert q.quantization_summary(port_q)["quantized_bytes"] == jq.quantization_summary(jax_q)["quantized_bytes"]
    restored = q.dequantize_variables(port_q)
    want = _port_names(flax.traverse_util.flatten_dict(jq.dequantize_variables(jax_q)["params"]))
    _assert_trees_equal({k: v for k, v in restored.items() if not k.endswith((".mean", ".var"))}, want)
    assert sorted(restored) == sorted(state)


def test_dequantize_runs_in_the_compute_dtype(w2v_params):
    tree = q.quantize_tree(from_flax_variables({"params": w2v_params}))
    name = "layer0.attention.qkv_proj.kernel"
    got = q.dequantize(tree, torch.bfloat16)[name]
    want = jq.dequantize_tree_jax(jq.quantize_tree(w2v_params), jnp.bfloat16)["layer0"]["attention"]["qkv_proj"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want["kernel"], np.float32))


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[0] = 0.0  # a row (or sample) of zeros: the 1e-12 floor of its scale
    return x


@pytest.mark.parametrize("lead", [(3,), (2, 9), (40,)], ids=str)
def test_dynamic_int8_matmul_matches_jax(lead):
    x = _x((*lead, 64), 4)
    kq, scale = jq.quantize_array((np.random.default_rng(5).standard_normal((64, 48)) * 0.1).astype(np.float32))
    scale = scale.reshape(-1)
    want = np.asarray(jq.dynamic_int8_matmul(jnp.asarray(x), jnp.asarray(kq), jnp.asarray(scale)))
    got = q.dynamic_int8_matmul(torch.as_tensor(x), torch.as_tensor(kq), torch.as_tensor(scale)).numpy()
    assert got.shape == want.shape == (*lead, 48)
    xf = x.reshape(-1, 64)
    s = np.maximum(np.abs(xf).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-12))
    got_q, _ = q._quantize_rows(torch.as_tensor(xf), -1)
    np.testing.assert_array_equal(got_q.numpy(), np.round(xf / s).astype(np.int8))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("taps,stride", [(3, 2), (2, 2), (10, 5), (1, 1)])
def test_dynamic_int8_conv_matches_jax(taps, stride):
    x = _x((3, 50, 64), 6)
    kq, scale = jq.quantize_array((np.random.default_rng(7).standard_normal((taps, 64, 24)) * 0.1).astype(np.float32))
    scale = scale.reshape(-1)
    want = np.asarray(jq.dynamic_int8_conv(jnp.asarray(x), jnp.asarray(kq), jnp.asarray(scale), stride=stride))
    got = q.dynamic_int8_conv(torch.as_tensor(x), torch.as_tensor(kq), torch.as_tensor(scale), stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(1, 5, 3), (16, 8, 8), (17, 13, 24), (40, 64, 8)])
def test_int8_mm_pads_to_what_int_mm_takes(m, k, n, monkeypatch):
    rng = np.random.default_rng(m + k + n)
    a = torch.as_tensor(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.as_tensor(rng.integers(-127, 128, (k, n)).astype(np.int8))
    seen, reference = [], q.int8_mm_reference

    def spy(a_, b_):
        seen.append((tuple(a_.shape), tuple(b_.shape)))
        return reference(a_, b_)

    monkeypatch.setattr(q, "int8_mm_reference", spy)
    got = q.int8_mm(a, b)
    (am, ak), (bk, bn) = seen[0]
    assert am >= max(m, q.INT_MM_MIN_ROWS) and am > 16 and ak == bk and ak % 8 == 0 and bn % 8 == 0
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64) @ b.numpy().astype(np.int64))


def test_int8_mm_refuses_float_operands():
    with pytest.raises(ValueError, match="int8"):
        q.int8_mm(torch.zeros(20, 8), torch.zeros(8, 8, dtype=torch.int8))
