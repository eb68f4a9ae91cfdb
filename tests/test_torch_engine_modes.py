"""The engine's serving modes against the JAX engine's (CPU).

``InferenceEngine(module, int8_weights=..., int8_compute=..., posconv_dense=...)``
in the port and in the JAX package, on the same weights (initialised in the
JAX package, through the bridge) and the same numpy audio: a small wav2vec2
(hidden 64, 4 heads, 2 layers, a 3-conv extractor of 64 channels, a k=8
positional conv in 4 groups), the small QuartzNet and Citrinet of
``tests/test_torch_engine.py`` and ``tests/test_torch_citrinet.py`` with
randomized BN statistics. Tolerances:

- float32, every mode but ``int8_compute``: lengths equal, logits within
  1e-4 of the JAX logits' largest magnitude on valid frames, the argmax
  equal on every valid frame;
- float32 with ``int8_compute``: lengths equal, logits within 0.02 of that
  scale, the argmax equal on 95 % of the valid frames. Looser because the
  dynamic activation quantization rounds ``x / s`` to an integer: where the
  two packages' float32 inputs differ in their last bits (1e-6 apart) and
  ``x / s`` sits that close to a half, one int8 step of s flips, about 1/127
  of the row's largest value, and the layers after it carry it on. The
  W8A8 products themselves agree to 1e-6 on identical input
  (``tests/test_torch_quantization.py``);
- bfloat16 (the kernels' plain versions): lengths equal, logits within 0.05
  of the JAX bf16 engine's scale, as ``tests/test_torch_wav2vec2.py`` holds
  the float mode.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.audio import Wav2Vec2Preprocess as JaxPreprocess
from thunder_tpu.engine import InferenceEngine as JaxEngine
from thunder_tpu.models import CitrinetEncoder as JaxCitrinet
from thunder_tpu.models import Conv1dDecoder as JaxDecoder
from thunder_tpu.models import LinearDecoder as JaxLinearDecoder
from thunder_tpu.models import QuartznetEncoder as JaxQuartznet
from thunder_tpu.models import wav2vec2 as jax_w2v
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu_torch import quantization
from thunder_tpu_torch.audio import FilterbankFeatures, Wav2Vec2Preprocess
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.engine import InferenceEngine
from thunder_tpu_torch.models import CitrinetEncoder, Conv1dDecoder, LinearDecoder, QuartznetEncoder
from thunder_tpu_torch.models import wav2vec2 as w2v
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer

torch.set_num_threads(2)

TOKENS = list("abcdefghijklmnopqrstuvwxyz '")
W2V = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, conv_dim=(64, 64, 64),
           conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4)
MODES = {
    "float": {},
    "posconv_dense": dict(posconv_dense=True),
    "int8_weights": dict(int8_weights=True),
    "int8_compute": dict(int8_compute=True),
    "int8_both": dict(int8_weights=True, int8_compute=True),
}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomized(module, seed=0):
    """Non-trivial BN statistics and affines, so that BN folding is tested."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(module.variables)
    for k, v in flat.items():
        if k[-1] == "var":
            flat[k] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif k[-1] == "mean" or (k[-1] in ("scale", "bias") and "bn" in k):
            flat[k] = jnp.asarray((rng.standard_normal(v.shape) * 0.3).astype(np.float32))
    return module.with_variables(flax.traverse_util.unflatten_dict(flat))


def _pair(jax_frontend, jax_encoder, jax_decoder, frontend, encoder, decoder, randomize):
    tt = JaxText(tokens=TOKENS)
    jax_module = JaxModule.create(jax.random.PRNGKey(1), audio_transform=jax_frontend, encoder=jax_encoder,
                                  decoder=jax_decoder(num_classes=tt.num_tokens), text_transform=tt, sample_len=4000)
    if randomize:
        jax_module = _randomized(jax_module)
    port = CTCModule.create(torch.Generator().manual_seed(0), frontend, encoder, decoder(len(TOKENS) + 1),
                            BatchTextTransformer(TOKENS), device="cpu")
    port.model.load_state_dict(from_flax_variables(_numpy(jax_module.variables)))
    return jax_module, port


@pytest.fixture(scope="module")
def w2v_pair():
    jax_encoder = jax_w2v.Wav2Vec2Encoder(jax_w2v.Wav2Vec2Config(**W2V), mask_input=True)
    return _pair(JaxPreprocess(mask_input=True), jax_encoder, JaxLinearDecoder, Wav2Vec2Preprocess(mask_input=True),
                 w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**W2V)), LinearDecoder, randomize=False)


@pytest.fixture(scope="module")
def conv_pairs():
    quartznet = dict(repeat=2, filters=(256,), kernel_sizes=(33,))
    citrinet = dict(filters=(64, 64, 64), kernel_sizes=(11, 13, 15), strides=(1, 2, 2), repeat=2)
    return {
        "quartznet": _pair(JaxFilterbank(), JaxQuartznet(**quartznet), JaxDecoder, FilterbankFeatures(),
                           QuartznetEncoder(**quartznet), Conv1dDecoder, randomize=True),
        "citrinet": _pair(JaxFilterbank(nfilt=80, dither=0.0), JaxCitrinet(**citrinet), JaxDecoder,
                          FilterbankFeatures(nfilt=80, dither=0.0), CitrinetEncoder(**citrinet), Conv1dDecoder,
                          randomize=True),
    }


def _audio(seed, samples=8000):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, samples)) * 0.3).astype(np.float32), np.array([samples, 3 * samples // 4], np.int32)


def _compare(got, got_lens, want, want_lens, bound, agreement=1.0):
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    valid = np.arange(want.shape[1])[None, :] < np.asarray(want_lens)[:, None]
    scale = np.abs(want[valid]).max()
    dev = np.abs(got[valid] - want[valid]).max() / scale
    agree = (got.argmax(-1) == want.argmax(-1))[valid].mean()
    assert np.isfinite(got).all() and dev <= bound and agree >= agreement, (dev, agree)


@pytest.mark.parametrize("mode", list(MODES))
def test_wav2vec2_modes_match_the_jax_engine(w2v_pair, mode):
    jax_module, port = w2v_pair
    audio, lengths = _audio(2)
    want, want_lens = JaxEngine(jax_module, compute_dtype=jnp.float32, **MODES[mode])(audio, lengths)
    got, got_lens = InferenceEngine(port, **MODES[mode])(audio, lengths)
    exact = "int8_compute" not in MODES[mode]
    _compare(got, got_lens, want, want_lens, 1e-4 if exact else 0.02, 1.0 if exact else 0.95)


@pytest.mark.parametrize("mode", list(MODES))
def test_wav2vec2_modes_in_bfloat16_match_the_jax_engine(w2v_pair, mode):
    jax_module, port = w2v_pair
    audio, lengths = _audio(3)
    want, want_lens = JaxEngine(jax_module, compute_dtype=jnp.bfloat16, **MODES[mode])(audio, lengths)
    engine = InferenceEngine(port, compute_dtype=torch.bfloat16, **MODES[mode])
    got, got_lens = engine(audio, lengths)
    _compare(got, got_lens, want, want_lens, 0.05, 0.0)
    layer = engine._encoder.layer0
    if MODES[mode].get("int8_compute"):
        assert isinstance(layer.attention.qkv_proj, w2v._Int8Dense) and layer.attention.qkv_proj.compute
        assert isinstance(engine._encoder.feature_extractor.conv1, w2v._Int8Conv)
        assert isinstance(engine._encoder.feature_extractor.conv0, w2v._Conv)
    if MODES[mode].get("int8_weights"):
        assert isinstance(engine._encoder.fp_projection, w2v._Int8Dense)
        assert engine._encoder.fp_projection.kernel_q8.dtype == torch.int8
        assert engine._dec_kernel.dtype == torch.int8
    assert engine._encoder.pos_conv.groups == (1 if mode == "posconv_dense" else 4)


def test_int8_compute_runs_the_integer_products(w2v_pair, monkeypatch):
    """One forward makes one int8 product for each of the 4 big Dense layers of each layer and each extractor
    conv of 64 input channels (2 here), and none in float mode."""
    calls = []
    reference = quantization.int8_mm_reference
    monkeypatch.setattr(quantization, "int8_mm_reference", lambda a, b: calls.append(a.shape) or reference(a, b))
    _, port = w2v_pair
    audio, lengths = _audio(4)
    InferenceEngine(port)(audio, lengths)
    assert calls == []
    InferenceEngine(port, int8_compute=True)(audio, lengths)
    assert len(calls) == 4 * W2V["num_hidden_layers"] + 2


def test_posconv_fold_is_block_diagonal(w2v_pair):
    _, port = w2v_pair
    config, state = w2v.fold_pos_conv(port.model.encoder.config, port.model.encoder.state_dict())
    kernel, grouped = state["pos_conv.kernel"], port.model.encoder.pos_conv.kernel.detach()
    assert config.num_conv_pos_embedding_groups == 1 and port.model.encoder.config.num_conv_pos_embedding_groups == 4
    gs = grouped.shape[1]
    for g in range(4):
        block = kernel[:, g * gs:(g + 1) * gs, g * gs:(g + 1) * gs]
        assert torch.equal(block, grouped[:, :, g * gs:(g + 1) * gs])
        kernel[:, g * gs:(g + 1) * gs, g * gs:(g + 1) * gs] = 0
    assert not kernel.any()


@pytest.mark.parametrize("model", ["quartznet", "citrinet"])
def test_conv_int8_weights_match_the_jax_engine(conv_pairs, model):
    jax_module, port = conv_pairs[model]
    audio, lengths = _audio(5, 16000)
    want, want_lens = JaxEngine(jax_module, compute_dtype=jnp.float32, int8_weights=True)(audio, lengths)
    engine = InferenceEngine(port, int8_weights=True)
    got, got_lens = engine(audio, lengths)
    _compare(got, got_lens, want, want_lens, 1e-4)
    quantized = [rp for block in engine._plan for rp in (*block.repeats, block.res) if rp is not None]
    assert all(rp.pw.dtype == torch.int8 and rp.q_scale.shape == (1, rp.pw.shape[1]) for rp in quantized)
    # float32 on the CPU: each quantized weight drops 3 of its 4 bytes and adds a float32 scale a column
    values = sum(rp.pw.numel() for rp in quantized) + engine._dec_kernel.numel()
    scales = sum(rp.q_scale.numel() for rp in quantized) + engine._dec_scale.numel()
    float_bytes = InferenceEngine(port).weight_bytes()
    assert engine.weight_bytes() == float_bytes - 3 * values + 4 * scales
    if model == "quartznet":  # the pointwise weights carry most of the bytes (tests/test_quantization.py)
        assert engine.weight_bytes() < 0.6 * float_bytes
    bf16, bf16_lens = InferenceEngine(port, compute_dtype=torch.bfloat16, int8_weights=True)(audio, lengths)
    want_bf16, _ = JaxEngine(jax_module, compute_dtype=jnp.bfloat16, int8_weights=True)(audio, lengths)
    _compare(bf16, bf16_lens, want_bf16, want_lens, 0.05, 0.0)


@pytest.mark.parametrize("mode", ["int8_weights", "int8_both"])
def test_wav2vec2_weight_bytes_fall_in_int8_modes(w2v_pair, mode):
    _, port = w2v_pair
    float_bytes = InferenceEngine(port).weight_bytes()
    params = sum(p.numel() * 4 for p in port.model.parameters())
    assert float_bytes == params  # float32 on the CPU: every parameter once
    assert InferenceEngine(port, **MODES[mode]).weight_bytes() < 0.6 * float_bytes


def test_int8_compute_is_a_wav2vec2_mode(conv_pairs):
    with pytest.raises(ValueError, match="wav2vec2"):
        InferenceEngine(conv_pairs["quartznet"][1], int8_compute=True)
