"""The wav2vec2 serving slice against the JAX package (CPU).

A small wav2vec2 (hidden 128, 2 heads of 64, 2 layers, FFN 256, a 3-conv
extractor of 32 channels with kernels (10, 3, 3) and strides (5, 2, 2), a
k=16 positional conv in 4 groups) is initialised in the JAX package, its
variables go through the bridge into the port, and both run the same numpy
audio (2 x 4000 samples, lengths 4000 and 2900). Tolerances:

- gelu (exact and polynomial) and ``Wav2Vec2Preprocess`` (both branches):
  1e-6;
- the encoder, both variants (group norm + post-LN, layer norm + stable LN
  with conv biases): identical lengths, hidden states within 1e-4 on valid
  frames;
- ``CTCModule`` + ``InferenceEngine`` in float32: logits within 1e-4,
  identical transcripts;
- the engine in bfloat16 (through both kernels' plain versions and the
  polynomial gelu) against the JAX engine in bfloat16: identical lengths,
  logits within 0.05 of their largest magnitude (the two round at different
  points: the port's kernels add and keep scores in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.audio import Wav2Vec2Preprocess as JaxPreprocess
from thunder_tpu.engine import InferenceEngine as JaxEngine
from thunder_tpu.models import LinearDecoder as JaxLinearDecoder
from thunder_tpu.models import wav2vec2 as jax_w2v
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu_torch.audio import Wav2Vec2Preprocess
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.engine import InferenceEngine
from thunder_tpu_torch.kernels import KERNEL_WRAPPERS
from thunder_tpu_torch.models import LinearDecoder
from thunder_tpu_torch.models import wav2vec2 as w2v
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer

torch.set_num_threads(2)

TOKENS = list("abcdefghijklmnopqrstuvwxyz '.,?")
SMALL = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
             conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4)
VARIANTS = {
    "base-style": dict(),
    "large-style": dict(feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True),
}


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32), np.array([4000, 2900], np.int32)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(VARIANTS))
def encoders(request):
    variant = VARIANTS[request.param]
    jax_encoder = jax_w2v.Wav2Vec2Encoder(jax_w2v.Wav2Vec2Config(**SMALL, **variant), mask_input=True)
    audio, lengths = _audio()
    variables = _numpy(jax_encoder.init(jax.random.PRNGKey(0), jnp.asarray(audio), jnp.asarray(lengths)))
    port = w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**SMALL, **variant))
    port.load_state_dict(from_flax_variables(variables))
    return jax_encoder, variables, port


@pytest.fixture(scope="module")
def slice_pair():
    tt = JaxText(tokens=TOKENS)
    jax_module = JaxModule.create(
        jax.random.PRNGKey(1),
        audio_transform=JaxPreprocess(mask_input=True),
        encoder=jax_w2v.Wav2Vec2Encoder(jax_w2v.Wav2Vec2Config(**SMALL), mask_input=True),
        decoder=JaxLinearDecoder(num_classes=tt.num_tokens),
        text_transform=tt,
        sample_len=4000,
    )
    port = CTCModule.create(
        torch.Generator().manual_seed(0),
        Wav2Vec2Preprocess(mask_input=True),
        w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**SMALL)),
        LinearDecoder(len(TOKENS) + 1),
        BatchTextTransformer(TOKENS),
        device="cpu",
    )
    port.model.load_state_dict(from_flax_variables(_numpy(jax_module.variables)))
    return jax_module, port


def test_gelu_matches_jax():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 3.0
    x[:4] = [-7.0, -4.0, 4.0, 9.0]  # both clipped tails and the clip points
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(w2v._fast_gelu(xt).numpy(), np.asarray(jax_w2v._fast_gelu(jnp.asarray(x))), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(w2v.gelu(xt).numpy(), np.asarray(jax_w2v.gelu(jnp.asarray(x))), atol=1e-6, rtol=0)
    # bfloat16 compute takes the polynomial, as the JAX package serves
    xb = xt.to(torch.bfloat16)
    torch.testing.assert_close(w2v.gelu(xb), w2v._fast_gelu(xb), rtol=0, atol=0)
    torch.testing.assert_close(w2v.gelu(xt, torch.bfloat16), w2v._fast_gelu(xt), rtol=0, atol=0)


@pytest.mark.parametrize("mask_input", [True, False])
def test_preprocess_matches_jax(mask_input):
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((3, 5000)) * 0.2 + 0.05).astype(np.float32)
    lengths = np.array([5000, 3210, 17], np.int32)
    want, want_lens = JaxPreprocess(mask_input=mask_input).apply({}, jnp.asarray(audio), jnp.asarray(lengths))
    got, got_lens = Wav2Vec2Preprocess(mask_input=mask_input)(torch.as_tensor(audio), torch.as_tensor(lengths))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert float(got[1, 3210:].abs().max()) == 0.0


def test_bridge_covers_every_key(encoders):
    _, variables, port = encoders
    state = from_flax_variables(variables)
    assert set(state) == set(port.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == len(state)
    for path, value in flat:
        key = ".".join(p.key for p in path[1:])  # drop the "params" collection
        np.testing.assert_array_equal(state[key].numpy(), value)
    # flax's ``conv`` level is dropped only under a module named ``conv``; wav2vec2 has none
    assert any(k.startswith("feature_extractor.conv0.") for k in state) and "pos_conv.kernel" in state


def test_encoder_matches_jax(encoders):
    jax_encoder, variables, port = encoders
    audio, lengths = _audio(2)
    want, want_lens = jax_encoder.apply(variables, jnp.asarray(audio), jnp.asarray(lengths))
    with torch.no_grad():
        got, got_lens = port(torch.as_tensor(audio), torch.as_tensor(lengths))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape
    for i, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n], atol=1e-4, rtol=0)


def test_init_draws_flax_magnitudes(encoders):
    """Lecun-normal kernels (std sqrt(1 / fan_in)), unit norm scales, zero biases, as flax draws them."""
    _, variables, _ = encoders
    port = CTCModule.create(torch.Generator().manual_seed(3), Wav2Vec2Preprocess(),
                            w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**SMALL)), LinearDecoder(5), device="cpu")
    state = port.model.state_dict()
    for key in ("encoder.layer0.attention.qkv_proj.kernel", "encoder.layer1.intermediate_dense.kernel",
                "encoder.feature_extractor.conv1.kernel", "encoder.pos_conv.kernel", "decoder.dense.kernel"):
        got = state[key]
        fan_in = got[..., 0].numel()
        assert abs(got.std().item() * fan_in**0.5 - 1.0) < 0.1, key
        assert got.abs().max().item() <= 2.0 / 0.8796256610342398 / fan_in**0.5 + 1e-6, key
    flax_std = np.std(variables["params"]["layer0"]["attention"]["qkv_proj"]["kernel"])
    assert abs(state["encoder.layer0.attention.qkv_proj.kernel"].std().item() / flax_std - 1.0) < 0.05
    assert bool((state["encoder.layer0.final_layer_norm.scale"] == 1).all())
    assert bool((state["encoder.layer0.attention.qkv_proj.bias"] == 0).all())


def test_engine_matches_jax_engine(slice_pair):
    jax_module, port = slice_pair
    audio, lengths = _audio(4)
    want, want_lens = JaxEngine(jax_module, compute_dtype=jnp.float32)(audio, lengths)
    engine = InferenceEngine(port)
    assert engine.dtype == torch.float32
    got, got_lens = engine(audio, lengths)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    for i, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n], atol=1e-4, rtol=0)
    module_logits, _ = port.forward(audio, lengths)
    np.testing.assert_allclose(module_logits.numpy(), got.numpy(), atol=1e-5, rtol=0)


def test_predict_matches_jax(slice_pair):
    jax_module, port = slice_pair
    audio, lengths = _audio(5)
    jax_engine = JaxEngine(jax_module, compute_dtype=jnp.float32)
    want = jax_engine.predict(audio, lengths)
    assert InferenceEngine(port).predict(audio, lengths) == want
    assert port.predict(audio, lengths) == want
    clip = audio[1, :3000]
    assert InferenceEngine(port).predict(clip) == jax_engine.predict(clip)


def test_encoder_only_module_and_engine_match_jax():
    """``decoder=None`` (an encoder-only checkpoint): the module returns the encoder's output and the engine
    serves it as float32 logits, as the JAX package's ``CTCModel`` and its engine's ``dec_params is None``
    branch do."""
    jax_module = JaxModule.create(
        jax.random.PRNGKey(2),
        audio_transform=JaxPreprocess(mask_input=True),
        encoder=jax_w2v.Wav2Vec2Encoder(jax_w2v.Wav2Vec2Config(**SMALL), mask_input=True),
        decoder=None,
        sample_len=4000,
    )
    port = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                            w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**SMALL)), None, device="cpu")
    assert port.model.decoder is None
    port.model.load_state_dict(from_flax_variables(_numpy(jax_module.variables)))
    audio, lengths = _audio(6)
    want, want_lens = jax_module.forward(audio, lengths)
    got, got_lens = port.forward(audio, lengths)
    assert got.shape == np.asarray(want).shape and got.shape[-1] == SMALL["hidden_size"]
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    engine_want, _ = JaxEngine(jax_module, compute_dtype=jnp.float32)(audio, lengths)
    engine_got, engine_lens = InferenceEngine(port)(audio, lengths)
    assert engine_got.dtype == torch.float32
    np.testing.assert_array_equal(engine_lens.numpy(), np.asarray(want_lens))
    for i, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n], atol=1e-4, rtol=0)
        np.testing.assert_allclose(engine_got[i, :n].numpy(), np.asarray(engine_want)[i, :n], atol=1e-4, rtol=0)


def test_bf16_engine_matches_jax_bf16_engine(slice_pair, monkeypatch):
    """bfloat16 on the CPU: both kernels' plain versions and the polynomial gelu, against JAX's bf16 engine."""
    from thunder_tpu_torch.kernels import add_ln, attention

    calls = {"attention": 0, "add_ln": 0, "fast_gelu": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(attention, "mha_from_qkv_reference", counting("attention", attention.mha_from_qkv_reference))
    monkeypatch.setattr(add_ln, "add_layer_norm_reference", counting("add_ln", add_ln.add_layer_norm_reference))
    monkeypatch.setattr(w2v, "_fast_gelu", counting("fast_gelu", w2v._fast_gelu))
    jax_module, port = slice_pair
    audio, lengths = _audio(6)
    want, want_lens = JaxEngine(jax_module, compute_dtype=jnp.bfloat16)(audio, lengths)
    launches = [w.launches for w in KERNEL_WRAPPERS]
    engine = InferenceEngine(port, compute_dtype=torch.bfloat16)
    got, got_lens = engine(audio, lengths)
    assert [w.launches for w in KERNEL_WRAPPERS] == launches
    # 2 layers: 2 attentions; 2 x 2 + 1 add + LayerNorms; gelu after 3 convs, the pos conv and 2 FFNs
    assert calls == {"attention": 2, "add_ln": 5, "fast_gelu": 6}
    assert engine._encoder.layer0.attention.qkv_proj.kernel.dtype == torch.bfloat16
    assert engine._encoder.feature_extractor.gn.scale.dtype == torch.float32
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    want = np.asarray(want, np.float32)
    assert np.isfinite(got.numpy()).all()
    for i, n in enumerate(np.asarray(want_lens)):
        dev = np.abs(got[i, :n].numpy() - want[i, :n]).max() / np.abs(want[i, :n]).max()
        assert dev < 0.05, (i, dev)


@pytest.mark.parametrize("train", [False, True])
def test_add_layer_norm_takes_the_kernels_at_every_width(train, monkeypatch):
    """bfloat16 add + LayerNorm goes to the kernels at every width: 128 (its row in registers on the card), 36
    and 2056 (not a multiple of 8, over 2048: the kernels that re-read the row). Held to the JAX module in
    float32 on the same bf16 inputs, which adds in float32 as the kernels do, to one bf16 rounding."""
    calls = []
    for name in ("add_layer_norm", "add_ln_dropout_train"):
        def spy(*args, _name=name, _fn=getattr(w2v, name), **kwargs):
            calls.append((_name, args[0].shape[-1]))
            return _fn(*args, **kwargs)
        monkeypatch.setattr(w2v, name, spy)
    for d in (36, 2056, 128):
        rng = np.random.default_rng(d)
        x, y = ((rng.standard_normal((2, 5, d)) * 2).astype(np.float32) for _ in range(2))
        scale, bias = (rng.standard_normal(d).astype(np.float32) for _ in range(2))
        ln = w2v._AddLayerNorm(d, dtype=torch.bfloat16)
        with torch.no_grad():
            ln.scale.copy_(torch.as_tensor(scale))
            ln.bias.copy_(torch.as_tensor(bias))
        xb, yb = (torch.as_tensor(a).to(torch.bfloat16) for a in (x, y))
        got = ln(xb, yb, train=train, dropout_rate=0.0, generator=torch.Generator().manual_seed(0))
        assert got.dtype == torch.bfloat16 and got.shape == (2, 5, d)
        want = jax_w2v._AddLayerNorm(dtype=jnp.float32).apply(
            {"params": {"scale": scale, "bias": bias}}, jnp.asarray(xb.float().numpy()), jnp.asarray(yb.float().numpy()),
            train=train, dropout_rate=0.0)
        np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=2**-14,
                                   rtol=2**-7)
    kernel = "add_ln_dropout_train" if train else "add_layer_norm"
    assert calls == [(kernel, 36), (kernel, 2056), (kernel, 128)]


def test_bf16_encoder_of_width_36_serves_and_trains_on_the_cpu():
    """A width that is not a multiple of 8, in bfloat16: the forward and a backward run through the add +
    LayerNorm kernels' plain versions here (the card test holds the same model on the card to its CPU path)."""
    cfg = w2v.Wav2Vec2Config(**{**SMALL, "hidden_size": 36, "intermediate_size": 72})
    module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                              w2v.Wav2Vec2Encoder(cfg, dtype=torch.bfloat16), LinearDecoder(len(TOKENS) + 1),
                              device="cpu")
    encoder = module.model.encoder
    audio, lengths = (torch.as_tensor(a) for a in _audio(7))
    with torch.no_grad():
        h, _ = encoder(audio, lengths)
    assert h.shape[-1] == 36 and h.dtype == torch.bfloat16 and bool(torch.isfinite(h.float()).all())
    h, _ = encoder(audio, lengths, train=True, generator=torch.Generator().manual_seed(0))
    h.float().square().mean().backward()
    grad = encoder.layer0.layer_norm.scale.grad
    assert grad is not None and bool(torch.isfinite(grad).all()) and bool(grad.abs().sum() > 0)


def test_serving_copy_rounds_like_the_jax_engine(slice_pair):
    _, port = slice_pair
    encoder = port.model.encoder
    copy = w2v.serving_copy(encoder, torch.bfloat16)
    assert copy.dtype == torch.bfloat16 and copy.layer1.layer_norm.dtype == torch.bfloat16
    for key, value in copy.state_dict().items():
        original = encoder.state_dict()[key]
        if ".gn." in key:
            assert value.dtype == torch.float32 and torch.equal(value, original)
        elif key.endswith(("norm.scale", "norm.bias")):
            assert value.dtype == torch.float32 and torch.equal(value, original.to(torch.bfloat16).float()), key
        else:
            assert value.dtype == torch.bfloat16 and torch.equal(value, original.to(torch.bfloat16)), key


@pytest.mark.parametrize(
    "flag", [dict(sew_style=True), dict(add_adapter=True), dict(adapter_attn_dim=16), dict(pos_conv_stack=True),
             dict(rel_pos_buckets=320)],
    ids=lambda d: next(iter(d)),
)
def test_unported_config_flags_raise(flag):
    with pytest.raises(NotImplementedError, match=next(iter(flag))):
        w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**SMALL, **flag))


def test_unported_modes_raise():
    encoder = w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**SMALL))
    # remat is ported (tests/test_torch_remat.py): it builds, with or without the frozen extractor, and keeps
    # the parameter tree
    for frozen in (False, True):
        remat = w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**SMALL), remat=True, freeze_feature_extractor=frozen)
        assert remat.remat and list(remat.state_dict()) == list(encoder.state_dict())
    audio, lengths = (torch.as_tensor(a) for a in _audio())
    # train mode runs; with dropout rates above 0 it draws from an explicit generator and raises without one
    with pytest.raises(ValueError, match="generator"):
        encoder(audio, lengths, train=True)
    with pytest.raises(ValueError, match="generator"):
        encoder.layer0.layer_norm(torch.zeros(1, 2, 128), torch.zeros(1, 2, 128), train=True, dropout_rate=0.1)
    with pytest.raises(NotImplementedError, match="WavLM"):
        encoder.layer0.attention(torch.zeros(1, 2, 128), torch.tensor([2]), position_bias=torch.zeros(2, 2, 2))
    with pytest.raises(ValueError, match="feat_extract_norm"):
        w2v.Wav2Vec2Config(feat_extract_norm="batch")
