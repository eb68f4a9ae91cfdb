"""The wav2vec2 family's variants in the port against the JAX package (CPU).

Each variant is a small encoder (hidden 32, 4 heads, 2 layers, FFN 64, a
3-conv extractor of 16 channels, a k=16 positional conv in 4 groups, as
``tests/wav2vec2/test_hf_families.py`` sizes them) initialised in the JAX
package; its variables go through the bridge into the port, and both run the
same numpy audio (2 x 4000 samples, lengths 4000 and 2900):

- WavLM (relative position bias, 32 buckets, distance 40), post-LN and
  stable-LN; data2vec-audio (3 positional convs of kernel 7, and of kernel 6,
  whose trailing frame is trimmed); SEW at (conv_dim[-1], squeeze_factor)
  (16, 2) and (32, 4), with a kernel-1 extractor conv; the conv adapter
  (output_hidden_size 32 and 24); MMS's attention adapter.
- float32 eval: identical lengths, hidden states within 1e-4 on valid frames.
- bfloat16 engine against the JAX bf16 engine: identical lengths, logits
  within 0.05 of their largest magnitude (the two round at different points,
  as ``tests/test_torch_wav2vec2.py`` holds the base model).
- Inference bundles written by the JAX package and by the port load through
  the port's ``load_inference_bundle``, bit-equal to the module.
- The engine's modes (``posconv_dense``, ``int8_weights``, ``int8_compute``)
  on WavLM, SEW and MMS in bfloat16, at the same bound.
- Train mode with every dropout rate 0: the CTC loss at rtol 1e-5 and every
  parameter's gradient within 1e-4 of ``jax.grad``'s, for WavLM and SEW.
- WavLM's buckets: integer-equal to the JAX function's for T up to 3,000 at
  (320, 800).
- ``batch_invariant`` on the wav2vec2 engine: each row of a batch equal to
  the row alone, bit for bit.
- ``remat`` on the variants: the loss's gradients bit-equal to the run
  without it; bfloat16 train mode finite.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu.export as jax_export
from thunder_tpu.audio import Wav2Vec2Preprocess as JaxPreprocess
from thunder_tpu.engine import InferenceEngine as JaxEngine
from thunder_tpu.models import LinearDecoder as JaxLinearDecoder
from thunder_tpu.models import wav2vec2 as jax_w2v
from thunder_tpu.module import CTCModel
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.training.trainer import _encode_targets as jax_encode_targets
from thunder_tpu_torch import export
from thunder_tpu_torch.audio import Wav2Vec2Preprocess
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.engine import InferenceEngine
from thunder_tpu_torch.models import LinearDecoder, layers
from thunder_tpu_torch.models import wav2vec2 as w2v
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer

torch.set_num_threads(2)

TOKENS = list("abcdefghijklmnopqrstuvwxyz '")
TEXTS = ["hello world", "the cat"]
SMALL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64, conv_dim=(16, 16, 16),
             conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4)
STABLE = dict(feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True)
SEW_EXTRACTOR = dict(conv_kernel=(10, 3, 1, 3), conv_stride=(5, 2, 1, 2))
VARIANTS = {
    "wavlm": dict(rel_pos_buckets=32, rel_pos_max_distance=40),
    "wavlm_stable": dict(rel_pos_buckets=32, rel_pos_max_distance=40, **STABLE),
    "data2vec": dict(feat_extract_norm="layer", pos_conv_stack=True, num_conv_pos_embeddings=3, conv_pos_kernel_size=7),
    "data2vec_even": dict(feat_extract_norm="layer", pos_conv_stack=True, num_conv_pos_embeddings=3,
                          conv_pos_kernel_size=6),
    "sew_16_2": dict(sew_style=True, squeeze_factor=2, conv_dim=(16, 16, 16, 16), **SEW_EXTRACTOR),
    "sew_32_4": dict(sew_style=True, squeeze_factor=4, conv_dim=(16, 16, 16, 32), **SEW_EXTRACTOR),
    "adapter_32": dict(add_adapter=True, output_hidden_size=32, num_adapter_layers=2, **STABLE),
    "adapter_24": dict(add_adapter=True, output_hidden_size=24, num_adapter_layers=2, **STABLE),
    "mms": dict(adapter_attn_dim=8, **STABLE),
}
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0)
MODES = {"posconv_dense": dict(posconv_dense=True), "int8_weights": dict(int8_weights=True),
         "int8_compute": dict(int8_compute=True)}


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32), np.array([4000, 2900], np.int32)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(variant: str, **extra):
    """The JAX module, initialised as ``CTCModule.create`` does but under one ``jax.jit`` (a fifth of the eager
    init's time), and the port's module with its variables through the bridge."""
    config = {**SMALL, **VARIANTS[variant], **extra}
    tt = JaxText(tokens=TOKENS)
    model = CTCModel(audio_transform=JaxPreprocess(mask_input=True),
                     encoder=jax_w2v.Wav2Vec2Encoder(jax_w2v.Wav2Vec2Config(**config), mask_input=True),
                     decoder=JaxLinearDecoder(num_classes=tt.num_tokens))
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(1), jnp.zeros((2, 4000)), jnp.array([4000, 2000], jnp.int32), train=False)
    jax_module = JaxModule(model=model, variables=dict(variables), text_transform=tt,
                           encoder_final_dimension=model.encoder.final_dimension)
    port = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                            w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**config)), LinearDecoder(len(TOKENS) + 1),
                            BatchTextTransformer(TOKENS), device="cpu")
    port.model.load_state_dict(from_flax_variables(_numpy(jax_module.variables)))
    return jax_module, port


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return request.param, *_pair(request.param)


def _compare(got, got_lens, want, want_lens, bound):
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    valid = np.arange(want.shape[1])[None, :] < np.asarray(want_lens)[:, None]
    dev = np.abs(got[valid] - want[valid]).max() / np.abs(want[valid]).max()
    assert np.isfinite(got).all() and dev <= bound, dev


def test_encoder_matches_jax_in_float32(pair):
    name, jax_module, port = pair
    audio, lengths = _audio(2)
    encoder = jax_module.model.encoder
    variables = {"params": jax_module.variables["params"]["encoder"]}
    want, want_lens = jax.jit(encoder.apply)(variables, jnp.asarray(audio), jnp.asarray(lengths))
    with torch.no_grad():
        got, got_lens = port.model.encoder(torch.as_tensor(audio), torch.as_tensor(lengths))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape and got.shape[-1] == port.encoder_final_dimension == encoder.final_dimension
    for i, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n], atol=1e-4, rtol=0)
    assert set(port.model.state_dict()) == set(from_flax_variables(_numpy(jax_module.variables)))


def test_bundles_of_both_packages_load_in_the_port(pair, tmp_path):
    """A bundle written by the JAX package and one written by the port: the same ``config.json``, and each loads
    through the port's ``load_inference_bundle`` with the port module's weights and logits, bit for bit."""
    name, jax_module, port = pair
    jax_dir = Path(jax_export.save_inference_bundle(str(tmp_path / "jax"), jax_module))
    port_dir = Path(export.save_inference_bundle(str(tmp_path / "port"), port))
    config = json.loads((jax_dir / "config.json").read_text())
    assert json.loads((port_dir / "config.json").read_text()) == config
    assert config["encoder"]["config"] == {k: list(v) if isinstance(v, tuple) else v
                                           for k, v in vars(port.model.encoder.config).items()}
    audio, lengths = _audio(7)
    want, want_lengths = port.forward(audio, lengths)
    for directory in (jax_dir, port_dir):
        restored = export.load_inference_bundle(str(directory), device="cpu")
        for key, value in port.model.state_dict().items():
            assert torch.equal(restored.model.state_dict()[key], value), key
        got, got_lengths = restored.forward(audio, lengths)
        assert torch.equal(got, want) and torch.equal(got_lengths, want_lengths)


def test_bf16_engine_matches_jax_bf16_engine(pair):
    name, jax_module, port = pair
    audio, lengths = _audio(3)
    want, want_lens = JaxEngine(jax_module, compute_dtype=jnp.bfloat16)(audio, lengths)
    engine = InferenceEngine(port, compute_dtype=torch.bfloat16)
    got, got_lens = engine(audio, lengths)
    _compare(got, got_lens, want, want_lens, 0.05)
    if name.startswith("wavlm"):  # rounded through bf16, applied in float32
        assert engine._encoder.rel_attn_embed.dtype == torch.bfloat16
        gate = engine._encoder.layer0.attention.gru_rel_pos_linear
        assert gate.kernel.dtype == torch.bfloat16 and gate.dtype == torch.float32


@pytest.fixture(scope="module", params=["wavlm", "sew_16_2", "mms"])
def mode_pair(request):
    return request.param, *_pair(request.param)


@pytest.mark.parametrize("mode", list(MODES))
def test_modes_in_bfloat16_match_the_jax_engine(mode_pair, mode):
    name, jax_module, port = mode_pair
    audio, lengths = _audio(4)
    want, want_lens = JaxEngine(jax_module, compute_dtype=jnp.bfloat16, **MODES[mode])(audio, lengths)
    engine = InferenceEngine(port, compute_dtype=torch.bfloat16, **MODES[mode])
    got, got_lens = engine(audio, lengths)
    _compare(got, got_lens, want, want_lens, 0.05)
    enc = engine._encoder
    if mode == "posconv_dense":  # the fold keeps SEW's stride
        assert enc.pos_conv.groups == 1 and enc.pos_conv.stride == port.model.encoder.pos_conv.stride
    if mode == "int8_weights":  # every 2-D kernel, and SEW's kernel-1 extractor conv
        quantized = [type(m).__name__ for m in enc.modules() if isinstance(m, (w2v._Int8Dense, w2v._Int8Conv))]
        dense = [m for m in port.model.encoder.modules() if isinstance(m, w2v.Dense)]
        assert quantized.count("_Int8Dense") == len(dense)
        assert quantized.count("_Int8Conv") == (1 if name.startswith("sew") else 0)
        if name == "wavlm":
            gate = enc.layer0.attention.gru_rel_pos_linear
            assert gate.dtype == torch.float32 and gate.weight_dtype == torch.bfloat16
    if mode == "int8_compute":
        assert isinstance(enc.layer0.attention.qkv_proj, w2v._Int8Dense) and enc.layer0.attention.qkv_proj.compute


@pytest.mark.parametrize("variant", ["wavlm", "sew_16_2"])
def test_train_mode_gradients_match_jax(variant):
    jax_module, port = _pair(variant, **NO_DROPOUT)
    audio, lengths = _audio(5)
    targets, target_lengths = jax_encode_targets(jax_module.text_transform, TEXTS)
    args = (jnp.asarray(audio), jnp.asarray(lengths), jnp.asarray(targets), jnp.asarray(target_lengths))

    def jax_loss(params):
        return jax_module.loss({"params": params}, *args, train=True, rngs={"dropout": jax.random.PRNGKey(0)})[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(jax_module.variables["params"])
    got_loss, _ = port.loss(audio, lengths, targets, target_lengths, train=True)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    want = from_flax_variables(_numpy({"params": want_grads}))
    got = {k: p.grad for k, p in port.model.named_parameters()}
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=1e-4, rtol=0, err_msg=key)


def test_wavlm_buckets_match_jax():
    embed = np.arange(320, dtype=np.float32)[:, None]  # one head whose bias is the bucket's index
    jax_bias = jax.jit(jax_w2v._wavlm_position_bias, static_argnums=(1, 2, 3))
    for t in (1, 3000):  # a bucket depends on key - query alone: T = 3,000 holds every distance below it
        want = np.asarray(jax_bias(jnp.asarray(embed), t, 320, 800))[0]
        got = w2v._wavlm_position_bias(torch.as_tensor(embed), t, 320, 800)[0]
        np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
        np.testing.assert_array_equal(w2v._wavlm_buckets(t, 320, 800).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("variant", ["base", "wavlm"])
def test_batch_invariant_engine_rows_equal_the_row_alone(variant):
    """Each row of a batch bit-equal to the row served alone, on one CPU thread (the CPU's multithreaded products
    are not reproducible from run to run on a loaded machine); within 1e-5 (float32) and 0.05 (bfloat16) of the
    default engine's scale."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = {**SMALL, **(VARIANTS[variant] if variant != "base" else {})}
        port = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                                w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**config)), LinearDecoder(len(TOKENS) + 1),
                                BatchTextTransformer(TOKENS), device="cpu")
        rng = np.random.default_rng(6)
        audio = (rng.standard_normal((4, 4000)) * 0.3).astype(np.float32)
        lengths = np.array([4000, 2900, 0, 1500], np.int32)  # a length-0 row (a pool's padding) is not run
        for dtype in (torch.float32, torch.bfloat16):
            engine = InferenceEngine(port, compute_dtype=dtype, batch_invariant=True)
            logits, preds, out_lengths = engine.infer(audio, lengths)
            default, _, _ = InferenceEngine(port, compute_dtype=dtype).infer(audio, lengths)
            for r in range(4):
                alone = engine.infer(audio[r: r + 1], lengths[r: r + 1])
                assert torch.equal(logits[r: r + 1], alone[0]) and torch.equal(preds[r: r + 1], alone[1])
                assert torch.equal(out_lengths[r: r + 1], alone[2])
                n = int(out_lengths[r])
                if lengths[r] == 0:
                    assert n <= 0 and not logits[r].any() and not preds[r].any()
                    continue
                bound = 1e-5 if dtype == torch.float32 else 0.05
                np.testing.assert_allclose(logits[r, :n].float().numpy(), default[r, :n].float().numpy(),
                                           atol=bound * float(default[r, :n].abs().max()), rtol=0)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("variant", ["wavlm", "sew_16_2", "mms", "adapter_24", "data2vec"])
def test_remat_and_bfloat16_train_mode(variant):
    """``remat`` recomputes each layer, WavLM's shared bias passed in, with the loss and gradients of the run
    without it, bit for bit (one CPU thread, HF's default dropout rates from one generator); bfloat16 train mode
    (the training kernels' plain versions, WavLM's biased attention unfused) gives a finite loss and gradients."""
    config = {**SMALL, **VARIANTS[variant]}
    audio, lengths = (torch.as_tensor(a) for a in _audio(8))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        grads = []
        for remat in (False, True):
            encoder = w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**config), remat=remat)
            layers.init_parameters(encoder, torch.Generator().manual_seed(0))
            h, out_lengths = encoder(audio, lengths, train=True, generator=torch.Generator().manual_seed(1))
            (h.square().mean()).backward()
            grads.append({k: p.grad.clone() for k, p in encoder.named_parameters()})
        assert grads[0].keys() == grads[1].keys()
        for key in grads[0]:
            assert torch.equal(grads[0][key], grads[1][key]), key
        encoder = w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**config), dtype=torch.bfloat16, remat=True)
        layers.init_parameters(encoder, torch.Generator().manual_seed(0))
        h, _ = encoder(audio, lengths, train=True, generator=torch.Generator().manual_seed(1))
        h.float().square().mean().backward()
        assert h.dtype == torch.bfloat16 and bool(torch.isfinite(h.float()).all())
        for key, p in encoder.named_parameters():
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), key
    finally:
        torch.set_num_threads(threads)
