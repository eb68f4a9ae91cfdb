"""The port's attention at heads of 80 against the JAX package's flash route (CPU).

The JAX module sends every head width other than 64 through
``thunder_tpu.models.wav2vec2._flash_mha`` (jax's Pallas TPU flash attention,
forward and ``custom_vjp`` backward) on the TPU; the port runs its dh-80
kernels there (``kernels.attention.mha_from_qkv``, ``kernels.attention_train.
mha_train``), whose plain versions run here. The JAX side runs the Pallas
kernels in interpret mode under ``jax.jit``, as ``tests/wav2vec2/
test_wav2vec2.py`` runs ``_flash_mha``. Inputs come from numpy seeds.

- The attention alone, float32, B 2, T 256, 2 heads of 80, lengths [256,
  170], q scaled by ``dh**-0.5`` before ``_flash_mha`` as the JAX module
  does: the forward (serving and training wrappers) and the gradients with
  respect to q, k and v (``jax.grad``; the cotangent zero on padded queries),
  within 1e-5 on valid rows. ``_flash_mha``'s padded queries attend only the
  padding and the port's attend the valid keys, so padded rows differ.
- An MMS-like encoder (hidden 160, 2 heads of 80, 2 layers, FFN 320, stable
  LN, attention adapters of 16) in bfloat16, the JAX encoder routed through
  ``_flash_mha`` (``jax.default_backend`` patched to ``"tpu"``,
  ``THUNDER_FLASH_MIN_SEQ`` set to 1), the same weights through the bridge:
  the serving logits on valid frames within 0.05 of their largest magnitude
  (the bound ``tests/test_torch_wav2vec2_variants.py`` holds bf16 engines to:
  the two packages round at different points), and in train mode with every
  dropout rate 0 the CTC loss within 1 % and each parameter's gradient within
  0.05 of that parameter's largest JAX gradient (measured on this CPU: 0.0065
  for the logits, 0.03 % for the loss and at most 0.015 for a gradient).
  Both routes are counted: every layer's attention goes through
  ``_flash_mha`` on one side and the port's kernel wrappers on the other.
- ``_Attention``'s route at dh 80 (and 64), by counting the wrappers' calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from thunder_tpu.audio import Wav2Vec2Preprocess as JaxPreprocess
from thunder_tpu.models import LinearDecoder as JaxLinearDecoder
from thunder_tpu.models import wav2vec2 as jax_w2v
from thunder_tpu.module import CTCModel
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.training.trainer import _encode_targets as jax_encode_targets
from thunder_tpu_torch.audio import Wav2Vec2Preprocess
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.kernels.attention import mha_from_qkv
from thunder_tpu_torch.kernels.attention_train import mha_train, mha_train_forward
from thunder_tpu_torch.models import LinearDecoder
from thunder_tpu_torch.models import wav2vec2 as w2v
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer

torch.set_num_threads(2)

B, T, HEADS, DH = 2, 256, 2, 80
LENGTHS = [256, 170]
TOKENS = list("abcdefghijklmnopqrstuvwxyz '")
TEXTS = ["hello world", "the cat"]
MMS_SMALL = dict(hidden_size=160, num_hidden_layers=2, num_attention_heads=2, intermediate_size=320,
                 conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4, feat_extract_norm="layer", do_stable_layer_norm=True,
                 conv_bias=True, adapter_attn_dim=16, hidden_dropout=0.0, attention_dropout=0.0,
                 feat_proj_dropout=0.0)


def _heads(seed):
    """q, k, v ``(B, T, HEADS, DH)`` float32, the key mask and a cotangent zero on padded queries."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, HEADS, DH)).astype(np.float32) * 0.3 for _ in range(3))
    valid = np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]
    ct = rng.standard_normal((B, T, HEADS, DH)).astype(np.float32) * valid[:, :, None, None]
    return q, k, v, valid, ct


def _packed(q, k, v):
    return torch.as_tensor(np.concatenate([a.reshape(B, T, HEADS * DH) for a in (q, k, v)], axis=-1))


def _assert_valid_rows_close(got, want, atol):
    for b, n in enumerate(LENGTHS):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=atol, rtol=0)


def test_attention_at_heads_of_80_matches_flash_mha():
    q, k, v, valid, _ = _heads(0)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax_w2v._flash_mha)(jnp.asarray(q) * DH**-0.5, jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(valid))
    want = np.asarray(want).reshape(B, T, HEADS * DH)
    qkv, lens = _packed(q, k, v), torch.tensor(LENGTHS, dtype=torch.int32)
    seed = torch.zeros(1, dtype=torch.int32)
    for got in (mha_from_qkv(qkv, lens, HEADS), mha_train_forward(qkv, lens, seed, HEADS)[0]):
        assert got.shape == (B, T, HEADS * DH)
        _assert_valid_rows_close(got.numpy(), want, 1e-5)


def test_attention_gradients_at_heads_of_80_match_flash_mha():
    q, k, v, valid, ct = _heads(1)

    def loss(q, k, v):
        return jnp.sum(jax_w2v._flash_mha(q * DH**-0.5, k, v, jnp.asarray(valid)) * ct)

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qkv = _packed(q, k, v).requires_grad_(True)
    out = mha_train(qkv, torch.tensor(LENGTHS, dtype=torch.int32), torch.zeros(1, dtype=torch.int32), HEADS, 0.0)
    (out * torch.as_tensor(ct.reshape(B, T, HEADS * DH))).sum().backward()
    for got, w in zip(qkv.grad.split(HEADS * DH, dim=-1), want):
        _assert_valid_rows_close(got.numpy(), np.asarray(w).reshape(B, T, HEADS * DH), 1e-5)


def _count(monkeypatch, module, name: str) -> list:
    """Replace ``module.name`` by a wrapper that records each call; returns the record."""
    calls, fn = [], getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.fixture()
def mms_pair(monkeypatch):
    """A JAX ``CTCModule`` of ``MMS_SMALL`` in bfloat16 routed through ``_flash_mha`` (counted), and the port's
    bfloat16 module with the same weights through the bridge, its kernel wrappers counted."""
    tt = JaxText(tokens=TOKENS)
    config = jax_w2v.Wav2Vec2Config(**MMS_SMALL)
    model = CTCModel(audio_transform=JaxPreprocess(mask_input=False),
                     encoder=jax_w2v.Wav2Vec2Encoder(config, mask_input=False, dtype=jnp.bfloat16),
                     decoder=JaxLinearDecoder(num_classes=tt.num_tokens, dtype=jnp.bfloat16))
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(3), jnp.zeros((2, 4000)), jnp.array([4000, 2000], jnp.int32), train=False)
    jax_module = JaxModule(model=model, variables=dict(variables), text_transform=tt,
                           encoder_final_dimension=model.encoder.final_dimension)
    port = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=False),
                            w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**MMS_SMALL), dtype=torch.bfloat16),
                            LinearDecoder(len(TOKENS) + 1, dtype=torch.bfloat16), BatchTextTransformer(TOKENS),
                            device="cpu")
    port.model.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, dict(variables))))
    monkeypatch.setenv("THUNDER_FLASH_MIN_SEQ", "1")
    monkeypatch.setattr(jax_w2v.jax, "default_backend", lambda: "tpu")
    calls = {"flash": _count(monkeypatch, jax_w2v, "_flash_mha"), "mha_from_qkv": _count(monkeypatch, w2v, "mha_from_qkv"),
             "mha_train": _count(monkeypatch, w2v, "mha_train")}
    return jax_module, port, calls


def _audio(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32), np.array([4000, 2900], np.int32)


def test_mms_like_encoder_serves_as_the_jax_flash_route(mms_pair):
    jax_module, port, calls = mms_pair
    audio, lengths = _audio(4)
    with pltpu.force_tpu_interpret_mode():
        want, want_lens = jax.jit(jax_module.model.apply, static_argnames="train")(
            jax_module.variables, jnp.asarray(audio), jnp.asarray(lengths), train=False)
    with torch.no_grad():
        got, got_lens = port.model(torch.as_tensor(audio), torch.as_tensor(lengths))
    assert len(calls["flash"]) == len(calls["mha_from_qkv"]) == MMS_SMALL["num_hidden_layers"]
    assert not calls["mha_train"]
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    want, got = np.asarray(want, np.float32), got.float().numpy()
    valid = np.arange(want.shape[1])[None, :] < np.asarray(want_lens)[:, None]
    dev = np.abs(got[valid] - want[valid]).max() / np.abs(want[valid]).max()
    assert np.isfinite(got).all() and dev <= 0.05, dev


def test_mms_like_encoder_trains_as_the_jax_flash_route(mms_pair):
    jax_module, port, calls = mms_pair
    audio, lengths = _audio(5)
    targets, target_lengths = jax_encode_targets(jax_module.text_transform, TEXTS)
    args = (jnp.asarray(audio), jnp.asarray(lengths), jnp.asarray(targets), jnp.asarray(target_lengths))

    def jax_loss(params):
        return jax_module.loss({"params": params}, *args, train=True, rngs={"dropout": jax.random.PRNGKey(0)})[0]

    with pltpu.force_tpu_interpret_mode():
        want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(jax_module.variables["params"])
    got_loss, _ = port.loss(audio, lengths, targets, target_lengths, train=True)
    got_loss.backward()
    assert len(calls["flash"]) == len(calls["mha_train"]) == MMS_SMALL["num_hidden_layers"]
    assert not calls["mha_from_qkv"]
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-2)
    want = from_flax_variables(jax.tree_util.tree_map(np.asarray, {"params": want_grads}))
    got = {k: p.grad for k, p in port.model.named_parameters()}
    assert set(got) == set(want)
    for key, value in want.items():
        dev = (got[key].float() - value).abs().max().item() / max(value.abs().max().item(), 1e-12)
        assert dev <= 0.05, (key, dev)


@pytest.mark.parametrize("dh,train,rate,route", [
    (80, False, 0.1, "mha_from_qkv"), (80, True, 0.0, "mha_train"), (80, True, 0.1, None),
    (64, False, 0.1, "mha_from_qkv"), (64, True, 0.1, "mha_train"), (64, True, 0.0, "mha_train"),
    (96, False, 0.0, None), (96, True, 0.0, None),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_routes_by_head_width_mode_and_rate(monkeypatch, dh, train, rate, route, dtype):
    """bfloat16 without a position bias takes the kernels' wrappers at dh 64 and, at dh 80, in eval mode and in
    train mode at attention dropout 0 (the JAX module's flash gate); every other case, and float32, the unfused
    path."""
    calls = {name: _count(monkeypatch, w2v, name) for name in ("mha_from_qkv", "mha_train")}
    cfg = w2v.Wav2Vec2Config(hidden_size=2 * dh, num_attention_heads=2, attention_dropout=rate)
    attention = w2v._Attention(cfg, dtype=dtype)
    rng = np.random.default_rng(dh)
    with torch.no_grad():
        for p in attention.parameters():
            p.copy_(torch.as_tensor(rng.standard_normal(p.shape).astype(np.float32) * 0.05))
    x = torch.as_tensor(rng.standard_normal((2, 9, 2 * dh)).astype(np.float32)).to(dtype)
    out = attention(x, torch.tensor([9, 5]), train=train, generator=torch.Generator().manual_seed(0))
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    want = route if dtype == torch.bfloat16 else None
    assert {name: len(c) for name, c in calls.items()} == {name: int(name == want) for name in calls}
