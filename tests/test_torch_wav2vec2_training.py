"""wav2vec2 training in the port against the JAX package (CPU).

The small wav2vec2 of ``test_torch_wav2vec2.py`` (hidden 128, 2 heads of 64,
2 layers, a 3-conv extractor) is initialised in the JAX package, its variables
go through the bridge into the port, and both take the same numpy audio (2 x
4000 samples, lengths 4000 and 2900) and texts.

- With every dropout rate 0 the two packages compute the same function, so
  the train-mode loss and one whole train step (``TrainStep`` against
  ``make_train_step`` with optax AdamW, lr 1e-3, weight decay 1e-2) are
  compared on every parameter, with the extractor frozen and trained. In
  float32: loss at rtol 1e-5; gradients, read from both optimizers' first
  moments, at 2e-5 of the largest gradient; parameters after the step at 2e-6
  where the gradient is at least 1e-3 of the largest and within the Adam step
  bound 2 * lr elsewhere (a first Adam step moves a weight by lr * g / (|g| +
  1e-8), and the sign of a gradient at float32 noise is arbitrary). A frozen
  extractor has zero gradients in JAX and still decays by lr * wd * w: its
  parameters are held at 1e-7. In bfloat16 the two round at different places
  (the port's plain kernels add and keep scores in float32, JAX's CPU path is
  unfused, and its loss comes out at bf16 spacing): loss at rtol 0.05, gradients at 0.1 of the largest
  gradient.
- With HF's default rates the masks differ by design (the generators are
  other generators): the loss is finite, one seed gives one loss, another seed
  another, and eval mode does not read the rates. Each dropout site is held
  to JAX given an injected mask.
- ``migrate_fused_qkv`` equals the JAX function on a params tree and on a
  namedtuple moment tree.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.audio import Wav2Vec2Preprocess as JaxPreprocess
from thunder_tpu.models import LinearDecoder as JaxLinearDecoder
from thunder_tpu.models import wav2vec2 as jax_w2v
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.training.checkpointing import migrate_fused_qkv as jax_migrate_fused_qkv
from thunder_tpu.training.optim import adamw as jax_adamw
from thunder_tpu.training.trainer import TrainState, make_train_step
from thunder_tpu.training.trainer import _encode_targets as jax_encode_targets
from thunder_tpu_torch.audio import Wav2Vec2Preprocess
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.kernels import KERNEL_WRAPPERS
from thunder_tpu_torch.models import LinearDecoder
from thunder_tpu_torch.models import layers
from thunder_tpu_torch.models import wav2vec2 as w2v
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer
from thunder_tpu_torch.training.checkpointing import migrate_fused_qkv
from thunder_tpu_torch.training.optim import adamw
from thunder_tpu_torch.training.trainer import Trainer, TrainStep, _encode_targets

torch.set_num_threads(2)

TOKENS = list("abcdefghijklmnopqrstuvwxyz '")
TEXTS = ["hello world", "the cat"]
SMALL = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
             conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4)
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0)
LR = 1e-3


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32), np.array([4000, 2900], np.int32)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_module(dtype=jnp.float32, freeze=True, **config):
    tt = JaxText(tokens=TOKENS)
    return JaxModule.create(
        jax.random.PRNGKey(1),
        audio_transform=JaxPreprocess(mask_input=False),
        encoder=jax_w2v.Wav2Vec2Encoder(jax_w2v.Wav2Vec2Config(**SMALL, **config), mask_input=False, dtype=dtype,
                                        freeze_feature_extractor=freeze),
        decoder=JaxLinearDecoder(num_classes=tt.num_tokens, dtype=dtype),
        text_transform=tt,
        sample_len=4000,
    )


def _port_module(state=None, dtype=torch.float32, freeze=True, **config):
    port = CTCModule.create(
        torch.Generator().manual_seed(0),
        Wav2Vec2Preprocess(mask_input=False),
        w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**SMALL, **config), dtype=dtype, freeze_feature_extractor=freeze),
        LinearDecoder(len(TOKENS) + 1, dtype=dtype),
        BatchTextTransformer(TOKENS),
        device="cpu",
    )
    if state is not None:
        port.model.load_state_dict(state)
    return port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "no-freeze"])
def test_one_train_step_matches_jax_on_every_parameter(freeze, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jax_module = _jax_module(jdt, freeze, **NO_DROPOUT)
    variables = _numpy(jax_module.variables)
    port = _port_module(from_flax_variables(variables), tdt, freeze, **NO_DROPOUT)
    audio, lengths = _audio()
    targets, target_lengths = jax_encode_targets(jax_module.text_transform, TEXTS)
    port_targets, port_target_lengths = _encode_targets(port.text_transform, TEXTS)
    np.testing.assert_array_equal(port_targets, targets)

    # the train-mode loss, before any step
    args = (jnp.asarray(audio), jnp.asarray(lengths), jnp.asarray(targets), jnp.asarray(target_lengths))
    want_loss, _ = jax_module.loss(jax_module.variables, *args, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
    got_loss, _ = port.loss(audio, lengths, targets, target_lengths, train=True)
    loss_rtol = 1e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=loss_rtol)

    state = TrainState.create(apply_fn=jax_module.model.apply, params=jax.tree_util.tree_map(jnp.array, variables["params"]),
                              tx=jax_adamw(learning_rate=LR), batch_stats=None)
    state, step_loss = make_train_step(jax_module.model, jax_module.blank_idx)(state, *args, jax.random.PRNGKey(0))
    want = from_flax_variables(_numpy({"params": state.params}))
    want_grads = {k: v / 0.1 for k, v in from_flax_variables(_numpy({"params": state.opt_state[0].mu})).items()}

    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    optimizer = adamw(port.model.parameters(), learning_rate=LR)
    launches = [w.launches for w in KERNEL_WRAPPERS]
    loss = TrainStep(port.model, optimizer, port.blank_idx)(
        torch.tensor(audio), torch.tensor(lengths), torch.tensor(port_targets), torch.tensor(port_target_lengths), None)
    assert [w.launches for w in KERNEL_WRAPPERS] == launches  # the CPU runs the plain versions
    np.testing.assert_allclose(loss.item(), float(step_loss), rtol=loss_rtol)

    got = port.model.state_dict()
    assert set(got) == set(want)
    g_max = max(v.abs().max().item() for v in want_grads.values())
    grad_atol = (2e-5 if dtype == "float32" else 0.1) * g_max
    for name, p in port.model.named_parameters():
        g = optimizer.state[p]["exp_avg"] / 0.1
        frozen = freeze and name.startswith("encoder.feature_extractor.")
        if frozen:
            # JAX's stop_gradient gives zero gradients, and optax's adamw still decays the weights
            assert float(want_grads[name].abs().max()) == 0.0 and float(g.abs().max()) == 0.0, name
            torch.testing.assert_close(got[name], want[name], rtol=0, atol=1e-7, msg=name)
            torch.testing.assert_close(got[name], before[name] * (1 - LR * 1e-2), rtol=0, atol=1e-7, msg=name)
            continue
        torch.testing.assert_close(g, want_grads[name], rtol=0, atol=grad_atol, msg=name)
        assert (got[name] - want[name]).abs().max().item() <= 2 * LR + 1e-6, name
        if dtype == "float32":
            strong = want_grads[name].abs() >= 1e-3 * g_max
            torch.testing.assert_close(got[name][strong], want[name][strong], rtol=0, atol=2e-6, msg=name)
    if freeze:
        assert not torch.equal(got["encoder.feature_extractor.conv0.kernel"], before["encoder.feature_extractor.conv0.kernel"])
    else:
        assert float(want_grads["encoder.feature_extractor.conv0.kernel"].abs().max()) > 0


@pytest.fixture(scope="module")
def default_rates_port():
    variables = _numpy(_jax_module().variables)
    return from_flax_variables(variables)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_dropout_rates_give_a_finite_seeded_loss(default_rates_port, dtype):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    port = _port_module(default_rates_port, tdt)
    cfg = port.model.encoder.config
    assert (cfg.hidden_dropout, cfg.attention_dropout, cfg.feat_proj_dropout) == (0.1, 0.1, 0.1)  # HF's defaults
    audio, lengths = _audio(1)
    targets, target_lengths = _encode_targets(port.text_transform, TEXTS)
    loss = lambda seed: port.loss(audio, lengths, targets, target_lengths, train=True,  # noqa: E731
                                  generator=torch.Generator().manual_seed(seed))[0].item()
    first = loss(0)
    assert np.isfinite(first)
    assert loss(0) == first and loss(1) != first
    with pytest.raises(ValueError, match="generator"):
        port.loss(audio, lengths, targets, target_lengths, train=True)
    # eval mode reads no rate: the logits equal those of the same weights with every rate 0
    quiet = _port_module(default_rates_port, tdt, **NO_DROPOUT)
    assert torch.equal(port.forward(audio, lengths)[0], quiet.forward(audio, lengths)[0])
    # and train mode with every rate 0 needs no generator
    assert np.isfinite(quiet.loss(audio, lengths, targets, target_lengths, train=True)[0].item())


def test_trainer_fit_trains_the_small_wav2vec2_on_the_cpu(default_rates_port):
    port = _port_module(default_rates_port, torch.bfloat16)
    audio, lengths = _audio(2)
    trainer = Trainer(device="cpu", max_epochs=4, log_every=1, optimizer_kwargs={"learning_rate": 1e-3})
    trained = trainer.fit(port, [(audio, lengths, TEXTS)])
    losses = [e["loss/train_loss"] for e in trainer.logs]
    assert len(losses) == 4 and all(np.isfinite(losses)) and losses[-1] < 0.8 * losses[0]
    frozen = "encoder.feature_extractor.conv0.kernel"
    before, after = port.model.state_dict(), trained.model.state_dict()
    torch.testing.assert_close(after[frozen], before[frozen] * (1 - 1e-3 * 1e-2) ** 4, rtol=1e-6, atol=0)
    assert not torch.equal(after["encoder.layer1.attention.qkv_proj.kernel"], before["encoder.layer1.attention.qkv_proj.kernel"])
    # the frozen extractor keeps no graph: its output carries no gradient function
    encoder = port.model.encoder
    feats = encoder.feature_extractor(torch.tensor(audio), torch.tensor(lengths))
    assert feats.requires_grad
    hidden, _ = encoder(torch.tensor(audio), torch.tensor(lengths), train=True, generator=torch.Generator().manual_seed(0))
    hidden.float().sum().backward()
    assert all(p.grad is None for p in encoder.feature_extractor.parameters())
    assert encoder.fp_projection.kernel.grad is not None


@pytest.mark.parametrize("site", ["add_layer_norm", "attention", "stable_layer"])
def test_each_dropout_site_matches_jax_given_an_injected_mask(site, monkeypatch):
    """float32: the port's dropout helper is replaced by one that applies a fixed numpy mask, and JAX gets
    the dropped tensor (or, for the probabilities, the same mask through the selftest's reference)."""
    rng = np.random.default_rng(7)
    rate = 0.25
    masks = []

    def injected(x, r, generator):
        if r == 0.0:
            return x
        keep = torch.tensor(rng.random(tuple(x.shape)) >= r)
        masks.append(keep)
        return layers.apply_dropout(x, keep, r)

    monkeypatch.setattr(w2v, "dropout", injected)
    if site == "add_layer_norm":
        x = rng.standard_normal((2, 9, 32)).astype(np.float32)
        y = rng.standard_normal((2, 9, 32)).astype(np.float32)
        scale, bias = (rng.standard_normal(32).astype(np.float32) for _ in range(2))
        norm = w2v._AddLayerNorm(32)
        norm.load_state_dict({"scale": torch.tensor(scale), "bias": torch.tensor(bias)})
        got = norm(torch.tensor(x), torch.tensor(y), train=True, dropout_rate=rate)
        dropped = np.where(masks[0].numpy(), y / (1 - rate), 0.0).astype(np.float32)
        want = jax_w2v._AddLayerNorm().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x), jnp.asarray(dropped))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
        assert torch.equal(norm(torch.tensor(x), torch.tensor(y)), norm(torch.tensor(x), torch.tensor(y), train=True))
    elif site == "attention":
        from thunder_tpu.kernels.selftest import _attn_train_ref

        cfg = w2v.Wav2Vec2Config(**{**SMALL, "attention_dropout": rate})
        attention = w2v._Attention(cfg)
        layers.init_parameters(attention, torch.Generator().manual_seed(0))
        x = rng.standard_normal((2, 21, 128)).astype(np.float32)
        lengths = torch.tensor([21, 13])
        got = attention(torch.tensor(x), lengths, train=True)
        qkv = attention.qkv_proj(torch.tensor(x)).detach().numpy()
        want = _attn_train_ref(jnp.asarray(qkv), jnp.asarray(lengths.numpy()), 2, mask=jnp.asarray(masks[0].numpy(), jnp.float32),
                               keep=1 - rate)
        want = attention.out_proj(torch.tensor(np.asarray(want)))
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5, rtol=0)
    else:
        cfg = w2v.Wav2Vec2Config(**{**SMALL, **NO_DROPOUT, "hidden_dropout": rate, "do_stable_layer_norm": True})
        layer = w2v._EncoderLayer(cfg)
        layers.init_parameters(layer, torch.Generator().manual_seed(0))
        x = torch.tensor(rng.standard_normal((2, 11, 128)).astype(np.float32))
        lengths = torch.tensor([11, 6])
        got = layer(x, lengths, train=True)
        assert len(masks) == 2  # both residual branches
        mid = x + layers.apply_dropout(layer.attention(layer.layer_norm(x), lengths), masks[0], rate)
        want = mid + layers.apply_dropout(layer._ffn(layer.final_layer_norm(mid)), masks[1], rate)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert torch.equal(layer(x, lengths), layer(x, lengths, train=False))


def test_migrate_fused_qkv_matches_jax():
    rng = np.random.default_rng(3)
    proj = lambda: {"kernel": rng.standard_normal((8, 8)).astype(np.float32),  # noqa: E731
                    "bias": rng.standard_normal(8).astype(np.float32)}
    attention = lambda: {"q_proj": proj(), "k_proj": proj(), "v_proj": proj(), "out_proj": proj()}  # noqa: E731
    params = {"encoder": {"layer0": {"attention": attention(), "ffn": proj()}, "layer1": {"attention": attention()}},
              "head": [proj(), (proj(),)]}
    Moments = collections.namedtuple("Moments", ["count", "mu", "nu"])
    moments = (Moments(np.int32(3), params, jax.tree_util.tree_map(np.square, params)), ())
    for tree in (params, moments):
        got, got_changed = migrate_fused_qkv(tree)
        want, want_changed = jax_migrate_fused_qkv(tree)
        assert got_changed and want_changed
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    fused, _ = migrate_fused_qkv(params)
    layer0 = fused["encoder"]["layer0"]["attention"]
    assert set(layer0) == {"qkv_proj", "out_proj"} and layer0["qkv_proj"]["kernel"].shape == (8, 24)
    np.testing.assert_array_equal(layer0["qkv_proj"]["bias"][8:16], params["encoder"]["layer0"]["attention"]["k_proj"]["bias"])
    again, changed = migrate_fused_qkv(fused)
    assert not changed and isinstance(migrate_fused_qkv(moments)[0][0], Moments)
