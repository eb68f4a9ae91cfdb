"""Citrinet in the port against the JAX package (CPU, float32).

A small Citrinet (80 mels; filters (64, 64, 64), kernels (11, 13, 15),
strides (1, 2, 2), repeat 2) with randomized BN statistics is built in the
JAX package and its variables go through the bridge into the port. Both run
the same seeded numpy audio: 1 s clips with lengths (16000, 9000).

Tolerances, stated per test:

- ``SqueezeExcite`` and ``EncoderBlock`` alone: 1e-5 absolute on values of
  order 1 (float32 summation order);
- encoder, module and engine outputs: atol 2e-3 / rtol 1e-3 over valid
  frames, the engine-vs-module bound of the JAX package's own tests;
  lengths, transcripts and beam hypotheses exactly;
- the train-mode loss at rtol 1e-5, and one ``TrainStep`` held to the JAX
  train step as ``tests/test_torch_training.py`` holds QuartzNet's;
- ``InitMode`` draws: mean and standard deviation within 5 standard errors
  of the scheme's, and the bound or the tails each distribution has.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.engine import InferenceEngine as JaxEngine
from thunder_tpu.flops import CITRINET_256_FILTERS as JAX_FILTERS
from thunder_tpu.flops import CITRINET_256_KERNELS as JAX_KERNELS
from thunder_tpu.flops import CITRINET_256_STRIDES as JAX_STRIDES
from thunder_tpu.models import CitrinetEncoder as JaxCitrinet
from thunder_tpu.models import Conv1dDecoder as JaxDecoder
from thunder_tpu.models.layers import EncoderBlock as JaxBlock
from thunder_tpu.models.layers import SqueezeExcite as JaxSqueezeExcite
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.training.optim import adamw as jax_adamw
from thunder_tpu.training.trainer import TrainState, make_train_step
from thunder_tpu.training.trainer import _encode_targets as jax_encode_targets
from thunder_tpu_torch.audio import FilterbankFeatures
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.engine import InferenceEngine
from thunder_tpu_torch.models import CitrinetEncoder, Conv1dDecoder, QuartznetEncoder
from thunder_tpu_torch.models.citrinet import CITRINET_256_FILTERS, CITRINET_256_KERNELS, CITRINET_256_STRIDES
from thunder_tpu_torch.models.layers import EncoderBlock, InitMode, SqueezeExcite, init_parameters, weight_init
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer
from thunder_tpu_torch.training.optim import adamw
from thunder_tpu_torch.training.trainer import TrainStep, _encode_targets

torch.set_num_threads(2)

TOKENS = list("abcdefghijklmnopqrstuvwxyz '")
WIDE_TOKENS = [chr(0x4E00 + i) for i in range(1024)]  # V = 1025 with the blank, Citrinet-256's head
SMALL = dict(filters=(64, 64, 64), kernel_sizes=(11, 13, 15), strides=(1, 2, 2), repeat=2)
TEXTS = ["hello world", "the cat"]


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomized_tree(variables, seed=0):
    """Non-trivial BN statistics and affines, so that BN folding is tested."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(variables)
    for k, v in flat.items():
        if k[-1] == "var":
            flat[k] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif k[-1] == "mean" or (k[-1] in ("scale", "bias") and "bn" in k):
            flat[k] = jnp.asarray((rng.standard_normal(v.shape) * 0.3).astype(np.float32))
    return flax.traverse_util.unflatten_dict(flat)


def _randomized(module, seed=0):
    return module.with_variables(_randomized_tree(module.variables, seed))


def _pair(tokens, seed=0, dither=0.0):
    tt = JaxText(tokens=tokens)
    jax_module = _randomized(JaxModule.create(
        jax.random.PRNGKey(seed),
        audio_transform=JaxFilterbank(nfilt=80, dither=dither),
        encoder=JaxCitrinet(**SMALL),
        decoder=JaxDecoder(num_classes=tt.num_tokens),
        text_transform=tt,
        sample_len=4000,
    ), seed)
    port = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(nfilt=80, dither=dither),
                            CitrinetEncoder(**SMALL), Conv1dDecoder(len(tokens) + 1), BatchTextTransformer(tokens),
                            device="cpu")
    return jax_module, port.with_state(from_flax_variables(_numpy_tree(jax_module.variables)))


@pytest.fixture(scope="module")
def pair():
    return _pair(TOKENS)


@pytest.fixture(scope="module")
def wide_pair():
    return _pair(WIDE_TOKENS, seed=1)


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16000)) * 0.2).astype(np.float32), np.array([16000, 9000], np.int32)


def _assert_logits_close(got, got_lens, want, want_lens):
    np.testing.assert_array_equal(np.asarray(got_lens), np.asarray(want_lens))
    for i, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(np.asarray(got)[i, :n], np.asarray(want)[i, :n], atol=2e-3, rtol=1e-3)


def _load_flax(module, variables):
    """The port's module with a flax module's variables, loaded strictly: every key on both sides."""
    module.load_state_dict(from_flax_variables(_numpy_tree(variables)), strict=True)
    return module


def test_squeeze_excite_matches_jax_with_padded_rows():
    rng = np.random.default_rng(1)
    c = 64
    x = rng.standard_normal((3, 20, c)).astype(np.float32)
    lengths = np.array([20, 13, 0], np.int32)
    jax_se = JaxSqueezeExcite(reduction_ratio=8)
    variables = jax_se.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(lengths))
    want = np.asarray(jax_se.apply(variables, jnp.asarray(x), jnp.asarray(lengths)))
    se = _load_flax(SqueezeExcite(c, 8), variables)
    assert se.fc1.bias is None and se.fc2.bias is None
    assert tuple(se.fc1.kernel.shape) == (64, 8) and tuple(se.fc2.kernel.shape) == (8, 64)
    got = se(torch.as_tensor(x), torch.as_tensor(lengths)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the pool is masked: what lies beyond a row's length does not move its gate
    x2 = x.copy()
    x2[1, 13:] += 5.0
    got2 = se(torch.as_tensor(x2), torch.as_tensor(lengths)).detach().numpy()
    np.testing.assert_allclose(got2[1, :13], got[1, :13], rtol=0, atol=1e-6)


@pytest.mark.parametrize("stride_last_only", [False, True])
@pytest.mark.parametrize("squeeze_excite", [False, True])
@pytest.mark.parametrize("residual_stride_pow", [False, True])
def test_encoder_block_flags_match_jax(stride_last_only, squeeze_excite, residual_stride_pow):
    """Each of Citrinet's three flags on and off, at stride 2 with a residual: eval and train-mode forwards
    (batch statistics, dropout 0), the output lengths and the running statistics after the step."""
    rng = np.random.default_rng(4)
    t, c_in, c = 40, 24, 32
    flags = dict(stride_last_only=stride_last_only, squeeze_excite=squeeze_excite,
                 residual_stride_pow=residual_stride_pow)
    cfg = dict(repeat=2, kernel_size=5, stride=2, separable=True, **flags)
    x = rng.standard_normal((3, t, c_in)).astype(np.float32)
    lengths = np.array([40, 31, 9], np.int32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    jax_block = JaxBlock(features=c, **cfg)
    if stride_last_only == residual_stride_pow:
        # the residual's stride (2 ** 2 or 2) does not meet the repeats' (2 or 2 ** 2): the JAX block fails to
        # add the two, and the port's refuses the pairing when it is built
        with pytest.raises(TypeError, match="incompatible shapes"):
            jax_block.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(lengths))
        with pytest.raises(ValueError, match="residual a stride of"):
            EncoderBlock(c_in, c, **cfg)
        return
    variables = _randomized_tree(jax_block.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(lengths)))
    block = _load_flax(EncoderBlock(c_in, c, **cfg), variables)
    want, want_lens = jax_block.apply(variables, jnp.asarray(x), jnp.asarray(lengths))
    got, got_lens = block(torch.as_tensor(x), torch.as_tensor(lengths))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    (want, _), updates = jax_block.apply(variables, jnp.asarray(x), jnp.asarray(lengths), train=True,
                                         mutable=["batch_stats"])
    got, _ = block(torch.as_tensor(x), torch.as_tensor(lengths), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    want_stats = from_flax_variables(_numpy_tree({"batch_stats": updates["batch_stats"]}))
    for name, value in want_stats.items():
        torch.testing.assert_close(block.state_dict()[name], value, rtol=0, atol=1e-5, msg=name)


def test_encoder_block_quartznet_keys_and_strides_unchanged():
    """The flags off are QuartzNet's block: no ``se`` keys, every repeat strided, the residual at stride ** repeat."""
    block = EncoderBlock(16, 16, repeat=3, kernel_size=5, stride=2, separable=True)
    assert block.se is None and not any(".se." in k or k.startswith("se.") for k in block.state_dict())
    assert [getattr(block, f"rep{r}").depthwise.stride for r in range(3)] == [2, 2, 2]
    assert block.res.conv.stride == 8
    citrinet_block = EncoderBlock(16, 16, repeat=3, kernel_size=5, stride=2, separable=True, stride_last_only=True,
                                  squeeze_excite=True, residual_stride_pow=False)
    assert [getattr(citrinet_block, f"rep{r}").depthwise.stride for r in range(3)] == [1, 1, 2]
    assert [getattr(citrinet_block, f"rep{r}").depthwise.padding for r in range(3)] == [2, 2, 2]
    assert citrinet_block.res.conv.stride == 2


def test_citrinet_encoder_eval_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 101, 80)).astype(np.float32)
    lengths = np.array([101, 57], np.int32)
    x[1, 57:] = 0.0
    jax_encoder = JaxCitrinet(**SMALL)
    variables = jax_encoder.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(lengths))
    variables = _randomized_tree(variables)
    want, want_lens = jax_encoder.apply(variables, jnp.asarray(x), jnp.asarray(lengths))
    encoder = _load_flax(CitrinetEncoder(**SMALL), variables)
    got, got_lens = encoder(torch.as_tensor(x), torch.as_tensor(lengths))
    assert got.shape == (2, 26, 640) and CitrinetEncoder.final_dimension == 640
    _assert_logits_close(got.detach(), got_lens, want, want_lens)


def test_citrinet_256_widths_and_tree_match_jax():
    """The published widths are the JAX package's, and the port's Citrinet-256 has flax's tree, key for key and
    shape for shape (the JAX side by ``jax.eval_shape``, no compute): 107 separable repeats, 23 SE gates, 21
    residuals, a 640-channel tail."""
    assert (CITRINET_256_FILTERS, CITRINET_256_KERNELS, CITRINET_256_STRIDES) == (JAX_FILTERS, JAX_KERNELS,
                                                                                  JAX_STRIDES)
    widths = dict(filters=CITRINET_256_FILTERS, kernel_sizes=CITRINET_256_KERNELS, strides=CITRINET_256_STRIDES)
    x, lengths = jnp.zeros((1, 64, 80)), jnp.array([64], jnp.int32)
    shapes = jax.eval_shape(JaxCitrinet(**widths).init, jax.random.PRNGKey(0), x, lengths)
    want = {k: tuple(v.shape) for k, v in from_flax_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    encoder = CitrinetEncoder(**widths)
    got = {k: tuple(v.shape) for k, v in encoder.state_dict().items()}
    assert got == want
    assert sum(k.endswith("depthwise.kernel") and ".res." not in k for k in got) == 107
    assert sum(k.endswith("se.fc1.kernel") for k in got) == 23
    assert sum(k.endswith("res.conv.kernel") for k in got) == 21
    assert got["block22.rep0.pointwise.kernel"] == (1, 256, 640)
    # remat (ported since) keeps the parameter tree
    assert {k: tuple(v.shape) for k, v in CitrinetEncoder(**widths, remat=True).state_dict().items()} == want


def test_bridge_round_trip(pair):
    """flax variables -> bridge -> the port's Citrinet -> state_dict keeps every variable, bit for bit, under
    its flax path without the ``conv`` level (the SE's ``Dense`` layers have none, and no bias)."""
    jax_module, port = pair
    variables = _numpy_tree(jax_module.variables)
    state = from_flax_variables(variables)
    module_state = port.model.state_dict()
    assert set(state) == set(module_state)
    flat_in = flax.traverse_util.flatten_dict(variables)
    assert len(flat_in) == len(module_state)
    for (collection, *path), value in flat_in.items():
        if collection == "params" and path[-2:-1] == ["conv"]:
            del path[-2]
        key = ".".join(path)
        np.testing.assert_array_equal(state[key].numpy(), value)
        np.testing.assert_array_equal(module_state[key].numpy(), value)
    assert "encoder.block1.se.fc1.kernel" in state and "encoder.block1.se.fc1.bias" not in state
    assert tuple(port.model.encoder.block2.res.conv.kernel.shape) == (1, 64, 64)


def test_module_forward_and_loss_match_jax(pair):
    jax_module, port = pair
    audio, lengths = _audio()
    want, want_lens = jax_module.forward(audio, lengths)
    got, got_lens = port.forward(audio, lengths)
    _assert_logits_close(got, got_lens, want, want_lens)
    targets, target_lengths = jax_encode_targets(jax_module.text_transform, TEXTS)
    args = (jnp.asarray(audio), jnp.asarray(lengths), jnp.asarray(targets), jnp.asarray(target_lengths))
    for train in (False, True):
        want, _ = jax_module.loss(jax_module.variables, *args, train=train)
        got, (logits, out_lengths) = port.to("cpu").loss(audio, lengths, targets, target_lengths, train=train)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        assert logits.shape[:2] == (2, int(out_lengths.max()))


def test_one_train_step_matches_jax():
    """One full train step (B = 2, 1 s, float32; dropout 0, dither 0, no masks) against JAX ``make_train_step``
    with optax AdamW (lr 1e-3, weight decay 1e-2), with the limits of ``test_torch_training.py``: the loss at
    rtol 1e-6, gradients at 1e-5 of the largest, parameters at 1e-6 where the gradient is at least 1e-4 of
    the largest and within the Adam step bound elsewhere, running statistics at 1e-5."""
    jax_module, port = _pair(TOKENS)
    audio, lengths = _audio(1)
    targets, target_lengths = jax_encode_targets(jax_module.text_transform, TEXTS)
    variables = jax.tree_util.tree_map(jnp.array, jax_module.variables)
    state = TrainState.create(apply_fn=jax_module.model.apply, params=variables["params"],
                              tx=jax_adamw(learning_rate=1e-3), batch_stats=variables["batch_stats"])
    state, want_loss = make_train_step(jax_module.model, jax_module.blank_idx)(
        state, jnp.asarray(audio), jnp.asarray(lengths), jnp.asarray(targets), jnp.asarray(target_lengths),
        jax.random.PRNGKey(0))
    want = from_flax_variables(_numpy_tree({"params": state.params, "batch_stats": state.batch_stats}))
    want_grads = {k: v / 0.1 for k, v in from_flax_variables(_numpy_tree({"params": state.opt_state[0].mu})).items()}

    optimizer = adamw(port.model.parameters(), learning_rate=1e-3)
    step = TrainStep(port.model, optimizer, port.blank_idx)
    port_targets, port_target_lengths = _encode_targets(port.text_transform, TEXTS)
    np.testing.assert_array_equal(port_targets, targets)
    loss = step(torch.tensor(audio), torch.tensor(lengths), torch.tensor(port_targets),
                torch.tensor(port_target_lengths), None)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)

    got = port.model.state_dict()
    assert set(got) == set(want)
    g_max = max(v.abs().max().item() for v in want_grads.values())
    for name, p in port.model.named_parameters():
        g = optimizer.state[p]["exp_avg"] / 0.1
        torch.testing.assert_close(g, want_grads[name], rtol=0, atol=1e-5 * g_max, msg=name)
        strong = want_grads[name].abs() >= 1e-4 * g_max
        torch.testing.assert_close(got[name][strong], want[name][strong], rtol=0, atol=1e-6, msg=name)
        assert (got[name] - want[name]).abs().max().item() <= 2 * 1e-3 + 1e-6, name
    assert any(name.endswith("se.fc1.kernel") for name, _ in port.model.named_parameters())
    for name in want:
        if name.endswith((".mean", ".var")):
            torch.testing.assert_close(got[name], want[name], rtol=0, atol=1e-5, msg=name)


@pytest.mark.parametrize("seed", [0, 2])
def test_engine_matches_jax_engine(pair, seed):
    jax_module, port = pair
    audio, lengths = _audio(seed)
    want, want_lens = JaxEngine(jax_module, compute_dtype=jnp.float32, use_pallas=False)(audio, lengths)
    engine = InferenceEngine(port)
    got, got_lens = engine(audio, lengths)
    _assert_logits_close(got, got_lens, want, want_lens)
    # the engine keeps padding at exactly zero, so beyond-length logits are the decoder bias
    beyond = got[1, int(got_lens[1]):].numpy()
    np.testing.assert_allclose(beyond, np.broadcast_to(port.model.decoder.bias.detach().numpy(), beyond.shape),
                               atol=1e-6)


def test_greedy_predict_matches_jax(pair):
    jax_module, port = pair
    jax_engine = JaxEngine(jax_module, compute_dtype=jnp.float32, use_pallas=False)
    audio, lengths = _audio(3)
    want = jax_engine.predict(audio, lengths)
    assert want == jax_module.predict(audio, lengths)
    assert InferenceEngine(port).predict(audio, lengths) == want
    assert port.predict(audio, lengths) == want


def test_wide_vocabulary_greedy_and_device_beam_match_jax(wide_pair):
    """V = 1025 (Citrinet-256's head): greedy, and the device beam (W = 16; the plain versions of both beam
    kernels here) at K = 50 and at every token a step, against the JAX engine's device beam."""
    jax_module, port = wide_pair
    audio, lengths = _audio(4)
    jax_engine = JaxEngine(jax_module, compute_dtype=jnp.float32, use_pallas=False)
    engine = InferenceEngine(port)
    assert engine.predict(audio, lengths) == jax_engine.predict(audio, lengths)
    for k in (50, None):
        kw = dict(beam_width=16, beam_backend="device", max_tokens_per_step=k)
        want = jax_engine.predict(audio, lengths, **kw)
        assert engine.predict(audio, lengths, **kw) == want


def test_predict_long_matches_jax(pair):
    jax_module, port = pair
    clip = np.random.default_rng(6).normal(0, 0.1, 41000).astype(np.float32)  # three 1 s chunks, 0.25 s overlap
    for beam in (dict(), dict(beam_width=4, beam_backend="device")):
        kw = dict(chunk_seconds=1.0, overlap_seconds=0.25, **beam)
        assert InferenceEngine(port).predict_long(clip, **kw) == jax_module.predict_long(clip, **kw)


def test_engine_serves_citrinet_through_its_plan(pair, monkeypatch):
    """A Citrinet takes the planned path: one separable-repeat call per repeat (1 + 3 x 2 + 1), the SE and the
    strided residuals in the plan, never the module's eval forward (the generic fallback)."""
    import thunder_tpu_torch.engine as engine_mod

    _, port = pair
    engine = InferenceEngine(port)
    assert engine._forward == engine._forward_conv
    assert [len(b.repeats) for b in engine._plan] == [1, 2, 2, 2, 1]
    assert [b.se is not None for b in engine._plan] == [True] * 5
    assert [None if b.res is None else b.res.stride for b in engine._plan] == [None, 1, 2, 2, None]
    assert [[rp.stride for rp in b.repeats] for b in engine._plan] == [[1], [1, 1], [1, 2], [1, 2], [1]]
    calls = []
    real = engine_mod.fused_separable_repeat
    monkeypatch.setattr(engine_mod, "fused_separable_repeat",
                        lambda *a, **k: (calls.append(k["stride"]), real(*a, **k))[1])
    monkeypatch.setattr(port.model, "forward", lambda *a, **k: pytest.fail("served through the module's forward"))
    audio, lengths = _audio(5)
    engine(audio, lengths)
    assert calls == [1, 1, 1, 1, 2, 1, 2, 1]


def test_engine_does_not_take_a_citrinet_for_a_quartznet():
    """The QuartzNet and Citrinet encoders are unrelated classes; the engine's dispatch names both."""
    assert not issubclass(CitrinetEncoder, QuartznetEncoder) and not issubclass(QuartznetEncoder, CitrinetEncoder)


def test_residual_lengths_are_checked_when_planned(pair):
    """A residual whose lengths would differ from its repeats' is refused when the engine is built."""
    from thunder_tpu_torch.engine import _check_residual_lengths

    _, port = pair
    plan = InferenceEngine(port)._plan
    _check_residual_lengths(plan[2].repeats, plan[2].res, 2)
    wrong = dataclasses.replace(plan[2].res, stride=4)
    with pytest.raises(NotImplementedError, match="block 2"):
        _check_residual_lengths(plan[2].repeats, wrong, 2)


# float32 statistics of each scheme: (std as a function of (fan_in, fan_out), bounded, tails past 2 std)
_SCHEMES = {
    InitMode.xavier_uniform: (lambda fi, fo: np.sqrt(2.0 / (fi + fo)), True),
    InitMode.xavier_normal: (lambda fi, fo: np.sqrt(2.0 / (fi + fo)), False),
    InitMode.kaiming_uniform: (lambda fi, fo: np.sqrt(2.0 / fi), True),
    InitMode.kaiming_normal: (lambda fi, fo: np.sqrt(2.0 / fi), False),
}


@pytest.mark.parametrize("mode", sorted(_SCHEMES))
def test_init_mode_draws_match_flax_statistics(mode):
    """Each ``InitMode`` scheme against flax's ``weight_init`` of the same name on a (k, C_in, C_out) kernel:
    the same standard deviation (5 standard errors), mean 0, and the same support: uniform draws inside
    ``sqrt(3) std``, normal draws untruncated (about 4.6 % past 2 std, as flax's ``normal`` has)."""
    from thunder_tpu.models.layers import weight_init as jax_weight_init

    shape = (11, 64, 96)
    fan_in, fan_out = 11 * 64, 11 * 96
    std, bounded = _SCHEMES[mode]
    w = torch.empty(shape)
    weight_init(mode)(w, torch.Generator().manual_seed(0))
    want = np.asarray(jax_weight_init(mode)(jax.random.PRNGKey(0), shape, jnp.float32))
    n = w.numel()
    for draws in (w.numpy(), want):
        assert abs(draws.mean()) < 5 * std(fan_in, fan_out) / np.sqrt(n)
        assert abs(draws.std() / std(fan_in, fan_out) - 1) < 5 / np.sqrt(2 * n)
        tails = float((np.abs(draws) > 2 * std(fan_in, fan_out)).mean())
        if bounded:
            assert np.abs(draws).max() <= np.sqrt(3) * std(fan_in, fan_out) * (1 + 1e-6) and tails == 0.0
        else:
            assert abs(tails - 0.0455) < 5 * np.sqrt(0.0455 * 0.9545 / n)
    np.testing.assert_allclose(w.numpy().std(), want.std(), rtol=0.02)


def test_init_mode_reaches_every_conv_kernel_and_unknown_modes_raise():
    from thunder_tpu.models.layers import weight_init as jax_weight_init

    for name in ("he_normal", "lecun_normal"):
        with pytest.raises(ValueError, match=f"Unknown Initialization mode: {name}") as want:
            jax_weight_init(name)
        with pytest.raises(ValueError) as got:
            weight_init(name)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="Unknown Initialization mode"):
            CitrinetEncoder(**SMALL, init_mode=name)
    encoder = CitrinetEncoder(**SMALL, init_mode=InitMode.kaiming_normal)
    quartznet = QuartznetEncoder(repeat=1, filters=(32,), kernel_sizes=(5,), init_mode=InitMode.kaiming_uniform)
    init_parameters(encoder, torch.Generator().manual_seed(0))
    init_parameters(quartznet, torch.Generator().manual_seed(0))
    convs = [m for m in encoder.modules() if hasattr(m, "kernel_init") and m.kernel.ndim == 3]
    assert convs and all(m.kernel_init == InitMode.kaiming_normal for m in convs)
    assert all(m.kernel_init == InitMode.kaiming_uniform for m in quartznet.modules() if hasattr(m, "groups"))
    # kaiming normal on the stem's 256 channels into block 1's pointwise kernel: std sqrt(2 / 256), untruncated
    pw = encoder.block1.rep0.pointwise.kernel.detach().numpy()
    assert abs(pw.std() / np.sqrt(2.0 / 256) - 1) < 0.03 and np.abs(pw).max() > 3 * np.sqrt(2.0 / 256)
    # the SE's Dense layers keep flax's lecun normal, truncated at 2 std of the untruncated draw
    fc1 = encoder.block1.se.fc1.kernel.detach().numpy()
    assert encoder.block1.se.fc1.kernel_init == "lecun_normal"
    assert np.abs(fc1).max() <= 2 * np.sqrt(1.0 / 64) / 0.87962566103423978 * (1 + 1e-6)
