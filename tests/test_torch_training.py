"""QuartzNet training in the port against the JAX package (CPU).

- One full train step of the small QuartzNet of ``test_torch_engine.py`` (B =
  2, 1 s, float32; dropout 0, dither 0, no masks) against JAX
  ``make_train_step`` with optax AdamW (lr 1e-3, weight decay 1e-2). The
  loss is held at rtol 1e-6. Gradients, read from both optimizers' first
  moments (0.1 g after one step), at 1e-5 of the largest gradient (float32
  order; measured below 1e-6). Parameters after the step at 1e-6 where the
  gradient is at least 1e-4 of the largest; elsewhere only within the Adam
  step bound 2 * lr, since a first Adam step moves a weight by lr * g /
  (|g| + 1e-8) and the sign of a gradient at float32 noise (dead ReLU
  channels) is arbitrary. Running statistics at 1e-5.
- ``TorchBatchNorm`` train mode against JAX with ragged lengths, in float32
  (1e-5) and in the bf16 fast path (2 bf16 ULP at the output's largest
  magnitude: the float32 sums differ in order, and the folded scale and
  shift are rounded to bf16).
- SpecAugment, SpecCutout, dropout and dither: the generators of the two
  packages differ by design, so each is held to JAX given the same random
  draws (injected), and its port draws are held to their distribution.
- ``Trainer.fit(fast_dev_run=True)`` and ``Trainer.validate`` on the CPU; CER
  and WER equal JAX's on the same weights and data.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.models import Conv1dDecoder as JaxDecoder
from thunder_tpu.models import QuartznetEncoder as JaxQuartznet
from thunder_tpu.ops.specaugment import _axis_mask as jax_axis_mask
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.training.optim import adamw as jax_adamw
from thunder_tpu.training.trainer import TrainState, make_train_step
from thunder_tpu.training.trainer import Trainer as JaxTrainer
from thunder_tpu.training.trainer import _encode_targets as jax_encode_targets
from thunder_tpu_torch.audio import FilterbankFeatures
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
from thunder_tpu_torch.models.layers import TorchBatchNorm, apply_dropout, dropout
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.ops.specaugment import axis_mask, spec_augment, spec_cutout
from thunder_tpu_torch.text import BatchTextTransformer
from thunder_tpu_torch.training.optim import adamw, build_optimizer
from thunder_tpu_torch.training.trainer import TrainStep, Trainer, _encode_targets, clip_by_global_norm_

torch.set_num_threads(2)

TOKENS = list("abcdefghijklmnopqrstuvwxyz '")
SMALL = dict(repeat=2, filters=(256,), kernel_sizes=(33,))
TEXTS = ["hello world", "the cat"]


def _randomized(module, seed=0):
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(module.variables)
    for k, v in flat.items():
        if k[-1] == "var":
            flat[k] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif k[-1] == "mean" or (k[-1] in ("scale", "bias") and "bn" in k):
            flat[k] = jnp.asarray((rng.standard_normal(v.shape) * 0.3).astype(np.float32))
    return module.with_variables(flax.traverse_util.unflatten_dict(flat))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    tt = JaxText(tokens=TOKENS)
    jax_module = JaxModule.create(
        jax.random.PRNGKey(0),
        audio_transform=JaxFilterbank(dither=0.0),
        encoder=JaxQuartznet(**SMALL),
        decoder=JaxDecoder(num_classes=tt.num_tokens),
        text_transform=tt,
        sample_len=4000,
    )
    jax_module = _randomized(jax_module)
    port = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(dither=0.0), QuartznetEncoder(**SMALL),
                            Conv1dDecoder(len(TOKENS) + 1), BatchTextTransformer(TOKENS), device="cpu")
    return jax_module, port.with_state(from_flax_variables(_numpy_tree(jax_module.variables)))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16000)) * 0.2).astype(np.float32), np.array([16000, 12000], np.int32)


def test_one_train_step_matches_jax(pair):
    jax_module, port = pair
    audio, lengths = _batch()
    targets, target_lengths = jax_encode_targets(jax_module.text_transform, TEXTS)
    variables = jax.tree_util.tree_map(jnp.array, jax_module.variables)  # copies: the step donates its state
    state = TrainState.create(apply_fn=jax_module.model.apply, params=variables["params"],
                              tx=jax_adamw(learning_rate=1e-3), batch_stats=variables["batch_stats"])
    state, want_loss = make_train_step(jax_module.model, jax_module.blank_idx)(
        state, jnp.asarray(audio), jnp.asarray(lengths), jnp.asarray(targets), jnp.asarray(target_lengths),
        jax.random.PRNGKey(0))
    want = from_flax_variables(_numpy_tree({"params": state.params, "batch_stats": state.batch_stats}))
    want_grads = {k: v / 0.1 for k, v in from_flax_variables(_numpy_tree({"params": state.opt_state[0].mu})).items()}

    port = port.to("cpu")  # a copy: the fixture's weights stay as they were
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
        assert strong.float().mean() > 0.2, name
        torch.testing.assert_close(got[name][strong], want[name][strong], rtol=0, atol=1e-6, msg=name)
        assert (got[name] - want[name]).abs().max().item() <= 2 * 1e-3 + 1e-6, name
    for name in want:
        if name.endswith((".mean", ".var")):
            torch.testing.assert_close(got[name], want[name], rtol=0, atol=1e-5, msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_mode_matches_jax(dtype):
    from thunder_tpu.models.layers import TorchBatchNorm as JaxBatchNorm

    rng = np.random.default_rng(3)
    c = 24
    x = (rng.standard_normal((3, 20, c)) * 2.0 + 0.5).astype(np.float32)
    lengths = np.array([20, 13, 4])
    mask = np.arange(20)[None, :] < lengths[:, None]
    params = {"scale": rng.standard_normal(c).astype(np.float32), "bias": rng.standard_normal(c).astype(np.float32)}
    stats = {"mean": rng.standard_normal(c).astype(np.float32), "var": rng.uniform(0.5, 2, c).astype(np.float32)}
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want, updates = JaxBatchNorm(dtype=jdt).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x, jdt), use_running_average=False,
        mask=jnp.asarray(mask), mutable=["batch_stats"])
    bn = TorchBatchNorm(c, dtype=tdt)
    bn.load_state_dict({k: torch.tensor(v) for k, v in {**params, **stats}.items()})
    got = bn(torch.tensor(x).to(tdt), train=True, mask=torch.tensor(mask))
    want = torch.tensor(np.asarray(want, np.float32))
    assert got.dtype == tdt
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
        torch.testing.assert_close(got.float(), want, rtol=0, atol=2 * ulp)
    for k in ("mean", "var"):
        torch.testing.assert_close(getattr(bn, k), torch.tensor(np.asarray(updates["batch_stats"][k])), rtol=0, atol=1e-5)
    # eval mode after the update uses the running statistics (in bf16 through the fold)
    want_eval = JaxBatchNorm(dtype=jdt).apply({"params": params, "batch_stats": _numpy_tree(updates["batch_stats"])},
                                              jnp.asarray(x, jdt), use_running_average=True)
    got_eval = bn(torch.tensor(x).to(tdt)).float()
    want_eval = torch.tensor(np.asarray(want_eval, np.float32))
    torch.testing.assert_close(got_eval, want_eval, rtol=0, atol=1e-5 if dtype == "float32" else 2 * ulp * 2)


def _jax_uniform_pairs(key, n):
    """The two uniforms each of ``n`` keys split from ``key`` gives ``_axis_mask``."""
    out = []
    for k in jax.random.split(key, n):
        r1, r2 = jax.random.split(k)
        out += [float(jax.random.uniform(r1)), float(jax.random.uniform(r2))]
    return torch.tensor(out, dtype=torch.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_augment_and_cutout_match_jax_given_its_draws(seed):
    from thunder_tpu.ops.specaugment import spec_augment as jax_spec_augment
    from thunder_tpu.ops.specaugment import spec_cutout as jax_spec_cutout

    x = np.random.default_rng(seed).standard_normal((2, 120, 64)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_spec_augment(key, jnp.asarray(x), time_masks=2, freq_masks=2, time_width=50, freq_width=20))
    got = spec_augment(torch.tensor(x), _jax_uniform_pairs(key, 4), 2, 2, 50, 20)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()
    want = np.asarray(jax_spec_cutout(key, jnp.asarray(x), rect_masks=3, time_width=30, freq_width=20))
    got = spec_cutout(torch.tensor(x), _jax_uniform_pairs(key, 6), 3, 30, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_widths_follow_jax_distribution():
    """Band widths drawn through the port's generator against JAX's draws: same mean within 5 standard errors."""
    n, size, width = 4000, 751, 50
    gen = torch.Generator().manual_seed(0)
    u = torch.rand(2 * n, generator=gen)
    port_widths = np.array([int(axis_mask(u[2 * i], u[2 * i + 1], size, width).sum()) for i in range(n)])
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jax_widths = np.asarray(jax.vmap(lambda k: jnp.sum(jax_axis_mask(k, size, width)))(keys))
    se = np.sqrt(port_widths.var() / n + jax_widths.var() / n)
    assert abs(port_widths.mean() - jax_widths.mean()) < 5 * se
    assert port_widths.min() >= 0 and port_widths.max() <= width
    # E[floor(start + w) - floor(start)] = E[w] = width / 2 for a start with a uniform fraction
    assert abs(port_widths.mean() - width / 2) < 5 * np.sqrt(port_widths.var() / n)


def test_dropout_matches_flax_given_its_mask_and_keeps_its_rate():
    x = np.random.default_rng(1).standard_normal((4, 50, 32)).astype(np.float32) + 3.0  # no zeros
    rate = 0.1
    want = np.asarray(flax.linen.Dropout(rate=rate, deterministic=False).apply(
        {}, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(0)}))
    keep = torch.tensor(want != 0)
    np.testing.assert_array_equal(apply_dropout(torch.tensor(x), keep, rate).numpy(), want)
    ones = torch.ones(200_000)
    out = dropout(ones, rate, torch.Generator().manual_seed(0))
    kept = (out != 0).float().mean().item()
    assert abs(kept - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / ones.numel())
    torch.testing.assert_close(out[out != 0], torch.full_like(out[out != 0], 1 / (1 - rate)))
    assert dropout(ones, 0.0, None) is ones
    with pytest.raises(ValueError, match="generator"):
        dropout(ones, rate, None)


def test_dither_matches_jax_given_the_same_noise():
    audio, lengths = _batch(5)
    noise = 1e-3 * torch.randn(audio.shape, generator=torch.Generator().manual_seed(7))
    got, got_lens = FilterbankFeatures(dither=1e-3)(torch.tensor(audio), torch.tensor(lengths), train=True,
                                                    generator=torch.Generator().manual_seed(7))
    want, want_lens = JaxFilterbank(dither=0.0).apply({}, jnp.asarray(audio + noise.numpy()), jnp.asarray(lengths),
                                                     train=False)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    again, _ = FilterbankFeatures(dither=1e-3)(torch.tensor(audio), torch.tensor(lengths), train=True,
                                               generator=torch.Generator().manual_seed(7))
    assert torch.equal(again, got)
    eval_feats, _ = FilterbankFeatures(dither=1e-3)(torch.tensor(audio), torch.tensor(lengths))
    assert not torch.equal(eval_feats, got)


def test_frontend_train_mode_masks_and_options():
    with pytest.raises(ValueError, match="at the same time"):
        FilterbankFeatures(num_cutout_masks=1, num_time_masks=1)
    audio, lengths = _batch(6)
    frontend = FilterbankFeatures(dither=0.0, num_time_masks=2, num_freq_masks=2)
    feats, _ = frontend(torch.tensor(audio), torch.tensor(lengths), train=True, generator=torch.Generator().manual_seed(3))
    clean, _ = frontend(torch.tensor(audio), torch.tensor(lengths))
    zeroed = (feats == 0) & (clean != 0)
    assert zeroed.any()
    torch.testing.assert_close(feats[~zeroed], clean[~zeroed], rtol=0, atol=0)
    # masks are shared across the batch: a zeroed frequency band is zero in every row
    band = zeroed[:, :70].all(dim=1)  # (B, F), over frames valid in both rows
    assert torch.equal(band[0], band[1])


def test_clip_by_global_norm_matches_optax():
    import optax

    grads = [torch.tensor([3.0, 4.0]), torch.tensor([[12.0]])]
    want = optax.clip_by_global_norm(5.0).update([np.asarray(g) for g in grads], None)[0]
    clip_by_global_norm_(grads, 5.0)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    small = [torch.tensor([0.3, 0.4])]
    clip_by_global_norm_(small, 5.0)
    assert small[0].tolist() == pytest.approx([0.3, 0.4])
    p = torch.nn.Parameter(torch.zeros(1))
    optimizer = build_optimizer([p], adamw, {"learning_rate": 0.5, "weight_decay": 0.0})
    assert isinstance(optimizer, torch.optim.AdamW) and optimizer.defaults["lr"] == 0.5


def test_fit_and_validate_on_cpu_match_jax_metrics(pair):
    jax_module, port = pair
    audio, lengths = _batch(2)
    loader = [(audio, lengths, TEXTS)]
    want = JaxTrainer().validate(jax_module, loader)
    trainer = Trainer(device="cpu", fast_dev_run=True, gradient_clip_norm=1.0, accumulate_grad_batches=1)
    got = trainer.validate(port, loader)
    assert got["metrics/cer"] == want["metrics/cer"] and got["metrics/wer"] == want["metrics/wer"]
    np.testing.assert_allclose(got["loss/val_loss"], want["loss/val_loss"], rtol=1e-5)

    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    trained = trainer.fit(port, loader, val_loader=loader)
    assert trained is not port and trained.device == torch.device("cpu")
    assert all(torch.equal(v, port.model.state_dict()[k]) for k, v in before.items())  # the caller's copy is untouched
    moved = [k for k, v in trained.model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)  # every parameter and running statistic moved
    assert [e.get("step") for e in trainer.logs] == [1, None]
    assert np.isfinite(trainer.logs[0]["loss/train_loss"]) and "metrics/cer" in trainer.logs[1]


def test_trainer_and_module_default_to_cuda(monkeypatch):
    assert Trainer().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CTCModule.create(torch.Generator(), FilterbankFeatures(), QuartznetEncoder(**SMALL), Conv1dDecoder(3))
    port = CTCModule.create(torch.Generator(), FilterbankFeatures(), QuartznetEncoder(**SMALL), Conv1dDecoder(3),
                            device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer().fit(port, [])


def test_module_loss_matches_jax_in_eval_and_train(pair):
    jax_module, port = pair
    audio, lengths = _batch(4)
    targets, target_lengths = jax_encode_targets(jax_module.text_transform, TEXTS)
    args = (jnp.asarray(audio), jnp.asarray(lengths), jnp.asarray(targets), jnp.asarray(target_lengths))
    for train in (False, True):
        want, _ = jax_module.loss(jax_module.variables, *args, train=train)
        got, (logits, out_lengths) = port.to("cpu").loss(audio, lengths, targets, target_lengths, train=train)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        assert logits.shape[:2] == (2, int(out_lengths.max()))
