"""The port's optimizers, schedules, plateau rule and fine-tuning freeze against the JAX package's (CPU).

- ``onecycle``: the learning rate at every step (and past the end) within 1e-7 of the JAX schedule,
  optax's ``cosine_onecycle_schedule`` with the clamp for tiny totals (optax takes the cosine in
  float32, the port in float64: the two differ by up to 1.2e-7 of the rate, under 1e-7 for rates up to
  0.5);
- ``build_optimizer``: ``total_steps_arg`` and ``interval="epoch"`` give the JAX builder's schedule
  values, within 1e-7; its two ``ValueError``s;
- the plateau rule: every field of the state over fixed series of validation losses equal to
  ``optax.contrib.reduce_on_plateau``'s (float32 arithmetic on both sides), for several settings;
- a few updates on one parameter tree through ``optimizer_step`` against optax's chains on the same
  gradients, within 1e-6: ``sgd`` with momentum (plain and Nesterov) under a schedule, AdamW with the
  value and norm clips, and ``finetune_schedule_transform`` before and after the unfreeze (the frozen
  encoder bit-equal), with the plateau scale outermost.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from thunder_tpu.training import optim as jax_optim
from thunder_tpu_torch.training import optim

LR_TOL = 1e-7
TREE_TOL = 1e-6


@pytest.mark.parametrize("total", [1, 2, 3, 4, 10, 100])
@pytest.mark.parametrize("pct_start", [0.3, 0.25])
def test_onecycle_matches_jax_at_every_step(total, pct_start):
    want = jax_optim.onecycle(1e-3, total, pct_start=pct_start)
    got = optim.onecycle(1e-3, total, pct_start=pct_start)
    for step in range(total + 5):
        w = float(want(step))
        assert np.isfinite(got(step))
        assert abs(got(step) - w) <= LR_TOL, (step, got(step), w)


@pytest.mark.parametrize("max_lr", [0.5, 0.05])
def test_onecycle_matches_optax_shape(max_lr):
    """At a total with both intervals wide, the port is optax's schedule itself (no clamp)."""
    want = optax.cosine_onecycle_schedule(200, max_lr, 0.3, 25.0, 1e4)
    got = optim.onecycle(max_lr, 200)
    for step in (0, 1, 30, 59, 60, 61, 120, 199, 200, 250):
        assert abs(got(step) - float(want(step))) <= LR_TOL, step


def _jax_schedule(sched_kwargs, **kw):
    captured = {}

    def spy(learning_rate=None, **_):
        captured["lr"] = learning_rate
        return optax.sgd(1e-3)

    jax_optim.build_optimizer(spy, {}, jax_optim.onecycle, dict(sched_kwargs), **kw)
    return captured["lr"]


@pytest.mark.parametrize("interval", ["step", "epoch"])
@pytest.mark.parametrize("total_steps,steps_per_epoch", [(100, 10), (37, 5), (6, 3)])
def test_build_optimizer_schedule_matches_jax(interval, total_steps, steps_per_epoch):
    kwargs = {"max_lr": 1e-2, "total_steps_arg": "total_steps", "interval": interval}
    want = _jax_schedule(kwargs, total_steps=total_steps, steps_per_epoch=steps_per_epoch)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = optim.build_optimizer([p], optim.adamw, {}, optim.onecycle, dict(kwargs), total_steps=total_steps,
                                steps_per_epoch=steps_per_epoch)
    assert isinstance(opt, torch.optim.AdamW)
    for step in range(total_steps + 3):
        assert abs(opt.lr_schedule(step) - float(want(step))) <= LR_TOL, step
    if interval == "epoch":
        assert opt.lr_schedule(0) == opt.lr_schedule(steps_per_epoch - 1) != opt.lr_schedule(steps_per_epoch)
    assert opt.param_groups[0]["lr"] == opt.lr_schedule(0)


def test_build_optimizer_total_steps_into_optimizer_kwargs():
    """``total_steps_arg`` in the optimizer's kwargs, as the JAX builder fills it."""
    seen = {}

    def spy(params, learning_rate=1.0, horizon=None):
        seen["horizon"] = horizon
        return optim.sgd(params, learning_rate)

    optim.build_optimizer([torch.nn.Parameter(torch.zeros(1))], spy, {"total_steps_arg": "horizon"}, total_steps=42)
    assert seen["horizon"] == 42


def test_build_optimizer_epoch_interval_requires_steps_per_epoch():
    with pytest.raises(ValueError, match="steps_per_epoch"):
        optim.build_optimizer([torch.nn.Parameter(torch.zeros(1))], optim.adamw, {}, optim.onecycle,
                              {"max_lr": 1.0, "total_steps": 10, "interval": "epoch"})
    with pytest.raises(ValueError, match="steps_per_epoch"):
        jax_optim.build_optimizer(jax_optim.adamw, {}, jax_optim.onecycle,
                                  {"max_lr": 1.0, "total_steps": 10, "interval": "epoch"})


def test_build_optimizer_total_steps_arg_without_total_steps_raises():
    with pytest.raises(ValueError, match="total_steps"):
        optim.build_optimizer([torch.nn.Parameter(torch.zeros(1))], optim.adamw, {}, optim.onecycle,
                              {"max_lr": 1.0, "total_steps_arg": "total_steps"})


PLATEAU_SETTINGS = [
    dict(factor=0.5, patience=1),
    dict(factor=0.5, patience=0),
    dict(factor=0.1, patience=2, cooldown=1),
    dict(factor=0.3, patience=1, rtol=0.0, atol=0.05, min_scale=0.05),
    dict(factor=0.5, patience=1, accumulation_size=3),
    dict(factor=0.7, patience=3, rtol=0.1, cooldown=2),
]
LOSS_SERIES = [1.0, 1.0, 0.9, 0.95, 0.95, 0.94, 0.5, 0.5001, 0.6, 0.7, 0.49, 0.49, 0.49, 0.3, 0.31, 0.29, 0.3]


@pytest.mark.parametrize("settings", PLATEAU_SETTINGS, ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_plateau_state_matches_optax(settings):
    rule = optax.contrib.reduce_on_plateau(**settings)
    want = rule.init({"w": jnp.ones(2)})
    got = optim.reduce_on_plateau(**settings).init()
    for value in LOSS_SERIES:
        _, want = rule.update({}, want, value=jnp.asarray(value, jnp.float32))
        got = optim.plateau_update(got, value, **settings)
        assert np.float32(got.scale) == np.asarray(want.scale), value
        assert np.float32(got.best_value) == np.asarray(want.best_value), value
        assert np.float32(got.avg_value) == np.asarray(want.avg_value), value
        assert (got.plateau_count, got.cooldown_count, got.count) == (
            int(want.plateau_count), int(want.cooldown_count), int(want.count)), value


@pytest.mark.parametrize("bad", [dict(factor=1.0), dict(factor=0.0), dict(rtol=-1.0), dict(rtol=0.0, atol=0.0),
                                 dict(rtol=2.0)], ids=str)
def test_plateau_rejects_what_optax_rejects(bad):
    with pytest.raises(ValueError):
        optax.contrib.reduce_on_plateau(**bad)
    with pytest.raises(ValueError):
        optim.reduce_on_plateau(**bad)


def test_plateau_accessors_and_marker():
    assert optim.reduce_on_plateau._is_plateau and jax_optim.reduce_on_plateau._is_plateau
    p = torch.nn.Parameter(torch.ones(2))
    opt = optim.plateau_schedule_transform(optim.sgd([p], 1.0), factor=0.5, patience=0)
    state = optim.get_plateau_state(opt)
    assert float(state.scale) == 1.0
    state = optim.plateau_update(optim.plateau_update(state, 1.0, factor=0.5, patience=0), 1.0, factor=0.5,
                                 patience=0)
    assert optim.replace_plateau_state(opt, state) is opt and float(optim.get_plateau_state(opt).scale) == 0.5
    p.grad = torch.ones(2)
    optim.optimizer_step(opt, 0)
    torch.testing.assert_close(p.detach(), torch.full((2,), 0.5))  # 1 - scale * lr * g
    with pytest.raises(KeyError, match="plateau"):
        optim.get_plateau_state(optim.sgd([p], 1.0))


def _tree(rng):
    return {"encoder": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                        "b": rng.standard_normal(4).astype(np.float32)},
            "decoder": {"w": rng.standard_normal((4, 2)).astype(np.float32)}}


def _flat(tree):
    return {f"{a}.{b}": v for a, sub in tree.items() for b, v in sub.items()}


def _run_both(jax_tx, make_opt, steps=6, clip_value=None, clip_norm=None, plateau=None, grad_scale=1.0, seed=0):
    """``steps`` updates of one tree by an optax chain and by the port's optimizer on the same gradients;
    returns both trees after every step (``plateau``: a list of (scale) set before each step on both)."""
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    jax_params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_tx.init(jax_params)
    named = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in _flat(params).items()}
    opt = make_opt(list(named.items()))
    history = []
    for step in range(steps):
        grads = jax.tree_util.tree_map(lambda v: (rng.standard_normal(v.shape) * grad_scale).astype(np.float32),
                                       params)
        updates, state = jax_tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for name, g in _flat(grads).items():
            named[name].grad = torch.tensor(g)
        optim.optimizer_step(opt, step, clip_value, clip_norm)
        opt.zero_grad(set_to_none=True)
        history.append(({k: np.asarray(v) for k, v in _flat(jax_params).items()},
                        {k: v.detach().numpy().copy() for k, v in named.items()}))
    return history


def _assert_close(history, tol=TREE_TOL):
    for step, (want, got) in enumerate(history):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=tol, err_msg=f"{name} at step {step}")


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_momentum_with_a_schedule_matches_optax(nesterov):
    schedule = jax_optim.onecycle(0.1, 8)
    history = _run_both(jax_optim.sgd(learning_rate=schedule, momentum=0.9, nesterov=nesterov),
                        lambda named: optim.sgd([p for _, p in named], optim.onecycle(0.1, 8), momentum=0.9,
                                                nesterov=nesterov), steps=8)
    _assert_close(history)


def test_sgd_without_momentum_matches_optax():
    _assert_close(_run_both(jax_optim.sgd(learning_rate=0.05), lambda named: optim.sgd([p for _, p in named], 0.05)))


@pytest.mark.parametrize("clip_value,clip_norm", [(None, 1.0), (0.5, None), (0.5, 1.0)])
def test_adamw_with_clips_matches_optax(clip_value, clip_norm):
    tx = jax_optim.adamw(learning_rate=1e-2)
    if clip_norm is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip_norm), tx)
    if clip_value is not None:
        tx = optax.chain(optax.clip(clip_value), tx)
    history = _run_both(tx, lambda named: optim.adamw([p for _, p in named], 1e-2), clip_value=clip_value,
                        clip_norm=clip_norm, grad_scale=2.0)
    _assert_close(history)


@pytest.mark.parametrize("unfreeze_at", [0, 3, 10])
@pytest.mark.parametrize("builder", ["adamw", "sgd"])
def test_finetune_schedule_transform_matches_jax(unfreeze_at, builder):
    """The encoder frozen (bit-equal) before the unfreeze step and trained at lr / 4 after it, its frozen
    gradients kept out of the global norm (clip 1.0 binds), under a schedule."""
    jax_inner = (jax_optim.adamw(learning_rate=jax_optim.onecycle(1e-2, 8)) if builder == "adamw"
                 else jax_optim.sgd(learning_rate=jax_optim.onecycle(1e-2, 8), momentum=0.9))
    jax_tx = jax_optim.finetune_schedule_transform(optax.chain(optax.clip_by_global_norm(1.0), jax_inner),
                                                   unfreeze_encoder_at_step=unfreeze_at, encoder_initial_lr_div=4.0)

    def make(named):
        groups = optim.finetune_param_groups(named)
        opt = (optim.adamw(groups, optim.onecycle(1e-2, 8)) if builder == "adamw"
               else optim.sgd(groups, optim.onecycle(1e-2, 8), momentum=0.9))
        return optim.finetune_schedule_transform(opt, unfreeze_at, 4.0)

    history = _run_both(jax_tx, make, steps=8, clip_norm=1.0, grad_scale=3.0)
    _assert_close(history)
    start = _flat(_tree(np.random.default_rng(0)))
    for step, (_, got) in enumerate(history):
        frozen = step < unfreeze_at
        for name in ("encoder.w", "encoder.b"):
            assert np.array_equal(got[name], start[name]) == frozen, (name, step)
        assert not np.array_equal(got["decoder.w"], start["decoder.w"])


def test_plateau_scale_outermost_matches_jax():
    """plateau_schedule_transform's scale multiplies AdamW's whole update (decoupled weight decay included),
    outside the fine-tuning freeze."""
    settings = dict(factor=0.5, patience=0)
    jax_tx = jax_optim.plateau_schedule_transform(
        jax_optim.finetune_schedule_transform(jax_optim.adamw(learning_rate=1e-2), 2, 2.0), **settings)

    def make(named):
        opt = optim.finetune_schedule_transform(optim.adamw(optim.finetune_param_groups(named), 1e-2), 2, 2.0)
        return optim.plateau_schedule_transform(opt, **settings)

    rng = np.random.default_rng(1)
    params = _tree(rng)
    jax_params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_tx.init(jax_params)
    named = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in _flat(params).items()}
    opt = make(list(named.items()))
    for step, val_loss in enumerate([1.0, 1.0, 0.5, 0.8, 0.8]):
        grads = jax.tree_util.tree_map(lambda v: rng.standard_normal(v.shape).astype(np.float32), params)
        updates, state = jax_tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for name, g in _flat(grads).items():
            named[name].grad = torch.tensor(g)
        optim.optimizer_step(opt, step)
        opt.zero_grad(set_to_none=True)
        new = jax_optim.plateau_update(jax_optim.get_plateau_state(state), val_loss, **settings)
        state = jax_optim.replace_plateau_state(state, new)
        optim.replace_plateau_state(opt, optim.plateau_update(optim.get_plateau_state(opt), val_loss, **settings))
        assert float(optim.get_plateau_state(opt).scale) == float(new.scale)
        for name, want in _flat(jax_params).items():
            np.testing.assert_allclose(named[name].detach().numpy(), np.asarray(want), rtol=0, atol=TREE_TOL,
                                       err_msg=f"{name} at step {step}")


def test_finetune_needs_an_encoder_group():
    with pytest.raises(ValueError, match="encoder"):
        optim.finetune_schedule_transform(optim.adamw([torch.nn.Parameter(torch.zeros(1))]), 1)
    groups = optim.finetune_param_groups([("encoder.a", torch.nn.Parameter(torch.zeros(1))),
                                          ("decoder.b", torch.nn.Parameter(torch.zeros(1))),
                                          ("encoder_head.c", torch.nn.Parameter(torch.zeros(1)))])
    assert [len(g["params"]) for g in groups] == [1, 2] and groups[0]["encoder"] and not groups[1]["encoder"]
