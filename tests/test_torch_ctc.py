"""The port's CTC loss on the CPU against the JAX package.

Two references, both on the CPU: ``thunder_tpu.ops.ctc`` (its ``lax.scan``
path) and ``ctc_ll_pallas(..., interpret=True)`` (the TPU kernel in
interpret mode). Two routes of the port: the plain time loop with autograd
(what ``ctc_forward_scores`` runs for CPU tensors) and the
``torch.autograd.Function`` of the kernel pair, whose wrappers run the plain
alpha and beta loops for CPU tensors. Limits are the JAX package's own
(``tests/test_ctc_pallas.py``): loss rtol 1e-6, gradient atol 1e-5.

The case is ``tests/test_ctc_pallas.py``'s (a repeated label, an empty
target, T = 61 with lengths 2 and 19), plus a sixth row that repeats row 4
with 9 frames for its 9 labels and one repeat: an impossible alignment.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.kernels.ctc_pallas import ctc_ll_pallas
from thunder_tpu.ops import ctc as jctc
from thunder_tpu_torch.kernels import ctc as kctc
from thunder_tpu_torch.kernels.selftest import ctc_edge_case
from thunder_tpu_torch.ops import ctc as pctc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    logits, targets, lens, tl = (t.numpy() for t in ctc_edge_case("cpu"))
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    return lp, targets, lens, tl


def _jax_args(lp, targets, lens, tl):
    return jnp.asarray(lp), jnp.asarray(lens), jnp.asarray(targets), jnp.asarray(tl)


def _torch_args(lp, targets, lens, tl, grad=False):
    return torch.tensor(lp, requires_grad=grad), torch.tensor(lens), torch.tensor(targets), torch.tensor(tl)


def _pallas_scores(lp, lens, targets, tl):
    """``ctc_forward_scores`` with the TPU kernel in interpret mode for the recursion."""
    b, _, _ = lp.shape
    s_dim = 2 * targets.shape[1] + 1
    z = jnp.full((b, s_dim), 0, jnp.int32).at[:, 1::2].set(targets)
    z_prev2 = jnp.pad(z, ((0, 0), (2, 0)), constant_values=-1)[:, :s_dim]
    skip_ok = (jnp.arange(s_dim) % 2 == 1)[None, :] & (z != z_prev2)
    lp_z = jnp.moveaxis(jnp.take_along_axis(lp, z[:, None, :], axis=2), 1, 0)
    loss = -ctc_ll_pallas(lp_z, skip_ok, lens, tl, interpret=True)
    return jnp.where(loss > 0.5e30, jnp.inf, loss)


def _function_scores(log_probs, lens, targets, tl, blank=0):
    """The port's ``ctc_forward_scores`` with the recursion through the autograd.Function."""
    lp_z, skip_ok = pctc.extended_emissions(log_probs, targets, blank)
    return pctc.scores_from_ll(kctc.ctc_ll(lp_z, skip_ok, lens.int(), tl.int()))


PORT_ROUTES = {"plain_loop": pctc.ctc_forward_scores, "autograd_function": _function_scores}
JAX_REFERENCES = {"scan": lambda *a: jctc.ctc_forward_scores(*a, blank=0), "pallas_interpret": _pallas_scores}


def _mean_zero_inf(losses, tl):
    return torch.where(torch.isinf(losses), 0.0, losses).div(tl.clamp_min(1)).mean()


def _jax_mean_zero_inf(losses, tl):
    return jnp.mean(jnp.where(jnp.isinf(losses), 0.0, losses) / jnp.maximum(tl, 1))


@pytest.mark.parametrize("reference", sorted(JAX_REFERENCES))
@pytest.mark.parametrize("route", sorted(PORT_ROUTES))
def test_scores_and_gradients_match_jax(case, route, reference):
    lp, targets, lens, tl = case
    ref_fn = JAX_REFERENCES[reference]
    want = np.asarray(ref_fn(*_jax_args(lp, targets, lens, tl)))
    want_grad = np.asarray(jax.grad(lambda x: _jax_mean_zero_inf(ref_fn(x, *_jax_args(lp, targets, lens, tl)[1:]), tl))(
        jnp.asarray(lp)))
    x, t_lens, t_targets, t_tl = _torch_args(lp, targets, lens, tl, grad=True)
    got = PORT_ROUTES[route](x, t_lens, t_targets, t_tl, 0)
    inf = np.isinf(want)
    assert inf.tolist() == [False] * 5 + [True]
    np.testing.assert_array_equal(np.isinf(got.detach().numpy()), inf)
    np.testing.assert_allclose(got.detach().numpy()[~inf], want[~inf], rtol=1e-6)
    _mean_zero_inf(got, t_tl).backward()
    assert np.abs(want_grad).max() > 1e-3  # non-degenerate
    np.testing.assert_allclose(x.grad.numpy(), want_grad, atol=1e-5)


@pytest.mark.parametrize("route", sorted(PORT_ROUTES))
def test_impossible_sample_gets_exactly_zero_gradient(case, route):
    lp, targets, lens, tl = case
    x, t_lens, t_targets, t_tl = _torch_args(lp, targets, lens, tl, grad=True)
    losses = PORT_ROUTES[route](x, t_lens, t_targets, t_tl, 0)
    torch.where(torch.isinf(losses), 0.0, losses).sum().backward()
    per_row = x.grad.abs().amax(dim=(1, 2))
    assert torch.isinf(losses).tolist() == [False] * 5 + [True]
    assert per_row[5].item() == 0.0
    assert bool((per_row[:5] > 0).all())
    assert bool(torch.isfinite(x.grad).all())


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("zero_infinity", [False, True])
def test_ctc_loss_reductions_match_jax(case, reduction, weighted, zero_infinity):
    lp, targets, lens, tl = case
    weights = np.array([1.0, 0.5, 0.0, 2.0, 1.0, 1.0], np.float32) if weighted else None
    if not zero_infinity:  # the impossible row would make every reduction inf; drop it
        lp, targets, lens, tl = lp[:5], targets[:5], lens[:5], tl[:5]
        weights = None if weights is None else weights[:5]
    kw = dict(blank=0, reduction=reduction, zero_infinity=zero_infinity)
    jw = None if weights is None else jnp.asarray(weights)
    want = np.asarray(jctc.ctc_loss(*_jax_args(lp, targets, lens, tl), sample_weights=jw, **kw))
    want_grad = np.asarray(jax.grad(lambda x: jnp.sum(jctc.ctc_loss(x, *_jax_args(lp, targets, lens, tl)[1:],
                                                                       sample_weights=jw, **kw)))(jnp.asarray(lp)))
    x, t_lens, t_targets, t_tl = _torch_args(lp, targets, lens, tl, grad=True)
    tw = None if weights is None else torch.tensor(weights)
    got = pctc.ctc_loss(x, t_lens, t_targets, t_tl, sample_weights=tw, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    got.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want_grad, atol=1e-5)


def test_calculate_ctc_matches_jax_on_raw_logits():
    logits, targets, lens, tl = (t.numpy() for t in ctc_edge_case("cpu"))
    weights = np.array([1, 1, 1, 0, 1, 1], np.float32)
    want, want_grad = jax.value_and_grad(lambda x: jctc.calculate_ctc(
        x, jnp.asarray(targets), jnp.asarray(lens), jnp.asarray(tl), blank=0, sample_weights=jnp.asarray(weights)))(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = pctc.calculate_ctc(x, torch.tensor(targets), torch.tensor(lens), torch.tensor(tl), blank=0,
                             sample_weights=torch.tensor(weights))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-5)


@pytest.mark.parametrize("route", ["calculate_ctc", "autograd_function"])
def test_targets_past_1024_extended_states_match_jax(route):
    """A 512-label target (S = 1025: two states a thread in the kernels, where the first kernel took one and
    raised) over 600 frames, repeats included; ``calculate_ctc``'s mean over target lengths and its gradient."""
    rng = np.random.default_rng(7)
    t, v, labels = 600, 29, 512
    logits = rng.standard_normal((2, t, v)).astype(np.float32)
    targets = rng.integers(1, v, (2, labels))
    lens, tl = np.array([t, t - 40], np.int32), np.array([labels, labels - 21], np.int32)
    want, want_grad = jax.value_and_grad(lambda x: jctc.calculate_ctc(
        x, jnp.asarray(targets), jnp.asarray(lens), jnp.asarray(tl), blank=0))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    if route == "calculate_ctc":
        got = pctc.calculate_ctc(x, torch.tensor(targets), torch.tensor(lens), torch.tensor(tl), blank=0)
    else:
        scores = _function_scores(torch.log_softmax(x, dim=-1), torch.tensor(lens), torch.tensor(targets),
                                  torch.tensor(tl))
        assert scores.shape == (2,) and bool(torch.isfinite(scores).all())
        got = (scores / torch.tensor(tl)).mean()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-5)


def test_kernel_wrappers_take_plain_versions_on_cpu_and_count_no_launch(case):
    lp, targets, lens, tl = case
    lp_z, skip_ok = pctc.extended_emissions(torch.tensor(lp), torch.tensor(targets), 0)
    t_lens, t_tl = torch.tensor(lens), torch.tensor(tl)
    before = (kctc.ctc_alpha.launches, kctc.ctc_beta.launches)
    alpha = kctc.ctc_alpha(lp_z, skip_ok, t_lens, t_tl)
    torch.testing.assert_close(alpha, kctc.alpha_reference(lp_z, skip_ok, t_lens, t_tl), rtol=0, atol=0)
    ll = kctc.ll_from_alpha(alpha, t_lens, t_tl)
    ghat = torch.ones_like(ll)
    dlp = kctc.ctc_beta(lp_z, alpha, skip_ok, t_lens, t_tl, ll, ghat)
    assert (kctc.ctc_alpha.launches, kctc.ctc_beta.launches) == before
    # alpha freezes past each length; dlp is exactly zero there
    for b, n in enumerate(lens):
        assert torch.equal(alpha[n:, b], alpha[n - 1 : n, b].expand(len(lp_z) - n, -1))
        assert bool((dlp[n:, b] == 0).all())
    # occupancy: at every valid frame the state posteriors of a possible row sum to 1, up to the f32
    # spacing of exponents summed from terms near 2 * |ll| = 240 (1.5e-5 each)
    occ = dlp[: lens[0], 0].sum(dim=1)
    torch.testing.assert_close(occ, torch.ones_like(occ), rtol=0, atol=1e-4)


def test_kernel_wrappers_check_their_inputs(case):
    lp, targets, lens, tl = case
    lp_z, skip_ok = pctc.extended_emissions(torch.tensor(lp), torch.tensor(targets), 0)
    t_lens, t_tl = torch.tensor(lens), torch.tensor(tl)
    with pytest.raises(ValueError, match="float32"):
        kctc.ctc_alpha(lp_z.double(), skip_ok, t_lens, t_tl)
    with pytest.raises(ValueError, match="skip_ok"):
        kctc.ctc_alpha(lp_z, skip_ok.int(), t_lens, t_tl)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kctc.ctc_alpha(lp_z.to("meta"), skip_ok.to("meta"), t_lens.to("meta"), t_tl.to("meta"))


@pytest.mark.parametrize("s_dim", [1, 2, 3, 33, 129, 257, 1025, 2049, 16385, 29054])
def test_ctc_plan_covers_every_state_once(s_dim):
    """The kernels' plan (``ctc_plan``, held to ``thunder_ctc_plan`` on the card): lane ``x`` of the row's block
    holds states ``SPL x .. SPL x + SPL - 1``; every state lies in exactly one lane, no warp is idle, warps of two
    states a lane carry a row up to 256 states, and warps of 8, 16 or 32 states a lane above."""
    plan = kctc.ctc_plan(s_dim)
    warps, spl = plan["warps"], plan["states_per_lane"]
    assert 1 <= warps <= 32 and 1 <= spl <= 32
    covered = np.zeros(s_dim, np.int64)
    for lane in range(32 * warps):
        states = np.arange(lane * spl, (lane + 1) * spl)
        covered[states[states < s_dim]] += 1
    assert (covered == 1).all()
    assert 32 * (warps - 1) * spl < s_dim  # the last warp holds a state
    if s_dim <= 256:
        assert (warps, spl) == (-(-s_dim // 64), 2)
    else:
        assert spl in (8, 16, 32) and (spl == 8 or s_dim > 32 * 32 * spl // 2)


def test_ctc_plan_refuses_outside_its_states():
    assert kctc.ctc_plan(kctc.MAX_STATES) == {"warps": 32, "states_per_lane": 32}
    for s_dim in (0, kctc.MAX_STATES + 1):
        with pytest.raises(ValueError, match="extended states"):
            kctc.ctc_plan(s_dim)


def test_two_exponential_lse3_gives_the_plain_bits():
    """The kernels' lse3 takes the exponentials of the two terms below the max (the max term's is exp(0) = 1) and
    adds in the plain version's order: ``(1 + e_p) + e_c`` when a or b is the max, ``(e_a + e_b) + 1`` when c is.
    In float32, on random values, ties between any two terms and the NEG sentinel, that is ``_lse3`` bit for bit."""
    x = torch.as_tensor(np.random.default_rng(3).normal(0.0, 5.0, (3, 200000)).astype(np.float32))
    x[:, ::7] = kctc.NEG
    x[1, ::5], x[2, ::11], x[2, ::13] = x[0, ::5], x[1, ::11], x[0, ::13]
    a, b, c = x
    p, q = torch.minimum(a, b), torch.maximum(a, b)
    m, r = torch.maximum(q, c), torch.minimum(q, c)
    ep, er = torch.exp(p - m), torch.exp(r - m)
    c_top, one = c >= q, torch.ones_like(ep)
    got = m + torch.log((ep + torch.where(c_top, er, one)) + torch.where(c_top, one, er))
    assert torch.equal(got, kctc._lse3(a, b, c))
