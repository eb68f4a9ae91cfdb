"""The CTC alpha/beta recursion: a CUDA kernel pair and its plain PyTorch versions.

Port of ``thunder_tpu/kernels/ctc_pallas.py::ctc_ll_pallas``. The boundary is
the same: per-extended-state emissions ``lp_z (T, B, S)`` float32, the skip
mask ``skip_ok (B, S)`` and the lengths go in, the per-sample log-likelihood
``ll (B,)`` comes out, differentiable in ``lp_z`` through
:class:`CTCRecursion` (a ``torch.autograd.Function``, the counterpart of the
TPU kernel's ``custom_vjp``):

- :func:`ctc_alpha` runs the alpha recursion over T (``csrc/ctc_recursion.cu``,
  ``ctc_alpha_kernel``) and writes alpha, frozen past each length;
- :func:`ll_from_alpha` takes the logsumexp of the two end states at
  ``t = len - 1`` in PyTorch, as XLA does around the TPU kernel;
- :func:`ctc_beta` runs the beta recursion over reversed T
  (``ctc_beta_kernel``) and emits ``dL/dlp_z = ghat * exp(alpha + bb - lp -
  ll)``, zero past each length.

Each wrapper runs its kernel for CUDA tensors and its plain version
(:func:`alpha_reference`, :func:`beta_reference`) only for CPU tensors.
:func:`ctc_ll_reference` is the plain alpha loop with autograd through it,
the loop of ``thunder_tpu/ops/ctc.py:128-159``; ``ops/ctc.py`` takes it for
CPU tensors, and the checks hold :func:`ctc_ll` to it. Impossible alignments
keep end states at ``NEG = -1e30`` (never ``-inf``), so ``ll`` stays finite
and :func:`scores_from_ll` maps it to ``+inf``. :func:`extended_emissions`
makes the kernels' inputs from log-probabilities and targets. :func:`ctc_plan`
mirrors the kernels' launch plan: up to 256 extended states, warps of 64
states (two a lane); above, warps of 32 x 8, 16 or 32 states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from thunder_tpu_torch.kernels import _build

__all__ = [
    "NEG",
    "MAX_STATES",
    "extended_emissions",
    "scores_from_ll",
    "CTCRecursion",
    "ctc_ll",
    "ctc_ll_reference",
    "ctc_alpha",
    "ctc_beta",
    "alpha_reference",
    "beta_reference",
    "ll_from_alpha",
    "ctc_plan",
]

NEG = -1e30
#: one row's block holds at most 32 warps of 32 lanes, each lane at most 32 states (``csrc/ctc_recursion.cu``)
MAX_STATES = 32 * 32 * 32
#: up to SMALL_WARPS warps of 32 lanes, SMALL_STATES_PER_LANE states each (``SMALL_SPL``, ``SMALL_WARPS``)
SMALL_STATES_PER_LANE, SMALL_WARPS = 2, 4


def ctc_plan(s_dim: int) -> dict:
    """Warps and states a lane of one row's block, as ``csrc/ctc_recursion.cu::ctc_plan`` computes them.

    Lane ``l`` of the block holds the consecutive states ``SPL * l + k``, ``k < SPL``. Up to 256 states
    (``32 * SMALL_WARPS * SMALL_STATES_PER_LANE``) the row takes ``ceil(S / 64)`` warps of two states a lane; above,
    the least ``SPL`` of 8, 16 and 32 with ``S <= 1024 * SPL`` and ``ceil(S / (32 * SPL))`` warps. Raises outside
    ``1 .. MAX_STATES``.
    """
    if not 1 <= s_dim <= MAX_STATES:
        raise ValueError(f"the CTC kernels take 1 to {MAX_STATES} extended states (a target of up to "
                         f"{(MAX_STATES - 1) // 2} labels: 32 warps of 32 lanes, 32 states a lane); got {s_dim}")
    small = 32 * SMALL_STATES_PER_LANE
    if s_dim <= small * SMALL_WARPS:
        return {"warps": -(-s_dim // small), "states_per_lane": SMALL_STATES_PER_LANE}
    spl = 8
    while s_dim > 32 * 32 * spl:
        spl *= 2
    return {"warps": -(-s_dim // (32 * spl)), "states_per_lane": spl}


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """Shift the state axis right by ``k``, filling with NEG."""
    return torch.cat([torch.full_like(x[:, :k], NEG), x[:, :-k]], dim=1) if x.shape[1] > k else torch.full_like(x, NEG)


def _shift_left(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.cat([x[:, k:], torch.full_like(x[:, :k], NEG)], dim=1) if x.shape[1] > k else torch.full_like(x, NEG)


def _end_states(target_lengths: torch.Tensor, s_dim: int) -> torch.Tensor:
    """``(B, S)`` bool: the states ``2*tl`` and, for a non-empty target, ``2*tl - 1``."""
    lane = torch.arange(s_dim, device=target_lengths.device)[None, :]
    end = 2 * target_lengths.long()[:, None]
    return (lane == end) | ((lane == end - 1) & (target_lengths[:, None] > 0))


def extended_emissions(log_probs: torch.Tensor, targets: torch.Tensor, blank: int):
    """``(lp_z (T, B, S) float32, skip_ok (B, S) bool)`` for the extended labels
    ``blank, y1, blank, y2, ..., blank`` (S = 2 * max_label_len + 1).

    The gather runs in ``log_probs``' dtype and its result is cast to float32
    afterwards, where the JAX package casts before its TPU kernel.
    """
    batch, _, _ = log_probs.shape
    s_dim = 2 * targets.shape[1] + 1
    z = torch.full((batch, s_dim), blank, dtype=torch.long, device=log_probs.device)
    z[:, 1::2] = targets.to(device=z.device, dtype=torch.long)
    # a skip transition s-2 -> s is allowed into a label that differs from z[s-2]
    z_prev2 = F.pad(z, (2, 0), value=-1)[:, :s_dim]
    is_label = torch.arange(s_dim, device=z.device) % 2 == 1
    skip_ok = is_label[None, :] & (z != z_prev2)
    lp_z = log_probs.gather(2, z[:, None, :].expand(-1, log_probs.shape[1], -1))  # (B, T, S)
    return lp_z.transpose(0, 1).float().contiguous(), skip_ok


def scores_from_ll(ll: torch.Tensor) -> torch.Tensor:
    """``-ll``, with impossible alignments (end states at about NEG) reported as ``+inf``."""
    loss = -ll
    return torch.where(loss > -0.5 * NEG, torch.full_like(loss, float("inf")), loss)


def alpha_reference(lp_z, skip_ok, logit_lengths, target_lengths) -> torch.Tensor:
    """Plain version of the forward kernel: alpha ``(T, B, S)``, frozen past each length.

    Differentiable in ``lp_z`` when autograd records it.
    """
    t_total, _, s_dim = lp_z.shape
    neg = torch.full_like(lp_z[0], NEG)
    lane = torch.arange(s_dim, device=lp_z.device)[None, :]
    init = torch.where(lane == 0, lp_z[0], neg)
    alpha = torch.where((lane == 1) & (target_lengths[:, None] > 0), lp_z[0], init)
    out = [alpha]
    for t in range(1, t_total):
        a1 = _shift_right(alpha, 1)
        a2 = torch.where(skip_ok, _shift_right(alpha, 2), neg)
        new_alpha = _lse3(alpha, a1, a2) + lp_z[t]
        # freeze past each sample's last valid frame
        alpha = torch.where((t < logit_lengths)[:, None], new_alpha, alpha)
        out.append(alpha)
    return torch.stack(out)


def ll_from_alpha(alpha: torch.Tensor, logit_lengths, target_lengths) -> torch.Tensor:
    """``ll (B,)``: logsumexp of alpha's end states at ``t = len - 1``."""
    batch = alpha.shape[1]
    t_idx = (logit_lengths.long() - 1).clamp_min(0)
    a_fin = alpha[t_idx, torch.arange(batch, device=alpha.device)]  # (B, S)
    end = 2 * target_lengths.long()
    a_end = a_fin.gather(1, end[:, None])[:, 0]
    a_end1 = a_fin.gather(1, (end - 1).clamp_min(0)[:, None])[:, 0]
    a_end1 = torch.where(target_lengths > 0, a_end1, torch.full_like(a_end1, NEG))
    m = torch.maximum(a_end, a_end1)
    return m + torch.log(torch.exp(a_end - m) + torch.exp(a_end1 - m))


def beta_reference(lp_z, alpha, skip_ok, logit_lengths, target_lengths, ll, ghat) -> torch.Tensor:
    """Plain version of the backward kernel: ``dL/dlp_z (T, B, S)``, zero past each length."""
    t_total, _, s_dim = lp_z.shape
    neg = torch.full_like(lp_z[0], NEG)
    ends = _end_states(target_lengths, s_dim)
    lens = logit_lengths[:, None]
    dlp = torch.empty_like(lp_z)
    bb = neg  # bb = beta + lp at t + 1; NEG above the last frame
    for t in range(t_total - 1, -1, -1):
        b1 = _shift_left(bb, 1)
        # the skip transition s -> s+2 is gated at its destination
        b2 = _shift_left(torch.where(skip_ok, bb, neg), 2)
        rec = _lse3(bb, b1, b2) + lp_z[t]
        init = torch.where(ends, lp_z[t], neg)
        bb = torch.where(t == lens - 1, init, torch.where(t < lens - 1, rec, neg))
        g = torch.exp(alpha[t] + bb - lp_z[t] - ll[:, None])
        dlp[t] = torch.where(t < lens, g * ghat[:, None], torch.zeros_like(g))
    return dlp


def _check(lp_z, skip_ok, logit_lengths, target_lengths):
    if lp_z.ndim != 3 or lp_z.dtype != torch.float32:
        raise ValueError(f"the CTC recursion takes float32 lp_z (T, B, S), got {tuple(lp_z.shape)} {lp_z.dtype}")
    _, batch, s_dim = lp_z.shape
    if skip_ok.shape != (batch, s_dim) or skip_ok.dtype != torch.bool:
        raise ValueError(f"skip_ok must be bool ({batch}, {s_dim}), got {tuple(skip_ok.shape)} {skip_ok.dtype}")
    for name, t in (("logit_lengths", logit_lengths), ("target_lengths", target_lengths)):
        if t.shape != (batch,):
            raise ValueError(f"{name} must be ({batch},), got {tuple(t.shape)}")


def _device_args(lp_z, *tensors):
    """Check that a CUDA launch gets contiguous tensors on one device; int32 lengths."""
    if lp_z.device.type != "cuda":
        raise ValueError(f"the CTC recursion runs on cuda or cpu tensors, got {lp_z.device}")
    ctc_plan(lp_z.shape[2])
    out = []
    for t in (lp_z, *tensors):
        if t.device != lp_z.device or not t.is_contiguous():
            raise ValueError(f"the CTC kernels take contiguous tensors on {lp_z.device}")
        out.append(t)
    return out


def ctc_alpha(lp_z, skip_ok, logit_lengths, target_lengths) -> torch.Tensor:
    """Alpha ``(T, B, S)`` float32: the forward kernel on the card, :func:`alpha_reference` on the CPU."""
    _check(lp_z, skip_ok, logit_lengths, target_lengths)
    if lp_z.device.type == "cpu":
        return alpha_reference(lp_z, skip_ok, logit_lengths, target_lengths)
    lp_z, skip_ok, lens, tls = _device_args(lp_z, skip_ok, logit_lengths.int(), target_lengths.int())
    t_total, batch, s_dim = lp_z.shape
    alpha = torch.empty_like(lp_z)
    status = _build.load().thunder_ctc_alpha(
        lp_z.data_ptr(), skip_ok.data_ptr(), lens.data_ptr(), tls.data_ptr(), alpha.data_ptr(),
        t_total, batch, s_dim, _build.stream(lp_z),
    )
    _build.check(status, "thunder_ctc_alpha")
    ctc_alpha.launches += 1
    return alpha


def ctc_beta(lp_z, alpha, skip_ok, logit_lengths, target_lengths, ll, ghat) -> torch.Tensor:
    """``dL/dlp_z (T, B, S)`` float32: the backward kernel on the card, :func:`beta_reference` on the CPU."""
    _check(lp_z, skip_ok, logit_lengths, target_lengths)
    if alpha.shape != lp_z.shape or ll.shape != ghat.shape or ll.shape != (lp_z.shape[1],):
        raise ValueError(f"alpha {tuple(alpha.shape)}, ll {tuple(ll.shape)}, ghat {tuple(ghat.shape)} do not fit lp_z")
    if lp_z.device.type == "cpu":
        return beta_reference(lp_z, alpha, skip_ok, logit_lengths, target_lengths, ll, ghat)
    lp_z, alpha, skip_ok, lens, tls, ll, ghat = _device_args(
        lp_z, alpha, skip_ok, logit_lengths.int(), target_lengths.int(), ll.float(), ghat.float().contiguous()
    )
    t_total, batch, s_dim = lp_z.shape
    dlp = torch.empty_like(lp_z)
    status = _build.load().thunder_ctc_beta(
        lp_z.data_ptr(), alpha.data_ptr(), skip_ok.data_ptr(), lens.data_ptr(), tls.data_ptr(), ll.data_ptr(),
        ghat.data_ptr(), dlp.data_ptr(), t_total, batch, s_dim, _build.stream(lp_z),
    )
    _build.check(status, "thunder_ctc_beta")
    ctc_beta.launches += 1
    return dlp


ctc_alpha.launches = 0
ctc_beta.launches = 0


class CTCRecursion(torch.autograd.Function):
    """``lp_z (T, B, S) -> ll (B,)``; the backward is the beta recursion."""

    @staticmethod
    def forward(ctx, lp_z, skip_ok, logit_lengths, target_lengths):
        lp_z = lp_z.contiguous()
        alpha = ctc_alpha(lp_z, skip_ok, logit_lengths, target_lengths)
        ll = ll_from_alpha(alpha, logit_lengths, target_lengths)
        ctx.save_for_backward(lp_z, alpha, skip_ok, logit_lengths, target_lengths, ll)
        return ll

    @staticmethod
    def backward(ctx, ghat):
        lp_z, alpha, skip_ok, logit_lengths, target_lengths, ll = ctx.saved_tensors
        dlp = ctc_beta(lp_z, alpha, skip_ok, logit_lengths, target_lengths, ll, ghat.contiguous())
        return dlp, None, None, None


def ctc_ll(lp_z, skip_ok, logit_lengths, target_lengths) -> torch.Tensor:
    """Per-sample CTC log-likelihood ``(B,)`` through the kernel pair; differentiable in ``lp_z``."""
    return CTCRecursion.apply(lp_z, skip_ok, logit_lengths, target_lengths)


def ctc_ll_reference(lp_z, skip_ok, logit_lengths, target_lengths) -> torch.Tensor:
    """Plain version of :func:`ctc_ll`: the alpha loop with autograd through it."""
    return ll_from_alpha(alpha_reference(lp_z, skip_ok, logit_lengths, target_lengths), logit_lengths, target_lengths)
