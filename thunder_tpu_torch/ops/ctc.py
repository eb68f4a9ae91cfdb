"""CTC loss and greedy decoding.

Port of ``ctc_forward_scores``, ``ctc_loss``, ``calculate_ctc``,
``ctc_forced_align``, ``alignment_segments``, ``greedy_decode`` and
``collapse_ctc`` from ``thunder_tpu/ops/ctc.py``.

The loss is the log-semiring forward recursion over the extended label
sequence (blanks interleaved), in float32. For CUDA tensors the recursion is
the hand-written kernel pair of :mod:`thunder_tpu_torch.kernels.ctc` (its
backward is the beta recursion); for CPU tensors it is the plain time loop
with autograd through it. There is no other route. Parity target, as for the
JAX package: ``torch.nn.functional.ctc_loss(reduction="mean",
zero_infinity=True)`` as the reference's ``calculate_ctc`` wraps it.

The forced alignment is the same lattice with max in place of logsumexp, a
frame loop of PyTorch calls on the device where the log-probs lie (the JAX
package runs it as a ``lax.scan``, outside any kernel of its own).
"""

from __future__ import annotations

import numpy as np
import torch

from thunder_tpu_torch.kernels.ctc import ctc_ll, ctc_ll_reference, extended_emissions, scores_from_ll

__all__ = [
    "extended_emissions",
    "scores_from_ll",
    "ctc_forward_scores",
    "ctc_loss",
    "calculate_ctc",
    "ctc_forced_align",
    "alignment_segments",
    "greedy_decode",
    "collapse_ctc",
]

_NEG = -1e30


def ctc_forward_scores(
    log_probs: torch.Tensor,
    logit_lengths: torch.Tensor,
    targets: torch.Tensor,
    target_lengths: torch.Tensor,
    blank: int,
) -> torch.Tensor:
    """Per-sample negative log likelihood ``(batch,)`` float32 (``+inf`` for
    impossible alignments).

    Args:
        log_probs: ``(batch, time, vocab)`` log-softmax outputs.
        logit_lengths: ``(batch,)`` valid frames per sample.
        targets: ``(batch, max_label_len)`` int labels (padding arbitrary).
        target_lengths: ``(batch,)`` valid labels per sample.
        blank: index of the CTC blank token.
    """
    lp_z, skip_ok = extended_emissions(log_probs, targets, blank)
    logit_lengths = logit_lengths.to(device=lp_z.device, dtype=torch.int32)
    target_lengths = target_lengths.to(device=lp_z.device, dtype=torch.int32)
    # The CPU keeps autograd through the loop, as the JAX package keeps its scan off the TPU: the beta
    # recursion's float32 gradient carries the rounding of log-domain sums of about 100-200 nats, and
    # misses the scan's gradient by more than the JAX package's 1e-5 on per-sample (sum) losses.
    recursion = ctc_ll if lp_z.device.type == "cuda" else ctc_ll_reference
    return scores_from_ll(recursion(lp_z, skip_ok, logit_lengths, target_lengths))


def ctc_loss(
    log_probs: torch.Tensor,
    logit_lengths: torch.Tensor,
    targets: torch.Tensor,
    target_lengths: torch.Tensor,
    blank: int = 0,
    reduction: str = "mean",
    zero_infinity: bool = True,
    sample_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """CTC loss with torch-compatible reductions over already log-softmaxed
    ``(batch, time, vocab)`` input.

    ``sample_weights`` (``(batch,)``) weights each sample in the ``mean`` and
    ``sum`` reductions; zero-weight rows are excluded exactly.
    """
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"unknown reduction: {reduction}")
    losses = ctc_forward_scores(log_probs, logit_lengths, targets, target_lengths, blank)
    if zero_infinity:
        losses = torch.where(torch.isinf(losses), torch.zeros_like(losses), losses)
    if reduction == "none":
        return losses
    w = None if sample_weights is None else sample_weights.to(device=losses.device, dtype=losses.dtype)
    if reduction == "sum":
        return (losses * w).sum() if w is not None else losses.sum()
    denom = target_lengths.to(losses.device).clamp_min(1).to(losses.dtype)
    if w is not None:
        return (w * losses / denom).sum() / w.sum().clamp_min(1.0)
    return (losses / denom).mean()


def calculate_ctc(
    logits: torch.Tensor,
    targets: torch.Tensor,
    logit_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
    blank: int,
    sample_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """The reference's ``calculate_ctc``: log-softmax in the logits' dtype, then
    the mean of target-length-normalised losses with zero_infinity.

    ``logits``: raw ``(batch, time, vocab)`` model outputs (channels-last).
    """
    log_probs = torch.log_softmax(logits, dim=-1)
    return ctc_loss(log_probs, logit_lengths, targets, target_lengths, blank=blank, reduction="mean",
                    zero_infinity=True, sample_weights=sample_weights)


def ctc_forced_align(
    log_probs: torch.Tensor,
    logit_lengths: torch.Tensor,
    targets: torch.Tensor,
    target_lengths: torch.Tensor,
    blank: int,
):
    """Viterbi forced alignment: the best CTC path for each (audio, text).

    The lattice of :func:`ctc_forward_scores` with max in place of logsumexp,
    int8 back-pointers (ties go to the lowest choice: stay, then one state
    back, then two, as ``torch.argmax`` and ``jnp.argmax`` both take the first
    maximum), then the backtrace, both as frame loops on the log-probs'
    device. Frames past a row's length hold its state.

    Args:
        log_probs: ``(batch, time, vocab)`` log-softmax outputs.
        logit_lengths / targets / target_lengths / blank: as in
            :func:`ctc_forward_scores`; a target length may be zero.

    Returns:
        ``(states, labels, scores)``: extended-lattice state per frame
        ``(batch, time)`` int32 (state ``2i+1`` = target token ``i``, even =
        blank; frames past a row's length repeat its end state), per-frame
        label ids ``(batch, time)`` int32, and best-path log-probs ``(batch,)``
        (``-inf`` when no alignment fits, e.g. ``time < 2 * target_length``).
    """
    device, dtype = log_probs.device, log_probs.dtype
    batch, max_t, _ = log_probs.shape
    targets = targets.to(device=device, dtype=torch.int64)
    logit_lengths = logit_lengths.to(device=device, dtype=torch.int64)
    target_lengths = target_lengths.to(device=device, dtype=torch.int64)
    s_dim = 2 * targets.shape[1] + 1

    z = torch.full((batch, s_dim), blank, dtype=torch.int64, device=device)
    z[:, 1::2] = targets
    z_prev2 = torch.nn.functional.pad(z, (2, 0), value=-1)[:, :s_dim]
    is_label = torch.arange(s_dim, device=device) % 2 == 1
    skip_ok = is_label[None, :] & (z != z_prev2)
    lp_z = log_probs.gather(2, z[:, None, :].expand(batch, max_t, s_dim)).transpose(0, 1)  # (T, B, S)

    neg = torch.tensor(_NEG, dtype=dtype, device=device)
    alpha = torch.full((batch, s_dim), _NEG, dtype=dtype, device=device)
    alpha[:, 0] = lp_z[0, :, 0]
    if s_dim > 1:
        alpha[:, 1] = torch.where(target_lengths > 0, lp_z[0, :, 1], neg)
    # choices[t] is frame t's back-pointer (0 = stay, 1 or 2 states back); frame 0 has none
    choices = torch.zeros((max_t, batch, s_dim), dtype=torch.int8, device=device)
    for t in range(1, max_t):
        a1 = torch.nn.functional.pad(alpha, (1, 0), value=_NEG)[:, :s_dim]
        a2 = torch.where(skip_ok, torch.nn.functional.pad(alpha, (2, 0), value=_NEG)[:, :s_dim], neg)
        stacked = torch.stack([alpha, a1, a2])
        choices[t] = torch.argmax(stacked, dim=0)
        new_alpha = stacked.amax(dim=0) + lp_z[t]
        alpha = torch.where((t < logit_lengths)[:, None], new_alpha, alpha)

    end = 2 * target_lengths
    a_end = alpha.gather(1, end[:, None])[:, 0]
    a_end1 = alpha.gather(1, (end - 1).clamp_min(0)[:, None])[:, 0]
    a_end1 = torch.where(target_lengths > 0, a_end1, neg)
    scores = torch.maximum(a_end, a_end1)
    end_state = torch.where(a_end >= a_end1, end, (end - 1).clamp_min(0))

    # Backtrace over reversed time: at a row's last frame the state resets to its end state; past it (padding
    # frames) the state is held there, so the emitted tail is well defined
    states = torch.empty((max_t, batch), dtype=torch.int64, device=device)
    s = end_state
    for t in range(max_t - 1, -1, -1):
        back = choices[min(t + 1, max_t - 1)].gather(1, s[:, None])[:, 0]
        s = torch.where(t == logit_lengths - 1, end_state, torch.where(t < logit_lengths - 1, s - back, s))
        states[t] = s
    states = states.T
    labels = z.gather(1, states)
    scores = torch.where(scores < 0.5 * _NEG, torch.tensor(-float("inf"), dtype=dtype, device=device), scores)
    return states.to(torch.int32), labels.to(torch.int32), scores


def alignment_segments(states, logit_lengths, target_lengths):
    """Token time spans from forced-alignment states (host-side).

    Args:
        states: ``(batch, time)`` from :func:`ctc_forced_align` (numpy or a tensor).
        logit_lengths / target_lengths: valid frames / tokens per sample.

    Returns:
        Per sample, a list of ``(start_frame, end_frame_exclusive)``: entry
        ``i`` is the span of target token ``i`` (lattice state ``2i+1``).
    """
    states = states.cpu().numpy() if isinstance(states, torch.Tensor) else np.asarray(states)
    out = []
    for b in range(states.shape[0]):
        row = states[b, : int(logit_lengths[b])]
        spans = []
        for i in range(int(target_lengths[b])):
            idx = np.nonzero(row == 2 * i + 1)[0]
            spans.append((int(idx[0]), int(idx[-1]) + 1) if idx.size else (0, 0))
        out.append(spans)
    return out


def greedy_decode(logits: torch.Tensor) -> torch.Tensor:
    """Argmax token ids per frame: ``(batch, time, vocab)`` -> int32 ``(batch, time)``."""
    return logits.argmax(dim=-1).to(torch.int32)


def collapse_ctc(ids: np.ndarray, lengths: np.ndarray | None = None, remove_repeated: bool = True):
    """Drop consecutive repeats per row and keep blanks for the text transform
    to strip; rows are cut to ``lengths`` first. Returns a list of 1-D arrays."""
    ids = np.asarray(ids)
    out = []
    for b in range(ids.shape[0]):
        row = ids[b, : int(lengths[b])] if lengths is not None else ids[b]
        if remove_repeated and row.size:
            keep = np.ones(row.shape, dtype=bool)
            keep[1:] = row[1:] != row[:-1]
            row = row[keep]
        out.append(row)
    return out
