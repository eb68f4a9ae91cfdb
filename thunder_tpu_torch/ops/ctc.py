"""CTC loss and greedy decoding.

Port of ``ctc_forward_scores``, ``ctc_loss``, ``calculate_ctc``,
``greedy_decode`` and ``collapse_ctc`` from ``thunder_tpu/ops/ctc.py``.

The loss is the log-semiring forward recursion over the extended label
sequence (blanks interleaved), in float32. For CUDA tensors the recursion is
the hand-written kernel pair of :mod:`thunder_tpu_torch.kernels.ctc` (its
backward is the beta recursion); for CPU tensors it is the plain time loop
with autograd through it. There is no other route. Parity target, as for the
JAX package: ``torch.nn.functional.ctc_loss(reduction="mean",
zero_infinity=True)`` as the reference's ``calculate_ctc`` wraps it.
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
    "greedy_decode",
    "collapse_ctc",
]


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
