"""Batched CTC prefix beam search on the device.

Port of ``thunder_tpu/ops/ctc_beam_device.py``: the same search as the host
reference (:func:`thunder_tpu_torch.ops.ctc_beam.prefix_beam_search`), run
over a whole batch of ``(B, T, V)`` logits where they lie, so that the
logits never cross to the host. Beam identity is a pair of rolling 32-bit
hashes, the merge of an extension into the beam that already holds its
prefix is one hash-equality compare, and the prefixes are rebuilt by a
backtrace over per-frame pointers; only the ``(B, n_out, T)`` token matrix
and the scores come back to the host.

Two kernels carry it (:mod:`thunder_tpu_torch.kernels.beam`): the frame scan
and the pointer-walk backtrace. On the card they are CUDA kernels; for CPU
tensors their plain PyTorch versions run. The device of the logits picks
the route, and numpy logits go to ``device`` (the card unless the caller
asks for the CPU).

An ``lm`` never enters the device search: every surviving beam is LM-ranked
on the host (:func:`lm_prefix_score`, ``DeviceBeamState.best_ranked``), the
on-the-fly rescoring of the JAX package's device backend. Its ``use_pallas``,
``mesh`` and ``data_axis`` arguments are not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from thunder_tpu_torch.kernels.beam import MAX_CANDIDATES, beam_backtrace, beam_scan

__all__ = ["beam_search_device", "beam_search_device_stream", "DeviceBeamState", "lm_prefix_score"]


def _inputs(logits, lengths, device):
    """``(logits, lengths)`` as a tensor on the logits' device (numpy goes to ``device``) and int32 lengths there."""
    if not isinstance(logits, torch.Tensor):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device is available")
        logits = torch.as_tensor(np.asarray(logits, np.float32), device=dev)
    batch, frames, _ = logits.shape
    if lengths is None:
        lengths = torch.full((batch,), frames, dtype=torch.int32, device=logits.device)
    elif isinstance(lengths, torch.Tensor):
        lengths = lengths.to(logits.device, torch.int32)
    else:
        lengths = torch.as_tensor(np.asarray(lengths, np.int32), device=logits.device)
    return logits, lengths


def _k_tokens(max_tokens_per_step, vocab: int) -> int:
    return vocab if max_tokens_per_step is None else min(int(max_tokens_per_step), vocab)


def beam_search_device(
    logits,
    lengths: Optional[Sequence[int]] = None,
    blank: Optional[int] = None,
    beam_width: int = 16,
    prune_logp: float = -12.0,
    max_tokens_per_step: int = 50,
    nbest: Optional[int] = None,
    lm=None,
    lm_weight: float = 0.0,
    device="cuda",
):
    """Batched prefix beam search over ``(B, T, V)`` logits on their device.

    Drop-in for :func:`thunder_tpu_torch.ops.ctc_beam.beam_search_decode` /
    ``beam_search_nbest`` when no LM is fused: ``nbest=None`` gives one
    collapsed id array per sample, else the top-``nbest`` ``(ids, log_prob)``
    pairs per sample, best first. ``logits`` may be a live tensor (the
    module and engine pass their forward's logits straight in). The search
    runs in float32 on log-softmax of the logits; ``K = min(max_tokens_per_step,
    V)`` and ``beam_width`` may be any size (past 2,901 beams the scan keeps its
    arrays in device memory, :func:`~thunder_tpu_torch.kernels.beam.scan_plan`).
    """
    logits, lengths = _inputs(logits, lengths, device)
    batch, frames, vocab = logits.shape
    if blank is None:
        blank = vocab - 1
    k = _k_tokens(max_tokens_per_step, vocab)
    # with an LM, rank over the FULL beam on the host (on-the-fly rescoring)
    n_out = int(beam_width) if lm is not None else (1 if nbest is None else min(int(nbest), beam_width))
    if frames == 0:
        # no frames: the fresh state, whose one live beam is the empty prefix; nothing is launched
        toks = np.zeros((batch, n_out, 0), np.int32)
        scores = np.full((batch, n_out), -np.inf, np.float32)
        scores[:, 0] = 0.0
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        parents, exts, total, _ = beam_scan(logp, lengths, prune_logp, blank=int(blank), beam_width=int(beam_width),
                                            k_tokens=k)
        slots0 = torch.argsort(-total, dim=1, stable=True)[:, :n_out]  # ties -> lower slot
        toks, _ = beam_backtrace(parents, exts, slots0.to(torch.int32))
        toks = toks.cpu().numpy()  # (B, n_out, T), -1 = no emission
        scores = total.gather(1, slots0).cpu().numpy()
    if lm is not None:
        ranked = []
        for b, row in enumerate(toks):
            hyps = [
                (row[n][row[n] >= 0].astype(np.int32), float(scores[b, n]))
                for n in range(n_out)
                if np.isfinite(scores[b, n])
            ]
            hyps = [(ids, s + lm_weight * lm_prefix_score(lm, ids, final=True)) for ids, s in hyps]
            hyps.sort(key=lambda h: -h[1])
            ranked.append(hyps)
        if nbest is None:
            return [(r[0][0] if r else np.zeros((0,), np.int32)) for r in ranked]
        return [r[: min(int(nbest), len(r))] for r in ranked]
    if nbest is None:
        return [row[0][row[0] >= 0].astype(np.int32) for row in toks]
    return [
        [
            (row[n][row[n] >= 0].astype(np.int32), float(scores[b, n]))
            for n in range(n_out)
            if np.isfinite(scores[b, n])
        ]
        for b, row in enumerate(toks)
    ]


def lm_prefix_score(lm, prefix, final: bool = True) -> float:
    """Total LM score of a collapsed prefix, on the host.

    Sums the per-token shallow-fusion bonuses the host search would have
    accumulated (``lm(prefix[:i], prefix[i])``) plus the pending-word add-on
    (``final_score`` at end of utterance, ``partial_score`` for live display)
    when the scorer provides one. The device search stays acoustic-only, and
    the LM ranks its survivors; unlike the host backend's in-search fusion,
    the LM does not influence which beams survive pruning."""
    seq = tuple(int(t) for t in np.asarray(prefix).reshape(-1))
    s = 0.0
    for i in range(len(seq)):
        s += float(lm(seq[:i], seq[i]))
    add = getattr(lm, "final_score" if final else "partial_score", None)
    if add is not None:
        s += float(add(seq))
    return s


class DeviceBeamState:
    """Carried state for cross-window streaming decode on the device.

    The device analogue of :class:`thunder_tpu_torch.ops.ctc_beam.BeamState`:
    the search state (``p_blank``/``p_nonblank``/hashes/last token per beam
    slot) stays on the device between windows, and the host carries only
    each slot's collapsed prefix so far plus its total score. Seeding window
    k+1 with window k's state makes chunked decoding ONE continuous prefix
    beam search, identical to searching the stitched frames at once.
    """

    __slots__ = ("arrays", "prefixes", "total")

    def __init__(self, arrays=None, prefixes=None, total=None):
        #: 5-tuple of (B, W) tensors (pb, pnb, h1, h2, last) on the device, or None
        self.arrays = arrays
        #: per sample: list of W collapsed-prefix id arrays (None = dead slot)
        self.prefixes = prefixes
        #: (B, W) float array of per-slot total log probabilities
        self.total = total

    def best(self) -> List[np.ndarray]:
        """Best prefix per sample so far (collapsed label ids, int32)."""
        if self.total is None:
            return []
        out = []
        for b in range(self.total.shape[0]):
            w = int(np.argmax(self.total[b]))
            pref = self.prefixes[b][w]
            out.append(pref if (pref is not None and np.isfinite(self.total[b, w])) else np.zeros((0,), np.int32))
        return out

    def best_ranked(self, lm=None, lm_weight: float = 0.0, final: bool = True) -> List[np.ndarray]:
        """Best prefix per sample with LM-aware ranking: every live slot's
        acoustic total gets ``lm_weight *`` :func:`lm_prefix_score` added
        (``final`` picks ``final_score`` or ``partial_score``). ``lm=None``
        is :meth:`best`. The carried device state is never touched."""
        if lm is None:
            return self.best()
        if self.total is None:
            return []
        out = []
        for b in range(self.total.shape[0]):
            best_pref, best_score = np.zeros((0,), np.int32), -np.inf
            for w in range(self.total.shape[1]):
                pref = self.prefixes[b][w]
                if pref is None or not np.isfinite(self.total[b, w]):
                    continue
                score = float(self.total[b, w]) + lm_weight * lm_prefix_score(lm, pref, final=final)
                if score > best_score:
                    best_pref, best_score = pref, score
            out.append(best_pref)
        return out


def _fresh_prefixes(batch: int, beam_width: int):
    return [[np.zeros((0,), np.int32)] + [None] * (beam_width - 1) for _ in range(batch)]


def beam_search_device_stream(
    logits,
    lengths: Optional[Sequence[int]] = None,
    blank: Optional[int] = None,
    beam_width: int = 16,
    prune_logp: float = -12.0,
    max_tokens_per_step: int = 50,
    state: Optional[DeviceBeamState] = None,
    device="cuda",
) -> DeviceBeamState:
    """Advance carried device beam state over one ``(B, T, V)`` logits window.

    Device analogue of :func:`thunder_tpu_torch.ops.ctc_beam.beam_search_stream`
    (no LM): when the windows' logits tile a full utterance, the result is
    identical to :func:`beam_search_device` over the whole utterance at once.
    Each window is one scan launch from the carried state and one backtrace
    of every slot, which gives the window's emissions per beam and the slot
    each beam descends from in the carried-in state (the stitch key); per
    window only the ``(B, W, T)`` emission matrix and two ``(B, W)`` arrays
    cross to the host. Like the JAX package's stream, it takes ``beam_width * K``
    up to 8192.
    """
    logits, lengths = _inputs(logits, lengths, device)
    batch, frames, vocab = logits.shape
    if blank is None:
        blank = vocab - 1
    W = int(beam_width)
    k = _k_tokens(max_tokens_per_step, vocab)
    if W * k > MAX_CANDIDATES:
        raise ValueError(
            f"device streaming beam requires beam_width*K <= {MAX_CANDIDATES} (got K={k}, W={beam_width}); lower "
            "max_tokens_per_step or use the host backend"
        )
    if state is None:
        state = DeviceBeamState()
    if frames == 0:
        # no frames: a no-op, like the host stream on an empty window; a still-fresh state gains
        # the canonical host view (one live empty prefix) so that best() works before any frame
        if state.arrays is None and state.total is None:
            total = np.full((batch, W), -np.inf, np.float32)
            total[:, 0] = 0.0
            return DeviceBeamState(arrays=None, prefixes=_fresh_prefixes(batch, W), total=total)
        return state
    fresh = state.arrays is None
    logp = torch.log_softmax(logits.float(), dim=-1)
    parents, exts, total, new_arrays = beam_scan(logp, lengths, prune_logp, blank=int(blank), beam_width=W,
                                                 k_tokens=k, init_state=None if fresh else state.arrays)
    slots_all = torch.arange(W, dtype=torch.int32, device=logits.device).expand(batch, W).contiguous()
    toks, origin = beam_backtrace(parents, exts, slots_all)
    toks, origin, total_np = toks.cpu().numpy(), origin.cpu().numpy(), total.cpu().numpy()
    old_prefixes = _fresh_prefixes(batch, W) if fresh else state.prefixes
    prefixes = []
    for b in range(batch):
        row = []
        for w in range(W):
            if not np.isfinite(total_np[b, w]):
                row.append(None)
                continue
            parent = old_prefixes[b][origin[b, w]]
            emitted = toks[b, w][toks[b, w] >= 0]
            if parent is None:
                # a live slot descends from a live ancestor; a dead parent means the whole
                # column never advanced (every frame pruned)
                row.append(emitted.astype(np.int32))
            else:
                row.append(np.concatenate([parent, emitted]).astype(np.int32))
        prefixes.append(row)
    return DeviceBeamState(arrays=new_arrays, prefixes=prefixes, total=total_np)
