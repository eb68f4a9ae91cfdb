"""CTC prefix beam-search decoding on the host (numpy and the C++ runtime).

Port of ``thunder_tpu/ops/ctc_beam.py``: the exact numpy reference of the
prefix beam search (Hannun et al., 2014), carried state for cross-window
decoding, and the batched best-path and n-best entry points. It is the
``beam_backend="host"`` search of the port and the independent oracle that
``chip_smoke.py`` holds the device search against. With ``use_native``
(the default, as in the JAX package) the entry points run the same search in
the port's C++ runtime (:mod:`thunder_tpu_torch.native`,
``tn_ctc_beam_search*``), with an ``NGramLM``, ``ArpaLM`` or ``WordFusionLM``
fused inside it through the LM's ``native()`` mirror; an ``lm`` without one,
or a machine where the runtime does not build, runs the numpy search.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from thunder_tpu_torch.native import native_available, native_ctc_beam_search_batch, native_ctc_beam_search_stream

__all__ = [
    "prefix_beam_search",
    "beam_search_decode",
    "beam_search_nbest",
    "BeamState",
    "beam_search_stream",
    "log_softmax",
]


def log_softmax(logits: np.ndarray) -> np.ndarray:
    """Numerically stable log-softmax over the last axis (host-side numpy)."""
    logits = np.asarray(logits, np.float32)
    m = logits.max(axis=-1, keepdims=True)
    return logits - m - np.log(np.exp(logits - m).sum(axis=-1, keepdims=True))

_NEG_INF = -np.inf


def _native_lm(lm):
    """The LM's C++ mirror (``lm.native()``), or ``None`` for no LM or an LM without one."""
    return lm.native() if (lm is not None and hasattr(lm, "native")) else None


def _logaddexp(a: float, b: float) -> float:
    if a == _NEG_INF:
        return b
    if b == _NEG_INF:
        return a
    m = a if a > b else b
    return m + np.log1p(np.exp(-abs(a - b)))


def prefix_beam_search(
    log_probs: np.ndarray,
    blank: int,
    beam_width: int = 16,
    prune_logp: float = _NEG_INF,
    max_tokens_per_step: Optional[int] = None,
    lm=None,
    lm_weight: float = 0.5,
    init_beams: Optional[Dict[Tuple[int, ...], Tuple[float, float]]] = None,
    return_beams: bool = False,
    finalize: bool = False,
) -> List[Tuple[Tuple[int, ...], float]]:
    """Exact prefix beam search over one utterance.

    Args:
        log_probs: ``(T, V)`` log-softmax outputs.
        blank: blank token index.
        beam_width: beams kept per step.
        prune_logp: per-step emission floor — tokens with
            ``log_probs[t, v] < prune_logp`` are not expanded (exact when
            ``-inf``; common speed/quality tradeoff around ``-10``).
        max_tokens_per_step: additionally cap candidates to the top-K
            emissions per frame (the blank is kept whenever it passes the
            prune floor) — bounds the cost on large vocabularies even when
            the floor does not bite.
        lm: optional shallow-fusion scorer ``lm(prefix_ids, token) -> logp``
            (e.g. :class:`thunder_tpu_torch.text.lm.NGramLM`; ``final_score`` is read when present), added with weight
            ``lm_weight`` each time a prefix is extended by ``token``.
        init_beams: carried beam state ``prefix -> (pb, pnb)`` from a previous
            window (cross-chunk decoding); default seeds the empty prefix.
        return_beams: also return the final beam dict, for carrying into the
            next window.
        finalize: the utterance is COMPLETE — when ``lm`` has a
            ``final_score(prefix)`` method (word fusion's pending-partial
            bonus), add ``lm_weight * final_score`` to the output ranking
            (the returned beam dict stays raw, it is carried state).

    Returns:
        Up to ``beam_width`` ``(prefix, log_prob)`` pairs, best first, where
        ``log_prob`` sums over all alignments collapsing to ``prefix``.
        With ``return_beams``: ``(pairs, final_beams_dict)``.
    """
    T, V = log_probs.shape
    # prefix -> (log p ending in blank, log p ending in non-blank)
    beams = dict(init_beams) if init_beams else {(): (0.0, _NEG_INF)}
    for t in range(T):
        step = log_probs[t]
        keep = np.nonzero(step >= prune_logp)[0] if prune_logp != _NEG_INF else np.arange(V)
        if max_tokens_per_step is not None and len(keep) > max_tokens_per_step:
            top = np.argpartition(step, -max_tokens_per_step)[-max_tokens_per_step:]
            keep = np.union1d(top, [blank]) if blank not in top else np.sort(top)
            if prune_logp != _NEG_INF:
                keep = keep[step[keep] >= prune_logp]
        nxt: dict = {}

        def acc(prefix, pb=None, pnb=None):
            old_b, old_nb = nxt.get(prefix, (_NEG_INF, _NEG_INF))
            if pb is not None:
                old_b = _logaddexp(old_b, pb)
            if pnb is not None:
                old_nb = _logaddexp(old_nb, pnb)
            nxt[prefix] = (old_b, old_nb)

        for prefix, (pb, pnb) in beams.items():
            total = _logaddexp(pb, pnb)
            last = prefix[-1] if prefix else None
            for v in keep:
                p = float(step[v])
                if v == blank:
                    acc(prefix, pb=total + p)
                    continue
                bonus = lm_weight * lm(prefix, v) if lm is not None else 0.0
                if v == last:
                    # repeat emission collapses into the same prefix...
                    acc(prefix, pnb=pnb + p)
                    # ...unless separated by blank: extends the prefix
                    acc(prefix + (v,), pnb=pb + p + bonus)
                else:
                    acc(prefix + (v,), pnb=total + p + bonus)
        if not nxt:
            # every token pruned this frame: skip it (matches the C++ runtime)
            continue
        ranked = sorted(nxt.items(), key=lambda kv: -_logaddexp(*kv[1]))
        beams = dict(ranked[:beam_width])
    final_fn = getattr(lm, "final_score", None) if (finalize and lm is not None) else None
    out = [
        (
            prefix,
            _logaddexp(pb, pnb)
            + (lm_weight * final_fn(prefix) if final_fn is not None else 0.0),
        )
        for prefix, (pb, pnb) in beams.items()
    ]
    out.sort(key=lambda kv: -kv[1])
    if return_beams:
        # truncate: with T == 0 the loop never ran, so init/seed beams may
        # still exceed beam_width
        final = {p: beams[p] for p, _ in out[:beam_width]}
        return out, final
    return out


class BeamState:
    """Carried prefix-beam state for cross-chunk / streaming CTC decoding.

    Wraps the ``prefix -> (log p ending in blank, log p ending in non-blank)``
    dict that :func:`prefix_beam_search` threads between frames, so a long
    utterance can be decoded window by window as ONE continuous beam search —
    a token straddling a window boundary merges exactly as it would in a
    full-utterance search (unlike searching each window independently and
    concatenating label sequences).
    """

    __slots__ = ("beams",)

    def __init__(self, beams: Optional[Dict[Tuple[int, ...], Tuple[float, float]]] = None):
        self.beams = beams if beams is not None else {(): (0.0, _NEG_INF)}

    @property
    def best(self) -> np.ndarray:
        """Best prefix so far (collapsed label ids, int32)."""
        if not self.beams:
            return np.zeros((0,), np.int32)
        prefix = max(self.beams.items(), key=lambda kv: _logaddexp(*kv[1]))[0]
        return np.asarray(prefix, np.int32)

    @property
    def best_score(self) -> float:
        if not self.beams:
            return _NEG_INF
        return max(_logaddexp(pb, pnb) for pb, pnb in self.beams.values())

    def best_final(self, lm=None, lm_weight: float = 0.0) -> np.ndarray:
        """Best prefix for a FINISHED stream.

        When ``lm`` has ``final_score`` (word fusion), the pending-partial-
        word bonus joins the ranking — the final word of the utterance gets
        its LM/hotword score like every other word.  Carried state is never
        mutated, so this may only be used at flush/end-of-utterance.
        """
        final_fn = getattr(lm, "final_score", None) if lm is not None else None
        if final_fn is None or not self.beams:
            return self.best
        prefix = max(
            self.beams.items(),
            key=lambda kv: _logaddexp(*kv[1]) + lm_weight * final_fn(kv[0]),
        )[0]
        return np.asarray(prefix, np.int32)

    def best_partial(self, lm=None, lm_weight: float = 0.0) -> np.ndarray:
        """Best prefix for a LIVE stream's partial display.

        When ``lm`` has ``partial_score`` (word fusion's completion
        lookahead), the trailing in-flight word contributes its best-case
        LM/hotword evidence to the ranking — so partial text doesn't flip
        away from a hypothesis whose last word is still being emitted.
        Ranking-only: carried state is never mutated, and finalization
        (:meth:`best_final` at flush) is unaffected.
        """
        partial_fn = getattr(lm, "partial_score", None) if lm is not None else None
        if partial_fn is None or not self.beams:
            return self.best
        prefix = max(
            self.beams.items(),
            key=lambda kv: _logaddexp(*kv[1]) + lm_weight * partial_fn(kv[0]),
        )[0]
        return np.asarray(prefix, np.int32)


def beam_search_stream(
    logp: np.ndarray,
    blank: int,
    beam_width: int = 16,
    prune_logp: float = -12.0,
    max_tokens_per_step: int = 50,
    lm=None,
    lm_weight: float = 0.5,
    state: Optional[BeamState] = None,
    use_native: bool = True,
) -> BeamState:
    """Advance carried beam state over one ``(T, V)`` log-softmax window.

    Seeding window k+1 with window k's surviving beams makes chunked decoding
    a single continuous prefix beam search over the stitched frame timeline:
    when the windows' log-probs tile the full utterance's, the result is
    *identical* to beam-searching the whole utterance at once.  LM fusion
    also improves: the scorer sees the full carried prefix, not a chunk-local
    fragment.

    Uses the C++ runtime (``tn_ctc_beam_search_stream_lm``) when available —
    including LM fusion when ``lm`` has a native mirror (``lm.native()``);
    only arbitrary Python ``lm`` callables fall back to the numpy reference.
    """
    state = state or BeamState()
    logp = np.asarray(logp, np.float32)
    native_lm = _native_lm(lm) if use_native else None
    if use_native and (lm is None or native_lm is not None) and native_available():
        res = native_ctc_beam_search_stream(
            logp,
            blank,
            beam_width,
            prune_logp,
            max_tokens_per_step=max_tokens_per_step,
            in_beams=[(np.asarray(p, np.int32), pb, pnb) for p, (pb, pnb) in state.beams.items()],
            lm=native_lm,
            lm_weight=lm_weight if native_lm is not None else 0.0,
        )
        if res is not None:
            return BeamState({tuple(int(x) for x in p): (pb, pnb) for p, pb, pnb in res})
    _, beams = prefix_beam_search(
        logp,
        blank,
        beam_width,
        prune_logp,
        max_tokens_per_step,
        lm=lm,
        lm_weight=lm_weight,
        init_beams=state.beams,
        return_beams=True,
    )
    return BeamState(beams)


def beam_search_nbest(
    logits: np.ndarray,
    lengths: Optional[Sequence[int]] = None,
    blank: Optional[int] = None,
    beam_width: int = 16,
    nbest: int = 4,
    prune_logp: float = -12.0,
    max_tokens_per_step: int = 50,
    lm=None,
    lm_weight: float = 0.5,
    use_native: bool = True,
) -> List[List[Tuple[np.ndarray, float]]]:
    """N-best decode: ``(B, T, V)`` logits -> per sample the top ``nbest``
    ``(label ids, total log-prob)`` pairs, best first.

    Runs the same search as :func:`beam_search_decode` (C++ when available —
    the stream entry point exports every surviving beam) and ranks the final
    beams with the end-of-utterance fusion bonus applied, so hypothesis
    scores are directly comparable for downstream rescoring.
    """
    logits = np.asarray(logits, np.float32)
    B, T, V = logits.shape
    if blank is None:
        blank = V - 1
    if lengths is None:
        lengths = [T] * B
    logp = log_softmax(logits)
    final_fn = getattr(lm, "final_score", None) if lm is not None else None
    out = []
    for b in range(B):
        state = beam_search_stream(
            logp[b, : int(lengths[b])],
            blank,
            beam_width=beam_width,
            prune_logp=prune_logp,
            max_tokens_per_step=max_tokens_per_step,
            lm=lm,
            lm_weight=lm_weight,
            use_native=use_native,
        )
        ranked = sorted(
            (
                (
                    prefix,
                    _logaddexp(pb, pnb)
                    + (lm_weight * final_fn(prefix) if final_fn is not None else 0.0),
                )
                for prefix, (pb, pnb) in state.beams.items()
            ),
            key=lambda kv: -kv[1],
        )
        out.append([(np.asarray(p, np.int32), s) for p, s in ranked[:nbest]])
    return out


def beam_search_decode(
    logits: np.ndarray,
    lengths: Optional[Sequence[int]] = None,
    blank: Optional[int] = None,
    beam_width: int = 16,
    prune_logp: float = -12.0,
    max_tokens_per_step: int = 50,
    lm=None,
    lm_weight: float = 0.5,
    use_native: bool = True,
) -> List[np.ndarray]:
    """Batched best-path decode: ``(B, T, V)`` logits -> list of id arrays.

    Applies log-softmax, runs prefix beam search per sample over its valid
    frames (the C++ runtime when available, else the numpy reference), and
    returns each best label sequence — already collapsed, ready for
    ``BatchTextTransformer.decode_prediction(..., remove_repeated=False)``.
    """
    logits = np.asarray(logits, np.float32)
    B, T, V = logits.shape
    if blank is None:
        blank = V - 1
    if lengths is None:
        lengths = [T] * B
    logp = log_softmax(logits)

    native_lm = _native_lm(lm) if use_native else None
    if use_native and (lm is None or native_lm is not None) and native_available():
        # an LM with a native mirror fuses in C++; arbitrary Python lm callables run the numpy reference (the
        # only path that can call back into them). The batch entry point threads the independent per-sample
        # searches over host cores.
        res = native_ctc_beam_search_batch(
            logp,
            lengths,
            blank,
            beam_width,
            prune_logp,
            max_tokens_per_step=max_tokens_per_step,
            lm=native_lm,
            lm_weight=lm_weight if native_lm is not None else 0.0,
        )
        if res is not None:
            return res

    out = []
    for b in range(B):
        lp = logp[b, : int(lengths[b])]
        hyps = prefix_beam_search(
            lp, blank, beam_width, prune_logp, max_tokens_per_step,
            lm=lm, lm_weight=lm_weight, finalize=True,
        )
        best = hyps[0][0] if hyps else ()
        out.append(np.asarray(best, np.int32))
    return out
