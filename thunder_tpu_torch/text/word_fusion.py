"""Word-level shallow fusion for token-level CTC beam search.

Acoustic CTC models emit characters or sentencepiece pieces, but the LMs
that actually move WER are *word*-level (e.g. a KenLM-trained
:class:`~thunder_tpu_torch.text.lm.ArpaLM`).  :class:`WordFusionLM` bridges the
two: it implements the beam's ``lm(prefix_ids, next_token) -> logp`` hook
(`thunder_tpu_torch/ops/ctc_beam.py`) and returns a bonus only when the candidate
token *completes a word* — the completed word is scored against the word
history, exactly the pyctcdecode/Kaldi shallow-fusion recipe.

Boundary semantics per vocabulary style (auto-detected):

- ``char``: the vocabulary's separator token (``" "`` or ``"|"``) ends the
  current word; other tokens accumulate into the partial word.
- ``sentencepiece``: a piece starting with ``"▁"`` *begins* a new word, so
  emitting it completes the previous partial word.

The final (unterminated) partial word of an utterance is never scored —
fusion is boundary-driven, which keeps chunked/streaming decodes identical
to full-utterance decodes (the pinned invariant of
:func:`thunder_tpu_torch.ops.ctc_beam.beam_search_stream`).

Port of ``thunder_tpu/text/word_fusion.py``: the same bonuses, the same
lookahead table, and ``native()`` builds the C++ fusion handle of the port's
runtime (:mod:`thunder_tpu_torch.native`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["WordFusionLM", "WordNGramLM"]

_SP_MARK = "▁"  # "▁"


class WordNGramLM:
    """Stupid-backoff *word*-level n-gram LM trained from transcripts.

    Interns words to ids and delegates counting/scoring to
    :class:`~thunder_tpu_torch.text.lm.NGramLM`, so it exposes the same
    ``word_id`` / ``score_ids`` / ``native`` surface as
    :class:`~thunder_tpu_torch.text.lm.ArpaLM` and plugs into
    :class:`WordFusionLM` interchangeably.
    """

    def __init__(self, order: int = 3, backoff: float = 0.4, oov_logp: float = -12.0):
        from thunder_tpu_torch.text.lm import NGramLM

        self._lm = NGramLM(order=order, backoff=backoff, oov_logp=oov_logp)
        self.vocab: Dict[str, int] = {}
        self.words: List[str] = []

    @property
    def order(self) -> int:
        return self._lm.order

    def fit(self, texts) -> "WordNGramLM":
        seqs = []
        for text in texts:
            seq = []
            for word in text.split():
                wid = self.vocab.get(word)
                if wid is None:
                    wid = len(self.words)
                    self.vocab[word] = wid
                    self.words.append(word)
                seq.append(wid)
            seqs.append(seq)
        self._lm.fit(seqs)
        return self

    def word_id(self, word: str) -> Optional[int]:
        return self.vocab.get(word)

    def score_ids(self, context: Sequence[int], token: Optional[int]) -> float:
        return self._lm.score(context, -1 if token is None else token)

    def native(self):
        return self._lm.native()

    def save(self, path) -> None:
        """Persist the fitted word LM (vocabulary + counts) as an ``.npz``.

        The word list rides along the inner :class:`NGramLM`'s arrays
        (newline-joined — words come from ``str.split`` so contain no
        whitespace).
        """
        import io

        import numpy as np

        buf = io.BytesIO()
        self._lm.save(buf)
        buf.seek(0)
        inner = dict(np.load(buf))
        inner["words"] = np.asarray("\n".join(self.words))
        np.savez_compressed(path, **inner)

    @classmethod
    def load(cls, path) -> "WordNGramLM":
        """Restore a word LM saved with :meth:`save`."""
        import io

        import numpy as np

        from thunder_tpu_torch.text.lm import NGramLM

        data = np.load(path)
        lm = cls.__new__(cls)
        words_str = str(data["words"])
        lm.words = words_str.split("\n") if words_str else []
        lm.vocab = {w: i for i, w in enumerate(lm.words)}
        buf = io.BytesIO()
        np.savez(buf, **{k: data[k] for k in data.files if k != "words"})
        buf.seek(0)
        lm._lm = NGramLM.load(buf)
        return lm


class WordFusionLM:
    """Adapter fusing a word-level LM into the token-id prefix beam search.

    Args:
        word_lm: an :class:`~thunder_tpu_torch.text.lm.ArpaLM` or
            :class:`WordNGramLM` (anything with ``order``, ``word_id``,
            ``score_ids``, and optionally ``native``/``vocab``).  ``None``
            runs pure hotword-boost / word-score fusion with no LM.
        text_transform: the model's ``BatchTextTransformer`` — supplies the
            token vocabulary (id -> piece text) the beam emits.
        style: ``"char"`` or ``"sentencepiece"``; auto-detected from the
            vocabulary when ``None`` (any ``"▁"``-initial piece =>
            sentencepiece).
        bos: seed the word history with the LM's ``"<s>"`` entry when it has
            one (standard for ARPA files) so sentence-initial words use
            begin-of-sentence n-grams.
        word_score: flat bonus added per completed word — the classic
            insertion knob (negative penalizes many short words).
        hotwords: ``{word: boost}`` extra bonus when that exact word
            completes — contextual biasing for names/terms the LM undersells.

    Pass as ``lm=`` with a ``lm_weight`` to ``predict`` / ``beam_search_*``;
    all bonuses (LM, word_score, hotwords) share that single weight, so use
    ``lm_weight=1.0`` to treat them as absolute log-domain values.  OOV
    completed words score through the LM's ``<unk>``/floor path and enter
    the history as its unk id (or stay opaque when it has none).
    """

    def __init__(
        self,
        word_lm,
        text_transform,
        style: Optional[str] = None,
        bos: bool = True,
        word_score: float = 0.0,
        hotwords: Optional[Dict[str, float]] = None,
    ):
        self.word_lm = word_lm
        self.word_score = float(word_score)
        self.hotwords = dict(hotwords or {})
        vocab = text_transform.vocab
        specials = {
            vocab.blank_token,
            vocab.pad_token,
            vocab.unknown_token,
            vocab.start_token,
            vocab.end_token,
        }
        # token id -> text contribution ("" for special tokens)
        self.pieces: List[str] = [
            "" if tok in specials else tok for tok in vocab.itos
        ]
        if style is None:
            style = (
                "sentencepiece"
                if any(p.startswith(_SP_MARK) for p in self.pieces)
                else "char"
            )
        if style not in ("char", "sentencepiece"):
            raise ValueError(f"unknown style {style!r}")
        self.style = style
        self.space_id = -1
        if style == "char":
            for sep in (" ", "|"):
                if sep in vocab.stoi:
                    self.space_id = vocab.stoi[sep]
                    break
            if self.space_id < 0:
                raise ValueError("char-style fusion needs a ' ' or '|' separator token")
        bos_id = None
        if bos and word_lm is not None and getattr(word_lm, "vocab", None):
            bos_id = word_lm.vocab.get("<s>")
        self._init_hist: Tuple[int, ...] = (bos_id,) if bos_id is not None else ()
        # prefix -> (word-history ids, partial word); the beam re-queries the
        # same few live prefixes every frame, so memoize (bounded: cleared
        # when it outgrows the working set)
        self._memo: Dict[Tuple[int, ...], Tuple[Tuple[int, ...], str]] = {}

    # -- state -------------------------------------------------------------

    def _push_word(self, hist: Tuple[int, ...], word: str) -> Tuple[int, ...]:
        if self.word_lm is None:
            return hist
        wid = self.word_lm.word_id(word)
        hist = hist + (-1 if wid is None else wid,)
        keep = max(self.word_lm.order - 1, 0)
        return hist[-keep:] if keep else ()

    def _advance(
        self, hist: Tuple[int, ...], partial: str, token: int
    ) -> Tuple[Tuple[int, ...], str]:
        piece = self.pieces[token]
        if self.style == "char":
            if token == self.space_id:
                return (self._push_word(hist, partial), "") if partial else (hist, "")
            return hist, partial + piece
        if piece.startswith(_SP_MARK):
            if partial:
                hist = self._push_word(hist, partial)
            return hist, piece[len(_SP_MARK) :]
        return hist, partial + piece

    def state_of(self, prefix: Sequence[int]) -> Tuple[Tuple[int, ...], str]:
        """(word-history ids, partial word) after consuming ``prefix``."""
        prefix = tuple(int(t) for t in prefix)
        got = self._memo.get(prefix)
        if got is not None:
            return got
        # extend from the longest memoized ancestor (the beam grows prefixes
        # one token at a time, so this is O(1) amortized)
        hist, partial = self._init_hist, ""
        start = 0
        if prefix:
            parent = self._memo.get(prefix[:-1])
            if parent is not None:
                hist, partial = parent
                start = len(prefix) - 1
        for tok in prefix[start:]:
            hist, partial = self._advance(hist, partial, tok)
        # small cap: the beam only re-queries the current generation of
        # prefixes (~beam_width per frame); a large cap would pin every dead
        # prefix tuple of a long stream in memory.  After a clear, the
        # ancestor chain rebuilds each live prefix once (O(len)).
        if len(self._memo) > 4096:
            self._memo.clear()
        self._memo[prefix] = (hist, partial)
        return hist, partial

    # -- the beam hook -------------------------------------------------------

    def __call__(self, prefix: Sequence[int], token: int) -> float:
        hist, partial = self.state_of(prefix)
        token = int(token)
        if self.style == "char":
            completes = token == self.space_id and bool(partial)
        else:
            completes = self.pieces[token].startswith(_SP_MARK) and bool(partial)
        if not completes:
            return 0.0
        return self._word_bonus(hist, partial)

    def _word_bonus(self, hist: Tuple[int, ...], word: str) -> float:
        """Score of one completed word: insertion bonus + hotword + LM."""
        bonus = self.word_score + self.hotwords.get(word, 0.0)
        if self.word_lm is not None:
            bonus += self.word_lm.score_ids(hist, self.word_lm.word_id(word))
        return bonus

    def final_score(self, prefix: Sequence[int]) -> float:
        """Bonus for a COMPLETED utterance ending in a pending partial word.

        Fusion is boundary-driven, so without this the final word of every
        utterance (all of a single-word one) would never see the LM or a
        hotword boost.  The decode paths apply it when ranking final beams
        only — never to carried streaming state, where the partial may still
        grow (``flush``/full-utterance decode are the finalization points,
        keeping chunked == unchunked).
        """
        hist, partial = self.state_of(prefix)
        return self._word_bonus(hist, partial) if partial else 0.0

    # -- partial-word lookahead (streaming display ranking) -----------------

    def _lookahead_table(self):
        """Sorted completion table: ``(words, scores)`` built once, lazily.

        ``words`` is every candidate completion (LM vocabulary ∪ hotwords)
        sorted lexicographically; ``scores[i]`` is the context-free value of
        completing into ``words[i]``: its unigram log-prob (when an LM is
        present) plus its hotword boost.  A prefix query is then a bisect
        range + one vectorized max — O(log V + range) per live beam, host-side
        only.
        """
        table = getattr(self, "_lookahead", None)
        if table is None:
            import numpy as np

            cand: Dict[str, float] = {}
            if self.word_lm is not None:
                for w in getattr(self.word_lm, "words", []):
                    # context-free unigram: the best single-word estimate of
                    # the pending word's eventual LM score
                    cand[w] = self.word_lm.score_ids((), self.word_lm.word_id(w))
            for w, boost in self.hotwords.items():
                cand[w] = cand.get(w, 0.0) + boost
            words = sorted(cand)
            table = (words, np.asarray([cand[w] for w in words], np.float32))
            self._lookahead = table
        return table

    def partial_score(self, prefix: Sequence[int]) -> float:
        """Lookahead bonus for a prefix ending in an in-flight partial word.

        Streaming ``partial_text`` ranks live beams with this so the trailing
        word-in-progress carries LM/hotword evidence *before* its boundary
        token arrives (the pyctcdecode partial-word recipe): the bonus is the
        best completion's context-free unigram score plus its hotword boost,
        or the LM's unknown-word floor when nothing in the vocabulary starts
        with the partial.  Display-only — carried beam state and ``flush()``
        ranking (:meth:`final_score`) are untouched, so chunked == unchunked
        finalization still holds.
        """
        _, partial = self.state_of(prefix)
        if not partial:
            return 0.0
        import bisect

        words, scores = self._lookahead_table()
        lo = bisect.bisect_left(words, partial)
        hi = bisect.bisect_left(words, partial + "\uffff")
        bonus = self.word_score
        if hi > lo:
            return bonus + float(scores[lo:hi].max())
        if self.word_lm is not None:
            # no completion exists: the word can only resolve via the
            # unknown-word path, so penalize with the LM's floor now
            return bonus + self.word_lm.score_ids((), None)
        return bonus

    def native(self):
        """C++ fusion handle so the beam scores words natively.

        Requires the word LM's own native mirror; returns ``None`` (numpy
        fallback) when the native library is unavailable.  Rebuilt if the
        word LM was refit since the last call.
        """
        if self.word_lm is not None:
            wlm_native = self.word_lm.native() if hasattr(self.word_lm, "native") else None
            words = getattr(self.word_lm, "words", None)
            if wlm_native is None or words is None:
                return None
        else:
            wlm_native, words = None, []
        cached = getattr(self, "_native", None)
        if cached is not None and cached._word_lm is wlm_native:
            return cached
        from thunder_tpu_torch.native import NativeWordFusion, native_available

        if not native_available():
            return None
        bos_id = self._init_hist[0] if self._init_hist else -1
        unk_id = getattr(self.word_lm, "_unk_id", None)
        try:
            self._native = NativeWordFusion(
                wlm_native,
                self.style,
                self.space_id,
                bos_id,
                -1 if unk_id is None else unk_id,
                self.pieces,
                words,
                word_score=self.word_score,
                hotwords=self.hotwords,
            )
        except ValueError:
            return None
        return self._native
