"""N-gram language models for shallow-fusion beam decoding.

Two scorers, both dependency-free:

- :class:`NGramLM` — counts-based stupid backoff (Brants et al., 2007) over
  *token ids* (chars or sentencepiece pieces).  Pairs directly with
  :func:`thunder_tpu_torch.ops.ctc_beam.prefix_beam_search` via the ``lm=`` hook:
  each prefix extension is scored ``lm_weight * lm(prefix_ids, next_id)``.
- :class:`ArpaLM` — a Katz-backoff LM loaded from a standard ARPA file
  (the KenLM/SRILM interchange format), scoring over *words*; pair it with
  :class:`thunder_tpu_torch.text.word_fusion.WordFusionLM` to fuse at word
  boundaries of a CTC beam.

Port of ``thunder_tpu/text/lm.py``: the same scores, and :meth:`NGramLM.save`
writes the JAX package's ``.npz`` layout, so a file saved by either package
loads in the other. ``native()`` mirrors each LM into the port's C++ runtime
(:mod:`thunder_tpu_torch.native`), which fuses it inside the host beam.
"""

from __future__ import annotations

import gzip
import math
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["NGramLM", "ArpaLM"]


class NGramLM:
    """Stupid-backoff n-gram LM over integer token sequences.

    ``score(context, token)`` returns ``log P(token | context)`` using the
    longest matching context, multiplying by the backoff factor per level
    skipped.  Unseen unigrams get a floor of ``oov_logp`` (a log-probability).
    """

    def __init__(self, order: int = 4, backoff: float = 0.4, oov_logp: float = -12.0):
        if order < 1:
            raise ValueError("order must be >= 1")
        self.order = order
        self.backoff = backoff
        self.oov_logp = oov_logp
        # counts[n] maps an n-gram tuple to its count; context totals cached
        self._counts: Dict[int, Dict[Tuple[int, ...], int]] = {
            n: defaultdict(int) for n in range(1, order + 1)
        }
        self._context_totals: Dict[Tuple[int, ...], int] = defaultdict(int)
        self._total_unigrams = 0
        self._native = None  # lazily-built C++ mirror (see native())

    def fit(self, sequences: Iterable[Sequence[int]]) -> "NGramLM":
        self._native = None  # counts change: any built C++ mirror is stale
        for seq in sequences:
            seq = tuple(int(t) for t in seq)
            for i in range(len(seq)):
                for n in range(1, self.order + 1):
                    if i + n > len(seq):
                        break
                    self._counts[n][seq[i : i + n]] += 1
            self._total_unigrams += len(seq)
        # rebuild context totals from scratch so repeated fit() calls
        # (incremental corpora) don't double-count earlier batches
        self._context_totals = defaultdict(int)
        for n in range(2, self.order + 1):
            for gram, c in self._counts[n].items():
                self._context_totals[gram[:-1]] += c
        return self

    @classmethod
    def from_texts(cls, texts: Iterable[str], text_transform, order: int = 4, **kw) -> "NGramLM":
        """Fit from transcripts through a ``BatchTextTransformer`` vocabulary.

        Start/end/pad/blank ids are stripped: CTC beam prefixes never contain
        them, so training on them would leave sentence-initial n-grams
        reachable only through a BOS the scorer never sees.
        """
        import numpy as np

        vocab = text_transform.vocab
        drop = {vocab.blank_idx, vocab.pad_idx}
        for tok in (vocab.start_token, vocab.end_token):
            if tok is not None and tok in vocab.stoi:
                drop.add(vocab.stoi[tok])
        seqs = []
        for t in texts:
            ids, lens = text_transform.encode([t])
            seq = np.asarray(ids)[0, : int(np.asarray(lens)[0])].tolist()
            seqs.append([i for i in seq if i not in drop])
        return cls(order=order, **kw).fit(seqs)

    def score(self, context: Sequence[int], token: int) -> float:
        """log P(token | context) with stupid backoff."""
        ctx = tuple(int(t) for t in context)[-(self.order - 1) :] if self.order > 1 else ()
        penalty = 0.0
        while True:
            gram = ctx + (int(token),)
            c = self._counts[len(gram)].get(gram)
            if c:
                denom = self._context_totals[ctx] if ctx else self._total_unigrams
                return penalty + math.log(c / denom)
            if not ctx:
                return penalty + self.oov_logp
            ctx = ctx[1:]
            penalty += math.log(self.backoff)

    def __call__(self, context: Sequence[int], token: int) -> float:
        return self.score(context, token)

    def save(self, path) -> None:
        """Persist the fitted LM (counts + hyperparameters) as an ``.npz``.

        Grams pack into flat int32 arrays per order, so a multi-million-gram
        LM round-trips without Python-object overhead.
        """
        import numpy as np

        arrays = {
            "meta": np.asarray([self.order, self._total_unigrams], np.int64),
            "hyper": np.asarray([self.backoff, self.oov_logp], np.float64),
        }
        for n in range(1, self.order + 1):
            table = self._counts[n]
            arrays[f"grams{n}"] = np.asarray(list(table.keys()), np.int32).reshape(-1, n)
            arrays[f"counts{n}"] = np.asarray(list(table.values()), np.int64)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path) -> "NGramLM":
        """Restore an LM saved with :meth:`save`."""
        import numpy as np

        data = np.load(path)
        order, total = (int(x) for x in data["meta"])
        backoff, oov_logp = (float(x) for x in data["hyper"])
        lm = cls(order=order, backoff=backoff, oov_logp=oov_logp)
        for n in range(1, order + 1):
            for gram, c in zip(data[f"grams{n}"], data[f"counts{n}"]):
                lm._counts[n][tuple(int(t) for t in gram)] = int(c)
        for n in range(2, order + 1):
            for gram, c in lm._counts[n].items():
                lm._context_totals[gram[:-1]] += c
        lm._total_unigrams = total
        return lm

    def native(self):
        """C++ mirror of this LM for in-beam fusion (``None`` if unavailable).

        Built lazily from the count tables and cached; ``fit()`` invalidates
        it.  With a native mirror, :func:`ops.ctc_beam.beam_search_decode` /
        ``beam_search_stream`` fuse LM scores inside the C++ beam search
        (~20x the numpy path) instead of calling this object per extension.
        """
        if self._native is None:
            from thunder_tpu_torch.native import NativeNGramLM, native_available

            if not native_available():
                return None
            try:
                self._native = NativeNGramLM.from_counts(
                    self.order, self.backoff, self.oov_logp, self._counts
                )
            except ValueError:
                return None
        return self._native


class ArpaLM:
    """Katz-backoff n-gram LM read from an ARPA file (KenLM/SRILM format).

    Scores *words* (whatever unit the ARPA file was trained on): standard
    backoff — explicit ``log P`` when the n-gram is listed, else the
    context's backoff weight plus the lower-order score, bottoming out at
    ``<unk>``'s unigram (when present) or ``unk_logp``.  All values are
    converted to natural log at load so they combine directly with the
    beam's acoustic log-probs.

    Interoperability entry point: train with KenLM (``lmplz``) on your
    corpus, load the ``.arpa``/``.arpa.gz`` here, wrap in
    :class:`~thunder_tpu_torch.text.word_fusion.WordFusionLM` for decoding.
    """

    LOG10 = math.log(10.0)

    def __init__(self, order: int, unk_logp: float = -20.0):
        if order < 1:
            raise ValueError("order must be >= 1")
        self.order = order
        self.unk_logp = unk_logp  # natural-log floor when no <unk> entry exists
        self.vocab: Dict[str, int] = {}  # word -> id (unigram order)
        self.words: List[str] = []
        # per gram length: id-tuple -> (ln P, ln backoff-weight)
        self._tables: Dict[int, Dict[Tuple[int, ...], Tuple[float, float]]] = {
            n: {} for n in range(1, order + 1)
        }
        self._unk_id: Optional[int] = None
        self._native = None

    # -- construction ----------------------------------------------------

    def _intern(self, word: str) -> int:
        wid = self.vocab.get(word)
        if wid is None:
            wid = len(self.words)
            self.vocab[word] = wid
            self.words.append(word)
        return wid

    @classmethod
    def load(cls, path, unk_logp: float = -20.0) -> "ArpaLM":
        """Parse an ARPA file (plain text or ``.gz``)."""
        path = Path(path)
        opener = gzip.open if path.suffix == ".gz" else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = iter(f)
            # header: \data\ then "ngram N=count" lines fix the order
            order = 0
            for line in lines:
                line = line.strip()
                if line.startswith("ngram "):
                    order = max(order, int(line[6:].split("=")[0]))
                elif line.endswith("-grams:"):
                    break
                elif line == "\\end\\":
                    raise ValueError(f"{path}: no n-gram sections found")
            if order < 1:
                raise ValueError(f"{path}: missing \\data\\ ngram declarations")
            lm = cls(order, unk_logp=unk_logp)
            n = 1  # the section header consumed above is "\1-grams:"
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                if line == "\\end\\":
                    break
                if line.endswith("-grams:"):
                    n = int(line[1:].split("-")[0])
                    continue
                parts = line.split()
                # "logp w1 ... wn [backoff]" — both values in log10
                has_bow = len(parts) == n + 2
                if not has_bow and len(parts) != n + 1:
                    raise ValueError(f"{path}: malformed {n}-gram line: {line!r}")
                logp = float(parts[0]) * cls.LOG10
                bow = float(parts[-1]) * cls.LOG10 if has_bow else 0.0
                gram = tuple(lm._intern(w) for w in parts[1 : n + 1])
                lm._tables[n][gram] = (logp, bow)
        lm._unk_id = lm.vocab.get("<unk>")
        return lm

    # -- scoring -----------------------------------------------------------

    def word_id(self, word: str) -> Optional[int]:
        """Vocab id of ``word``; the ``<unk>`` id (or ``None``) when absent."""
        return self.vocab.get(word, self._unk_id)

    def score_ids(self, context: Sequence[int], token: Optional[int]) -> float:
        """ln P(token | context) over vocab ids (Katz backoff).

        ``token=None`` (a word with no vocab/``<unk>`` id) walks the backoff
        chain to the ``unk_logp`` floor.
        """
        ctx = tuple(int(t) for t in context)[-(self.order - 1) :] if self.order > 1 else ()
        tok = -1 if token is None else int(token)
        penalty = 0.0
        while True:
            gram = ctx + (tok,)
            ent = self._tables[len(gram)].get(gram) if tok >= 0 else None
            if ent is not None:
                return penalty + ent[0]
            if not ctx:
                if tok != self._unk_id and self._unk_id is not None:
                    unk = self._tables[1].get((self._unk_id,))
                    if unk is not None:
                        return penalty + unk[0]
                return penalty + self.unk_logp
            bow = self._tables[len(ctx)].get(ctx)
            if bow is not None:
                penalty += bow[1]
            ctx = ctx[1:]

    def score(self, context: Sequence[str], word: str) -> float:
        """ln P(word | context) over word strings."""
        ctx_ids = [i for i in (self.vocab.get(w, self._unk_id) for w in context) if i is not None]
        return self.score_ids(ctx_ids, self.vocab.get(word, self._unk_id))

    def native(self):
        """C++ mirror of this LM for in-beam fusion (``None`` if unavailable)."""
        if self._native is None:
            from thunder_tpu_torch.native import NativeNGramLM, native_available

            if not native_available():
                return None
            try:
                self._native = NativeNGramLM.from_arpa_tables(
                    self.order,
                    self.unk_logp,
                    -1 if self._unk_id is None else self._unk_id,
                    self._tables,
                )
            except ValueError:
                return None
        return self._native
