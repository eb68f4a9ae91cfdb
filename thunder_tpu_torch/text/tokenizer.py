"""Tokenizers: char, word, subword (sentencepiece-compatible) + trainer.

Port of ``thunder_tpu/text/tokenizer.py``, with the port's own
sentencepiece-compatible engine (:mod:`thunder_tpu_torch.text.sentencepiece_model`):

- ``BPETokenizer(model_path)`` loads a sentencepiece ``.model`` (NeMo
  Citrinet checkpoints' included) and segments text into pieces;
- ``train_sentencepiece_model`` trains a subword model and writes
  ``tokenizer.model`` / ``tokenizer.vocab`` in sentencepiece's formats.
  ``tokenizer_type="unigram"`` runs the sentencepiece algorithm: substring
  seeding, full forward-backward EM (lattice expected counts, Bayesian
  digamma M-step) and likelihood-loss pruning; ``tokenizer_type="bpe"`` runs
  classic merge training. Both are deterministic: the same text gives the
  same ``tokenizer.model`` bytes as the JAX package's trainer;
- ``word_tokenizer`` / ``char_tokenizer`` / ``get_most_frequent_tokens``.
"""

from __future__ import annotations

import math
from collections import Counter
from pathlib import Path
from typing import Callable, List, Optional
from warnings import warn

from thunder_tpu_torch.text.sentencepiece_model import (
    BPE,
    CONTROL,
    NORMAL,
    UNIGRAM,
    UNKNOWN,
    WORD_BOUNDARY,
    SentencePieceModel,
)

__all__ = [
    "BPETokenizer",
    "train_sentencepiece_model",
    "word_tokenizer",
    "char_tokenizer",
    "get_most_frequent_tokens",
]


class BPETokenizer:
    """Callable wrapper: text -> subword pieces, from a ``.model`` file."""

    def __init__(self, model_path: str):
        self.model = SentencePieceModel.load(str(model_path))

    def __call__(self, text: str) -> List[str]:
        return self.model.encode_as_pieces(text)


def word_tokenizer(text: str) -> List[str]:
    """Whitespace word split."""
    return text.split()


def char_tokenizer(text: str) -> List[str]:
    """Character split."""
    return list(text)


def get_most_frequent_tokens(
    corpus: str,
    tokenize_function: Callable[[str], List[str]],
    minimum_frequency: int = 1,
    max_number_of_tokens: Optional[int] = None,
) -> List[str]:
    """Unique tokens of a corpus ordered by frequency (>= minimum_frequency)."""
    counts = Counter(tokenize_function(corpus))
    out = []
    for token, count in counts.most_common(max_number_of_tokens):
        if count >= minimum_frequency:
            out.append(token)
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _viterbi_segment(word: str, scores: dict, max_len: int, exclude: Optional[str] = None) -> List[str]:
    """Best segmentation of ``word`` under piece log-probs (chars always exist).

    ``exclude`` drops one piece from consideration — used by the pruning pass
    to find each piece's best *alternative* segmentation into other pieces.
    """
    n = len(word)
    NEG = -1e18
    best = [NEG] * (n + 1)
    back = [0] * (n + 1)
    piece_at = [""] * (n + 1)
    best[0] = 0.0
    for i in range(n):
        if best[i] <= NEG / 2:
            continue
        hi = min(n, i + max_len)
        for j in range(i + 1, hi + 1):
            sub = word[i:j]
            s = scores.get(sub) if sub != exclude else None
            if s is None:
                if j == i + 1:
                    s = -20.0  # unseen char fallback
                else:
                    continue
            if best[i] + s > best[j]:
                best[j] = best[i] + s
                back[j] = i
                piece_at[j] = sub
    out = []
    j = n
    while j > 0:
        out.append(piece_at[j])
        j = back[j]
    out.reverse()
    return out


def _logsumexp(vals: List[float]) -> float:
    m = max(vals)
    if m <= -1e17:
        return -1e18
    return m + math.log(sum(math.exp(v - m) for v in vals))


_CHAR_FALLBACK = -20.0  # unseen single character


def _lattice_expectations(word: str, freq: float, scores: dict, max_len: int, counts: Counter):
    """Forward-backward over the segmentation lattice of one word.

    Accumulates ``freq``-weighted expected piece counts into ``counts`` and
    returns the word's marginal log-likelihood contribution ``freq * log Z``.
    """
    n = len(word)
    NEG = -1e18
    alpha = [NEG] * (n + 1)
    alpha[0] = 0.0
    for j in range(1, n + 1):
        acc = []
        for i in range(max(0, j - max_len), j):
            s = scores.get(word[i:j])
            if s is None:
                if j - i == 1:
                    s = _CHAR_FALLBACK
                else:
                    continue
            if alpha[i] > NEG / 2:
                acc.append(alpha[i] + s)
        if acc:
            alpha[j] = _logsumexp(acc)
    z = alpha[n]
    if z <= NEG / 2:
        return 0.0
    beta = [NEG] * (n + 1)
    beta[n] = 0.0
    for i in range(n - 1, -1, -1):
        acc = []
        for j in range(i + 1, min(n, i + max_len) + 1):
            s = scores.get(word[i:j])
            if s is None:
                if j - i == 1:
                    s = _CHAR_FALLBACK
                else:
                    continue
            if beta[j] > NEG / 2:
                acc.append(s + beta[j])
        if acc:
            beta[i] = _logsumexp(acc)
    for i in range(n):
        if alpha[i] <= NEG / 2:
            continue
        for j in range(i + 1, min(n, i + max_len) + 1):
            piece = word[i:j]
            s = scores.get(piece)
            if s is None:
                if j - i == 1:
                    s = _CHAR_FALLBACK
                else:
                    continue
            if beta[j] <= NEG / 2:
                continue
            gamma = math.exp(alpha[i] + s + beta[j] - z)
            if gamma > 1e-12:
                counts[piece] += freq * gamma
    return freq * z


def _digamma(x: float) -> float:
    """Digamma via the standard shift + asymptotic series (sentencepiece's
    Bayesian M-step uses exp(digamma(c) - digamma(sum)))."""
    r = 0.0
    while x < 7.0:
        r -= 1.0 / x
        x += 1.0
    x -= 0.5
    xx = 1.0 / x
    xx2 = xx * xx
    xx4 = xx2 * xx2
    return r + math.log(x) + (1.0 / 24.0) * xx2 - (7.0 / 960.0) * xx4 + (31.0 / 8064.0) * xx4 * xx2


def _likelihood_loss_rank(counts: Counter, scores: dict, max_len: int) -> dict:
    """Corpus-likelihood loss of removing each multi-char piece — the pruning
    rank of sentencepiece's ``PruneSentencePieces`` (unigram_model_trainer.cc):

    When piece ``p`` (expected count ``freq``) is removed, each of its
    occurrences re-segments into its best alternative pieces, whose counts
    grow by ``freq``; the loss is the piece's corpus-frequency share times the
    log-likelihood drop of that substitution::

        loss(p) = (freq/total) * [ (log freq - log total)
                    - sum_a (log(count_a + freq) - log(total + freq*(n_alt-1))) ]

    Larger loss = more valuable piece.  Pieces whose string cannot re-segment
    get ``inf`` (always kept), mirroring sentencepiece's always_keep.
    """
    vsum = float(sum(counts.values())) or 1.0
    logsum = math.log(vsum)
    losses = {}
    for p, freq in counts.items():
        if len(p) <= 1:
            continue
        alts = _viterbi_segment(p, scores, max_len, exclude=p)
        if not alts:
            losses[p] = float("inf")
            continue
        F = freq / vsum
        logprob_sp = math.log(freq) - logsum
        logsum_alt = math.log(vsum + freq * (len(alts) - 1))
        logprob_alt = sum(math.log(counts.get(a, 0.0) + freq) - logsum_alt for a in alts)
        losses[p] = F * (logprob_sp - logprob_alt)
    return losses


def _unigram_train(word_freqs: Counter, target_size: int, max_piece_len: int = 8, em_iters: int = 4, prune: str = "loss"):
    """Unigram LM training with full forward-backward EM (the sentencepiece
    algorithm): substring-seeded vocabulary, lattice expected counts in the
    E-step, Bayesian digamma M-step, and usefulness pruning between EM
    rounds.  (The classic EM monotonicity guarantee holds for the plain-ML
    M-step over a fixed vocabulary — pinned by tests against the lattice
    expectations; the shipped digamma update optimizes the Bayesianified
    objective and re-prunes between rounds, like sentencepiece's trainer.)

    ``prune`` selects the between-round pruning rank: ``"loss"`` (default) is
    sentencepiece's likelihood-loss ranking (:func:`_likelihood_loss_rank`);
    ``"count"`` is the simpler expected-count × length heuristic (kept for
    comparison tests).

    Returns ``(pieces, scores)`` sorted by descending score, single
    characters always retained.
    """
    # seed vocabulary: all substrings up to max_piece_len, by total count
    seed: Counter = Counter()
    chars = set()
    for word, freq in word_freqs.items():
        chars.update(word)
        n = len(word)
        for i in range(n):
            for j in range(i + 1, min(n, i + max_piece_len) + 1):
                seed[word[i:j]] += freq
    seed_size = max(target_size * 8, 1000)
    pieces = {p for p, _ in seed.most_common(seed_size)} | chars
    total = sum(seed.values()) or 1
    scores = {p: math.log(seed[p] / total) for p in pieces}

    for it in range(em_iters):
        # E: expected piece counts over every word's segmentation lattice
        counts: Counter = Counter()
        for word, freq in word_freqs.items():
            _lattice_expectations(word, freq, scores, max_piece_len, counts)
        # M: Bayesianified maximum likelihood (digamma smoothing)
        total = sum(counts.values()) or 1.0
        dg_total = _digamma(total)
        # prune between rounds: keep the most useful pieces, chars survive
        used = [p for p in counts if len(p) > 1]
        if prune == "loss":
            losses = _likelihood_loss_rank(counts, scores, max_piece_len)
            # sentencepiece's Sorted(): descending loss, ties broken by the
            # piece string ascending (util.h Sorted — pair falls through to
            # first<), so equal-loss pieces keep the C++ trainer's order
            used.sort()
            used.sort(key=lambda p: losses.get(p, float("inf")), reverse=True)
        else:
            used.sort(key=lambda p: counts[p] * len(p), reverse=True)
        keep_multi = used[: max(target_size - len(chars), 0)]
        pieces = set(keep_multi) | chars
        scores = {
            p: (_digamma(counts[p]) - dg_total) if counts.get(p, 0.0) > 1e-6 else math.log(0.5 / total)
            for p in pieces
        }

    # final piece order: score descending, ties lexicographic ascending
    # (sentencepiece's Sorted() again)
    ordered = sorted(sorted(pieces), key=lambda p: scores[p], reverse=True)[:target_size]
    # chars must survive the final cut for full coverage
    for ch in chars:
        if ch not in ordered:
            ordered.append(ch)
    return ordered, [scores[p] for p in ordered]


def _bpe_train(word_freqs: Counter, num_merges: int) -> List[str]:
    """Classic BPE: returns merged symbols in merge order."""
    # each word is a tuple of symbols
    words = {tuple(w): f for w, f in word_freqs.items()}
    merges: List[str] = []
    for _ in range(num_merges):
        pair_counts: Counter = Counter()
        for syms, f in words.items():
            for a, b in zip(syms, syms[1:]):
                pair_counts[(a, b)] += f
        if not pair_counts:
            break
        (a, b), cnt = pair_counts.most_common(1)[0]
        if cnt < 2:
            break
        merged = a + b
        merges.append(merged)
        new_words = {}
        for syms, f in words.items():
            out = []
            i = 0
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + f
        words = new_words
    return merges


def train_sentencepiece_model(
    data_file: str,
    vocab_size: int,
    output_dir: str,
    sample_size: int = -1,
    do_lower_case: bool = True,
    tokenizer_type: str = "unigram",
    character_coverage: float = 1.0,
    train_extremely_large_corpus: bool = False,
    max_sentencepiece_length: int = -1,
) -> str:
    """Train a subword model; writes ``tokenizer.model`` + ``tokenizer.vocab``.

    Skips with a warning when a model already exists in ``output_dir``;
    returns ``output_dir``.
    """
    data_file = Path(data_file)
    if not data_file.exists():
        raise ValueError(f"data_file must be valid file path, but got {data_file}")

    output_dir = Path(output_dir)
    if (output_dir / "tokenizer.model").exists():
        warn("There's already a trained sentencepiece model at the output directory. Skipping train.")
        return str(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    sentences = data_file.read_text(encoding="utf-8").splitlines()
    if sample_size > 0:
        sentences = sentences[:sample_size]

    normalizer = "nmt_nfkc_cf" if do_lower_case else "nmt_nfkc"
    proto = SentencePieceModel(normalizer_name=normalizer)

    word_freqs: Counter = Counter()
    char_freqs: Counter = Counter()
    for line in sentences:
        line = proto.normalize(line.strip())
        if not line:
            continue
        # normalize() maps spaces to the word boundary marker; split on it
        for w in line.split(WORD_BOUNDARY):
            if w:
                word_freqs[WORD_BOUNDARY + w] += 1
        for ch in line:
            char_freqs[ch] += 1

    # character coverage: drop rarest chars until coverage met
    chars = char_freqs.most_common()
    total = sum(c for _, c in chars) or 1
    kept_chars: List[str] = []
    covered = 0
    for ch, c in chars:
        if covered / total >= character_coverage and character_coverage < 1.0:
            break
        kept_chars.append(ch)
        covered += c

    specials = ["<unk>", "<s>", "</s>"]
    budget = max(vocab_size - len(specials), 0)

    if tokenizer_type == "bpe":
        char_budget = max(budget - len(kept_chars), 0)
        if max_sentencepiece_length == 0:
            merges = []
        else:
            merges = _bpe_train(word_freqs, char_budget)
            if max_sentencepiece_length > 0:
                merges = [m for m in merges if len(m) <= max_sentencepiece_length]
        merges = merges[:char_budget]
        pieces = specials + merges + kept_chars
        # score = -merge_rank; single chars after merges
        scores = [0.0, 0.0, 0.0] + [-float(i) for i in range(len(merges))]
        scores += [-float(len(merges) + i) for i in range(len(kept_chars))]
        model_type = BPE
    else:
        # forward-backward EM unigram training
        max_len = max_sentencepiece_length if max_sentencepiece_length > 0 else 8
        body, body_scores = _unigram_train(word_freqs, budget, max_piece_len=max_len)
        # restrict to the coverage-kept character set
        keep = set(kept_chars)
        filtered = [(p, s) for p, s in zip(body, body_scores) if len(p) > 1 or p in keep]
        pieces = specials + [p for p, _ in filtered]
        scores = [0.0, 0.0, 0.0] + [s for _, s in filtered]
        model_type = UNIGRAM

    types = [UNKNOWN, CONTROL, CONTROL] + [NORMAL] * (len(pieces) - 3)

    proto.pieces, proto.scores, proto.types = pieces, scores, types
    proto.model_type = model_type
    proto.unk_id = 0
    proto._reindex()
    proto.save(str(output_dir / "tokenizer.model"))

    with open(output_dir / "tokenizer.vocab", "w", encoding="utf-8") as f:
        for p, s in zip(pieces, scores):
            f.write(f"{p}\t{s:g}\n")

    return str(output_dir)
