"""The port's CTC forced alignment against the JAX package's (CPU, float32).

- ``ctc_forced_align``: the best path of a brute-force enumeration (score within 1e-4, as the JAX package's
  own test); against the JAX function on the same float32 log-probs, states and labels equal and scores within
  1e-5, on ragged batches, repeated tokens, zero-length targets, a target too long for its frames (``-inf``)
  and a uniform input that ties everywhere (the first-maximum rule: stay, then one back, then two);
- ``torch.argmax`` over the stacked ``(3, B, S)`` choices takes the first maximum, as ``jnp.argmax`` does;
- ``alignment_segments`` equal to the JAX function's;
- ``CTCModule.align`` on the repo's char (QuartzNet) and sentencepiece (Citrinet) fixtures against the JAX
  module's: the same tokens, seconds within 1e-6, ``-inf`` scores alike; ``word_spans``, SRT and VTT
  documents equal to the JAX package's.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu.registry as jax_registry
from thunder_tpu.ops.ctc import alignment_segments as jax_segments
from thunder_tpu.ops.ctc import ctc_forced_align as jax_align
from thunder_tpu.text import subtitles as jax_subtitles
from thunder_tpu_torch import registry
from thunder_tpu_torch.ops.ctc import alignment_segments, ctc_forced_align
from thunder_tpu_torch.text import subtitles

FIXTURES = Path(__file__).parent / "fixtures"
SCORE_ATOL = 1e-5  # the two packages' float32 adds agree to rounding


def _log_probs(rng, b, t, v, scale=2.0):
    logits = rng.standard_normal((b, t, v)).astype(np.float32) * scale
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def _both(logp, lengths, targets, target_lengths, blank):
    want = jax_align(jnp.asarray(logp), jnp.asarray(lengths), jnp.asarray(targets), jnp.asarray(target_lengths), blank)
    got = ctc_forced_align(torch.as_tensor(logp), torch.as_tensor(np.asarray(lengths)),
                           torch.as_tensor(np.asarray(targets)), torch.as_tensor(np.asarray(target_lengths)), blank)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_same(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    np.testing.assert_array_equal(np.isinf(got[2]), np.isinf(want[2]))
    finite = np.isfinite(want[2])
    np.testing.assert_allclose(got[2][finite], want[2][finite], atol=SCORE_ATOL, rtol=0)


def brute_force(logp, target, blank):
    """Best (score, path) over all valid extended-state CTC paths (``tests/test_forced_align.py``)."""
    T, _ = logp.shape
    L = len(target)
    S = 2 * L + 1
    z = [blank] * S
    z[1::2] = target
    best = (-np.inf, None)

    def ok_next(s, s2):
        if s2 in (s, s + 1):
            return True
        return s2 == s + 2 and s2 % 2 == 1 and z[s2] != z[s2 - 2]

    stack = [((0,), logp[0, z[0]])] + ([((1,), logp[0, z[1]])] if L else [])
    while stack:
        path, score = stack.pop()
        if len(path) == T:
            done = path[-1] in (S - 1, S - 2) if L else path[-1] == 0
            if done and score > best[0]:
                best = (score, path)
            continue
        for s2 in (path[-1], path[-1] + 1, path[-1] + 2):
            if s2 < S and ok_next(path[-1], s2):
                stack.append((path + (s2,), score + logp[len(path), z[s2]]))
    return best


def test_forced_align_matches_brute_force():
    rng = np.random.default_rng(0)
    V, blank = 5, 4
    for _ in range(25):
        T = int(rng.integers(3, 8))
        L = int(rng.integers(0, min(3, T // 2) + 1))
        target = rng.integers(0, blank, size=L).tolist()
        logp = _log_probs(rng, 1, T, V)[0]
        want_score, want_path = brute_force(logp, target, blank)
        tgt = np.zeros((1, max(L, 1)), np.int32)
        tgt[0, :L] = target
        states, labels, scores = ctc_forced_align(torch.as_tensor(logp)[None], torch.tensor([T]), torch.as_tensor(tgt),
                                                  torch.tensor([L]), blank)
        if want_path is None:
            assert float(scores[0]) == -np.inf
            continue
        assert float(scores[0]) == pytest.approx(want_score, abs=1e-4)
        z = [blank] * (2 * L + 1)
        z[1::2] = target
        path = states[0, :T].tolist()
        assert sum(logp[t, z[s]] for t, s in enumerate(path)) == pytest.approx(want_score, abs=1e-4)
        np.testing.assert_array_equal(labels[0, :T].numpy(), [z[s] for s in path])


@pytest.mark.parametrize("seed", range(4))
def test_forced_align_matches_jax_on_ragged_batches(seed):
    rng = np.random.default_rng(seed)
    B, T, V, blank = 6, 40, 7, 6
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    lengths[0] = T
    target_lengths = np.minimum(rng.integers(0, 12, B), lengths // 2).astype(np.int32)
    targets = rng.integers(0, blank, (B, int(target_lengths.max()) or 1)).astype(np.int32)
    want, got = _both(_log_probs(rng, B, T, V), lengths, targets, target_lengths, blank)
    _assert_same(want, got)
    for b in range(B):  # frames past a row's length repeat its end state
        np.testing.assert_array_equal(got[0][b, lengths[b]:], got[0][b, lengths[b] - 1])


def test_forced_align_repeated_tokens_zero_length_and_too_long():
    rng = np.random.default_rng(5)
    blank = 3
    targets = np.array([[0, 0, 0, 1], [2, 2, 0, 0], [0, 0, 0, 0], [1, 1, 1, 1]], np.int32)
    target_lengths = np.array([4, 2, 0, 4], np.int32)
    lengths = np.array([12, 12, 5, 6], np.int32)  # row 3: "1111" needs 7 frames, has 6
    want, got = _both(_log_probs(rng, 4, 12, 4), lengths, targets, target_lengths, blank)
    _assert_same(want, got)
    assert np.isneginf(got[2][3]) and np.isfinite(got[2][:3]).all()
    assert (got[0][2, :5] == 0).all()  # a zero-length target aligns to the blank state


def test_forced_align_ties_everywhere_take_the_first_choice():
    # uniform log-probs: every frame's three choices tie wherever they are reachable
    blank = 4
    logp = np.full((3, 16, 5), -np.log(5.0), np.float32)
    targets = np.array([[0, 1, 2], [1, 1, 0], [3, 0, 0]], np.int32)
    target_lengths = np.array([3, 2, 1], np.int32)
    lengths = np.array([16, 11, 3], np.int32)
    want, got = _both(logp, lengths, targets, target_lengths, blank)
    _assert_same(want, got)


def test_argmax_takes_the_first_maximum_of_the_stacked_choices():
    rng = np.random.default_rng(0)
    stacked = rng.integers(0, 2, (3, 64, 241)).astype(np.float32)  # about a third of the entries tie
    want = np.asarray(jnp.argmax(jnp.asarray(stacked), axis=0))
    np.testing.assert_array_equal(torch.argmax(torch.as_tensor(stacked), dim=0).numpy(), want)
    np.testing.assert_array_equal(want, np.argmax(stacked, axis=0))


def test_alignment_segments_match_jax():
    rng = np.random.default_rng(3)
    B, T, V, blank = 4, 30, 5, 4
    lengths = np.array([30, 22, 9, 30], np.int32)
    target_lengths = np.array([6, 4, 0, 9], np.int32)
    targets = rng.integers(0, blank, (B, 9)).astype(np.int32)
    targets[0, :4] = [1, 1, 1, 2]
    want, got = _both(_log_probs(rng, B, T, V), lengths, targets, target_lengths, blank)
    assert alignment_segments(got[0], lengths, target_lengths) == jax_segments(want[0], lengths, target_lengths)
    # a tensor of states gives the same spans
    assert alignment_segments(torch.as_tensor(got[0]), lengths, target_lengths) == jax_segments(want[0], lengths,
                                                                                                 target_lengths)


@pytest.fixture(scope="module", params=["quartznet", "citrinet"])
def fixture_pair(request):
    path = str(FIXTURES / f"tiny_{request.param}.nemo")
    return request.param, registry.load_pretrained(path, device="cpu"), jax_registry.load_pretrained(path)


TEXTS = {"quartznet": ["the cat", "a dog's bone"], "citrinet": ["the quick brown fox", "hello world"]}


def test_module_align_matches_jax(fixture_pair):
    family, port, jax_module = fixture_pair
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((2, 16000)) * 0.3).astype(np.float32)
    lengths = np.array([16000, 11000], np.int32)
    want_spans, want_scores = jax_module.align(audio, TEXTS[family], lengths)
    spans, scores = port.align(audio, TEXTS[family], lengths)
    assert isinstance(scores, np.ndarray) and scores.shape == (2,)
    np.testing.assert_allclose(scores, np.asarray(want_scores), atol=1e-3, rtol=1e-5)  # logits within 2e-3
    for got_row, want_row in zip(spans, want_spans):
        assert [tok for tok, _, _ in got_row] == [tok for tok, _, _ in want_row]
        np.testing.assert_allclose([(s, e) for _, s, e in got_row], [(s, e) for _, s, e in want_row], atol=1e-6)
    # the subtitle helpers render the same documents from the port's spans
    for got_row, want_row in zip(spans, want_spans):
        assert subtitles.word_spans(got_row) == jax_subtitles.word_spans(want_row)
        assert subtitles.to_srt(got_row) == jax_subtitles.to_srt(want_row)
        assert subtitles.to_vtt(got_row) == jax_subtitles.to_vtt(want_row)


def test_module_align_one_clip_and_a_text_too_long(fixture_pair):
    family, port, jax_module = fixture_pair
    clip = (np.random.default_rng(1).standard_normal(4000) * 0.3).astype(np.float32)  # 0.25 s: 13 frames
    text = "zqxj" * 10  # 40 tokens in both vocabularies (sentencepiece has no piece for these pairs)
    want_spans, want_scores = jax_module.align(clip, [text])
    spans, scores = port.align(clip, [text])
    assert np.isneginf(scores[0]) and np.isneginf(np.asarray(want_scores)[0])
    assert [tok for tok, _, _ in spans[0]] == [tok for tok, _, _ in want_spans[0]]
