"""The port's language models and LM-fused host beam against the JAX package's (CPU).

- ``NGramLM``, ``ArpaLM`` (plain and gzip), ``WordNGramLM`` and ``WordFusionLM`` (char and sentencepiece style,
  hotwords, ``word_score``, no word LM): scores ``==`` their JAX twins', ``partial_score`` and ``final_score``
  too; ``save`` files load across the packages both ways;
- each LM's ``native()`` mirror exists here (g++ is present) and scores as the Python LM does;
- ``beam_search_decode``, ``beam_search_nbest`` and ``beam_search_stream`` with each LM: the C++ beam
  (``use_native=True``, the default) token-equal to the port's numpy search and to the JAX package's default;
- ``CTCModule.predict`` and ``InferenceEngine.predict`` on the host backend with each LM against the JAX module
  with the same weights (through ``bridge.py``): the same texts.
"""

import gzip
import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from thunder_tpu.engine import InferenceEngine as JaxEngine
from thunder_tpu.ops import ctc_beam as jax_host
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.text.lm import ArpaLM as JaxArpaLM
from thunder_tpu.text.lm import NGramLM as JaxNGramLM
from thunder_tpu.text.word_fusion import WordFusionLM as JaxWordFusionLM
from thunder_tpu.text.word_fusion import WordNGramLM as JaxWordNGramLM
from tests.test_torch_beam import TOKENS, pair  # noqa: F401 - the tiny QuartzNet pair, JAX and port
from thunder_tpu_torch.engine import InferenceEngine
from thunder_tpu_torch.native import native_available
from thunder_tpu_torch.ops import ctc_beam as host
from thunder_tpu_torch.text import ArpaLM, BatchTextTransformer, NGramLM, WordFusionLM, WordNGramLM

ARPA = """\\data\\
ngram 1=6
ngram 2=4
ngram 3=2

\\1-grams:
-1.0 <s> -0.30103
-0.7 ab -0.2
-0.9 cab -0.15
-1.2 ba
-1.3 ▁x
-2.0 <unk>

\\2-grams:
-0.3 <s> ab -0.1
-0.5 ab cab -0.05
-0.8 cab ba
-1.1 ba ab

\\3-grams:
-0.2 <s> ab cab
-0.6 ab cab ba

\\end\\
"""
TEXTS = ["ab cab ba", "cab ab", "ba ba cab ab", "c ab", "abc cab"]


@pytest.fixture(scope="module", autouse=True)
def built():
    if shutil.which("g++") is not None:
        assert native_available(), "g++ is present but the native runtime did not build"


def _corpus(seed, n=50, v=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, v, rng.integers(1, 14)).tolist() for _ in range(n)]


def _queries(seed, n, v, max_ctx):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, v, rng.integers(0, max_ctx + 1)).tolist(), int(rng.integers(0, v + 1))) for _ in range(n)]


# ---- the scorers


@pytest.mark.parametrize("order", [1, 2, 4])
def test_ngram_scores_match_jax(order):
    seqs = _corpus(order)
    port = NGramLM(order=order, backoff=0.3).fit(seqs[:30]).fit(seqs[30:])
    jax = JaxNGramLM(order=order, backoff=0.3).fit(seqs[:30]).fit(seqs[30:])
    mirror = port.native()
    assert mirror is not None
    for ctx, tok in _queries(order, 300, 4, 5):
        assert port.score(ctx, tok) == jax.score(ctx, tok) == port(ctx, tok)
        assert mirror.score(ctx, tok) == pytest.approx(port.score(ctx, tok), abs=1e-12)
    port.fit([[1, 2, 3]])
    assert port.native() is not mirror  # a refit drops the stale mirror


def test_ngram_from_texts_matches_jax():
    port = NGramLM.from_texts(TEXTS, BatchTextTransformer(TOKENS), order=3)
    jax = JaxNGramLM.from_texts(TEXTS, JaxText(tokens=TOKENS), order=3)
    assert port._counts == jax._counts and port._total_unigrams == jax._total_unigrams
    for ctx, tok in _queries(1, 100, 5, 3):
        assert port.score(ctx, tok) == jax.score(ctx, tok)


def test_ngram_files_load_across_packages(tmp_path):
    seqs = _corpus(7)
    port, jax = NGramLM(order=3, oov_logp=-9.0).fit(seqs), JaxNGramLM(order=3, oov_logp=-9.0).fit(seqs)
    port.save(tmp_path / "port.npz")
    jax.save(tmp_path / "jax.npz")
    from_port, from_jax = JaxNGramLM.load(tmp_path / "port.npz"), NGramLM.load(tmp_path / "jax.npz")
    assert from_port._counts == jax._counts and from_jax._counts == port._counts
    for ctx, tok in _queries(2, 200, 4, 3):
        assert from_port.score(ctx, tok) == from_jax.score(ctx, tok) == port.score(ctx, tok)


@pytest.mark.parametrize("compressed", [False, True], ids=["arpa", "arpa_gz"])
def test_arpa_scores_match_jax(tmp_path, compressed):
    path = tmp_path / ("lm.arpa.gz" if compressed else "lm.arpa")
    if compressed:
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write(ARPA)
    else:
        path.write_text(ARPA)
    port, jax = ArpaLM.load(path), JaxArpaLM.load(path)
    assert (port.order, port.vocab, port._unk_id) == (jax.order, jax.vocab, jax._unk_id)
    words = list(port.vocab) + ["zebra"]
    rng = np.random.default_rng(3)
    mirror = port.native()
    for _ in range(200):
        ctx = list(rng.choice(words, rng.integers(0, 3)))
        word = str(rng.choice(words))
        assert port.score(ctx, word) == jax.score(ctx, word)
        ids = [port.word_id(w) for w in ctx if port.word_id(w) is not None]
        tok = port.word_id(word)
        assert mirror.score(ids, -1 if tok is None else tok) == pytest.approx(port.score_ids(ids, tok), abs=1e-12)
    assert port.score(["<s>", "ab"], "cab") == pytest.approx(-0.2 * math.log(10.0))


def test_arpa_malformed_files_raise_like_jax(tmp_path):
    for name, text in (("a.arpa", "\\data\\\n\\end\\\n"), ("b.arpa", ARPA.replace("-1.2 ba", "-1.2 ba x y z"))):
        path = tmp_path / name
        path.write_text(text)
        with pytest.raises(ValueError) as want:
            JaxArpaLM.load(path)
        with pytest.raises(ValueError) as got:
            ArpaLM.load(path)
        assert str(got.value) == str(want.value)


def test_word_ngram_matches_jax_and_files_load_across(tmp_path):
    port, jax = WordNGramLM(order=3).fit(TEXTS), JaxWordNGramLM(order=3).fit(TEXTS)
    assert port.words == jax.words
    for ctx, tok in _queries(4, 200, len(port.words), 3):
        tok = None if tok == len(port.words) else tok
        assert port.score_ids(ctx, tok) == jax.score_ids(ctx, tok)
    port.save(tmp_path / "port.npz")
    jax.save(tmp_path / "jax.npz")
    from_port, from_jax = JaxWordNGramLM.load(tmp_path / "port.npz"), WordNGramLM.load(tmp_path / "jax.npz")
    assert from_port.words == from_jax.words == port.words
    for ctx, tok in _queries(5, 100, len(port.words), 2):
        assert from_port.score_ids(ctx, tok) == from_jax.score_ids(ctx, tok) == port.score_ids(ctx, tok)


SP_TOKENS = ["▁ab", "▁ca", "b", "▁ba", "▁x", "a"]


def _fusions(tmp_path):
    """(port, JAX) WordFusionLM pairs over each kind of word LM and both vocabulary styles."""
    path = tmp_path / "w.arpa"
    path.write_text(ARPA)
    return {
        "char_word_ngram": (WordFusionLM(WordNGramLM(order=2).fit(TEXTS), BatchTextTransformer(TOKENS)),
                            JaxWordFusionLM(JaxWordNGramLM(order=2).fit(TEXTS), JaxText(tokens=TOKENS))),
        "char_arpa_hotwords": (WordFusionLM(ArpaLM.load(path), BatchTextTransformer(TOKENS), word_score=-0.4,
                                            hotwords={"cab": 2.0, "bb": 1.0}),
                               JaxWordFusionLM(JaxArpaLM.load(path), JaxText(tokens=TOKENS), word_score=-0.4,
                                               hotwords={"cab": 2.0, "bb": 1.0})),
        "char_no_lm": (WordFusionLM(None, BatchTextTransformer(TOKENS), hotwords={"ab": 3.0}),
                       JaxWordFusionLM(None, JaxText(tokens=TOKENS), hotwords={"ab": 3.0})),
        "sp_arpa": (WordFusionLM(ArpaLM.load(path), BatchTextTransformer(SP_TOKENS)),
                    JaxWordFusionLM(JaxArpaLM.load(path), JaxText(tokens=SP_TOKENS))),
    }


FUSIONS = ["char_word_ngram", "char_arpa_hotwords", "char_no_lm", "sp_arpa"]


@pytest.mark.parametrize("name", FUSIONS)
def test_word_fusion_scores_match_jax(tmp_path, name):
    port, jax = _fusions(tmp_path)[name]
    assert (port.style, port.space_id, port.pieces, port._init_hist) == (jax.style, jax.space_id, jax.pieces,
                                                                        jax._init_hist)
    v = len(port.pieces)
    rng = np.random.default_rng(6)
    for _ in range(150):
        prefix = rng.integers(0, v - 1, rng.integers(0, 12)).tolist()
        tok = int(rng.integers(0, v - 1))
        assert port(prefix, tok) == jax(prefix, tok)
        assert port.final_score(prefix) == jax.final_score(prefix)
        assert port.partial_score(prefix) == jax.partial_score(prefix)
        assert port.state_of(prefix) == jax.state_of(prefix)
    words, scores = port._lookahead_table()
    jwords, jscores = jax._lookahead_table()
    assert words == jwords
    np.testing.assert_array_equal(scores, jscores)
    assert port.native() is not None


def test_word_fusion_refuses_a_vocabulary_without_a_separator():
    with pytest.raises(ValueError, match="separator"):
        WordFusionLM(None, BatchTextTransformer(list("abc")))
    with pytest.raises(ValueError, match="unknown style"):
        WordFusionLM(None, BatchTextTransformer(TOKENS), style="bpe")


# ---- the LM-fused host beam


def _logits(seed, b, t, v, scale=2.0):
    return (np.random.default_rng(seed).standard_normal((b, t, v)) * scale).astype(np.float32)


def _lms(tmp_path):
    fusions = _fusions(tmp_path)
    seqs = _corpus(9)
    return {"ngram": (NGramLM(order=3).fit(seqs), JaxNGramLM(order=3).fit(seqs)),
            **{name: fusions[name] for name in ("char_word_ngram", "char_arpa_hotwords", "char_no_lm")}}


LMS = ["ngram", "char_word_ngram", "char_arpa_hotwords", "char_no_lm"]


@pytest.mark.parametrize("name", LMS)
def test_native_beam_equals_numpy_and_jax(tmp_path, name):
    port_lm, jax_lm = _lms(tmp_path)[name]
    logits = _logits(11, 3, 45, len(TOKENS) + 1)
    kw = dict(lengths=[45, 30, 9], blank=len(TOKENS), beam_width=8, lm_weight=1.1)
    got = host.beam_search_decode(logits, lm=port_lm, **kw)
    numpy = host.beam_search_decode(logits, lm=port_lm, use_native=False, **kw)
    want = jax_host.beam_search_decode(logits, lm=jax_lm, **kw)
    assert [g.tolist() for g in got] == [n.tolist() for n in numpy] == [w.tolist() for w in want]
    got = host.beam_search_nbest(logits, lm=port_lm, nbest=4, **kw)
    numpy = host.beam_search_nbest(logits, lm=port_lm, nbest=4, use_native=False, **kw)
    want = jax_host.beam_search_nbest(logits, lm=jax_lm, nbest=4, **kw)
    for g, n, w in zip(got, numpy, want):
        assert [p.tolist() for p, _ in g] == [p.tolist() for p, _ in n] == [p.tolist() for p, _ in w]
        np.testing.assert_array_equal([s for _, s in g], [s for _, s in w])
        np.testing.assert_allclose([s for _, s in g], [s for _, s in n], rtol=0, atol=1e-9)
    logp = host.log_softmax(logits[0])
    state = numpy_state = jax_state = None
    for lo, hi in [(0, 17), (17, 18), (18, 45)]:
        state = host.beam_search_stream(logp[lo:hi], kw["blank"], beam_width=8, lm=port_lm, lm_weight=1.1,
                                        state=state)
        numpy_state = host.beam_search_stream(logp[lo:hi], kw["blank"], beam_width=8, lm=port_lm, lm_weight=1.1,
                                              state=numpy_state, use_native=False)
        jax_state = jax_host.beam_search_stream(logp[lo:hi], kw["blank"], beam_width=8, lm=jax_lm, lm_weight=1.1,
                                                state=jax_state)
    assert state.beams == jax_state.beams
    assert list(state.beams) == list(numpy_state.beams)
    for p, (pb, pnb) in state.beams.items():
        np.testing.assert_allclose(numpy_state.beams[p], (pb, pnb), rtol=0, atol=1e-9)
    assert state.best_final(port_lm, 1.1).tolist() == numpy_state.best_final(port_lm, 1.1).tolist()


def test_python_callable_lm_runs_the_numpy_search():
    calls = []

    def lm(prefix, token):
        calls.append(token)
        return -0.1 * token

    logits = _logits(12, 1, 20, 5)
    got = host.beam_search_decode(logits, blank=4, beam_width=4, lm=lm)
    want = jax_host.beam_search_decode(logits, blank=4, beam_width=4, lm=lm, use_native=False)
    assert calls and [g.tolist() for g in got] == [w.tolist() for w in want]


# ---- the module's host backend


@pytest.mark.parametrize("name", LMS)
def test_predict_host_backend_with_each_lm_matches_jax(tmp_path, pair, name):
    jax_module, port = pair
    port_lm, jax_lm = _lms(tmp_path)[name]
    audio = np.random.default_rng(0).normal(0, 0.1, (3, 4000)).astype(np.float32)
    kw = dict(beam_width=8, beam_backend="host", lm_weight=0.9)
    want = jax_module.predict(audio, lm=jax_lm, **kw)
    assert port.predict(audio, lm=port_lm, **kw) == want
    assert port.predict(audio, lm=port_lm, use_native=False, **kw) == want
    jax_engine = JaxEngine(jax_module, compute_dtype=jnp.float32, use_pallas=False)
    assert InferenceEngine(port).predict(audio, lm=port_lm, **kw) == jax_engine.predict(audio, lm=jax_lm, **kw)
