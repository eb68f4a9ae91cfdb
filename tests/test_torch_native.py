"""The port's native host runtime (``thunder_tpu_torch/native.py``) against the JAX package's, call by call (CPU).

- WAV decode at every valid (format, bits) pair, FLAC decode (``tests/flac_writer.py``), resample, edit distance,
  collapse: equal to ``thunder_tpu.native``;
- the n-gram and ARPA scorers, the sentencepiece spans and word fusion: equal scores, spans and decodes;
- the beam search (one utterance, the threaded batch, carried windows) with and without each LM: equal ids,
  scores and carried beams;
- the repairs: a lying data chunk is clamped in ``native_wav_info`` (C6), an invalid (format, bits) pair raises
  instead of decoding zeros (C7), and a FLAC sample past the stream's bit depth raises; each pinned beside the JAX
  package's behaviour on the same file.

On a machine with ``g++`` the runtime must build: the ``native`` fixture fails, it does not skip.
"""

import math
import shutil
import struct

import numpy as np
import pytest

import thunder_tpu.native as jax_native
import thunder_tpu_torch.native as native
from tests.flac_writer import write_flac
from tests.test_torch_data import EXTENSIBLE, FLOAT, PCM, _signal, wav_bytes
from thunder_tpu.text.lm import ArpaLM as JaxArpaLM
from thunder_tpu.text.lm import NGramLM as JaxNGramLM
from thunder_tpu.text.word_fusion import WordFusionLM as JaxWordFusionLM
from thunder_tpu.text.word_fusion import WordNGramLM as JaxWordNGramLM
from thunder_tpu.text.transform import BatchTextTransformer as JaxText
from thunder_tpu_torch.text import ArpaLM, BatchTextTransformer, NGramLM, WordFusionLM, WordNGramLM
from thunder_tpu_torch.training.metrics import _edit_distance_py, edit_distance

ARPA = """\\data\\
ngram 1=5
ngram 2=4
ngram 3=2

\\1-grams:
-1.0 <s> -0.30103
-0.7 the -0.2
-0.9 cat -0.15
-1.2 sat
-2.0 <unk>

\\2-grams:
-0.3 <s> the -0.1
-0.5 the cat -0.05
-0.8 cat sat
-1.1 sat the

\\3-grams:
-0.2 <s> the cat
-0.6 the cat sat

\\end\\
"""


@pytest.fixture(scope="module")
def lib():
    """The port's runtime, loaded; a failed build on a machine with g++ fails the test."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the native runtime cannot be built")
    assert native.native_available(), "g++ is present but the native runtime did not build"
    return native.load()


def _logp(seed, t, v, scale=2.0):
    logits = np.random.default_rng(seed).standard_normal((t, v)).astype(np.float32) * scale
    return logits - np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1, keepdims=True)) - logits.max(
        -1, keepdims=True)


# ---- audio


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fmt,bits", [(PCM, 8), (PCM, 16), (PCM, 24), (PCM, 32), (FLOAT, 32), (FLOAT, 64)])
def test_wav_decode_and_info_match_jax(lib, tmp_path, fmt, bits, channels):
    path = tmp_path / "a.wav"
    path.write_bytes(wav_bytes(_signal(777, channels, seed=bits), 22050, fmt, bits))
    got, rate = native.native_load_wav(str(path))
    want, want_rate = jax_native.native_load_wav(str(path))
    assert rate == want_rate == 22050 and got.shape == (channels, 777)
    np.testing.assert_array_equal(got, want)
    assert native.native_wav_info(str(path)) == jax_native.native_wav_info(str(path)) == (777, 22050, channels, bits)


def test_extensible_wav_needs_its_40_byte_chunk(lib, tmp_path):
    path = tmp_path / "x.wav"
    path.write_bytes(wav_bytes(_signal(300, 2, seed=1), 48000, PCM, 24, extensible=True))
    np.testing.assert_array_equal(native.native_load_wav(str(path))[0], jax_native.native_load_wav(str(path))[0])


def test_lying_data_chunk_is_clamped_in_wav_info(lib, tmp_path):
    """C6: the JAX runtime's ``tn_wav_info`` reports the claimed frames; the port's reports the frames held."""
    path = tmp_path / "lying.wav"
    path.write_bytes(wav_bytes(_signal(800, 2), 16000, PCM, 16, data_size=10**9) + b"\x01")
    assert native.native_wav_info(str(path)) == (800, 16000, 2, 16)
    assert jax_native.native_wav_info(str(path))[0] == 10**9 // 4  # the fault, not carried over
    audio, _ = native.native_load_wav(str(path))
    assert audio.shape == (2, 800)


@pytest.mark.parametrize("fmt,bits", [(PCM, 64), (FLOAT, 8), (FLOAT, 16), (FLOAT, 24), (PCM, 12), (6, 8),
                                      (EXTENSIBLE, 16)])
def test_invalid_format_and_bit_depth_pairs_raise(lib, tmp_path, fmt, bits):
    """C7: the JAX runtime decodes 64-bit PCM and 8/16/24-bit float as silence; the port's refuses every pair
    its Python reader refuses, in both entry points."""
    block = max(bits // 8, 1)
    body = bytes(range(256)) * (64 * block // 256 + 1)
    fmt_body = struct.pack("<HHIIHH", fmt, 1, 16000, 16000 * block, block, bits)
    chunks = b"fmt " + struct.pack("<I", 16) + fmt_body + b"data" + struct.pack("<I", 64 * block) + body[:64 * block]
    path = tmp_path / "bad.wav"
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)
    with pytest.raises(ValueError, match="native wav decode failed"):
        native.native_load_wav(str(path))
    with pytest.raises(ValueError, match="native wav info failed"):
        native.native_wav_info(str(path))
    if (fmt, bits) in ((PCM, 64), (FLOAT, 8), (FLOAT, 16), (FLOAT, 24)):
        silent, _ = jax_native.native_load_wav(str(path))
        assert silent.shape[1] > 0 and not silent.any()  # the fault, not carried over


FLAC_CASES = [
    dict(kind="verbatim"), dict(kind="fixed0"), dict(kind="fixed3"), dict(kind="fixed4"), dict(kind="lpc"),
    dict(kind="constant"), dict(kind="fixed2", partition_order=2, blocksize=512),
    dict(kind="fixed1", stereo_mode="mid_side"), dict(kind="lpc", stereo_mode="mid_side", blocksize=300),
]


@pytest.mark.parametrize("case", FLAC_CASES, ids=lambda c: "-".join(str(v) for v in c.values()))
def test_flac_decode_matches_jax(lib, tmp_path, case):
    channels = 2 if "stereo_mode" in case else 1
    rng = np.random.default_rng(len(str(case)))
    t = np.arange(3072) / 16000  # whole blocks at partition order 2 (the writer does not split a remainder)
    samples = np.stack([np.clip((0.4 * np.sin(2 * np.pi * (220 + 90 * c) * t) + 0.02 * rng.standard_normal(t.size))
                                * 32767, -32768, 32767) for c in range(channels)]).astype(np.int64)
    if case["kind"] == "constant":
        samples[:] = 1234
    path = tmp_path / "x.flac"
    write_flac(str(path), samples, **case)
    got, rate = native.native_load_flac(str(path))
    want, want_rate = jax_native.native_load_flac(str(path))
    assert rate == want_rate == 16000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (samples / 32768.0).astype(np.float32))


def test_flac_sample_past_its_bit_depth_raises(lib, tmp_path):
    """A STREAMINFO that says 8 bits over frames of 16-bit samples: the JAX runtime returns samples past [-1, 1];
    the port's refuses the file (integer PCM always decodes into [-1, 1])."""
    samples = (np.sin(np.arange(2000) / 9.0) * 20000).astype(np.int64)[None]
    path = tmp_path / "deep.flac"
    write_flac(str(path), samples, kind="fixed2")
    blob = bytearray(path.read_bytes())
    # STREAMINFO bytes 8-25: rate(20) channels-1(3) bps-1(5) total(36) starting at byte 18
    bits = int.from_bytes(blob[18:26], "big")
    bits = (bits & ~(0x1F << 36)) | (7 << 36)
    blob[18:26] = bits.to_bytes(8, "big")
    path.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match=r"native flac decode failed \(-16\)"):
        native.native_load_flac(str(path))
    loud, _ = jax_native.native_load_flac(str(path))
    assert np.abs(loud).max() > 1.0  # the fault, not carried over


@pytest.mark.parametrize("up,down", [(1, 2), (2, 1), (160, 441), (3, 2)])
def test_resample_matches_jax(lib, up, down):
    x = np.random.default_rng(up + down).standard_normal(1003).astype(np.float32)
    np.testing.assert_array_equal(native.native_resample(x, up, down), jax_native.native_resample(x, up, down))


# ---- text metrics


def test_edit_distance_and_collapse_match_jax(lib):
    rng = np.random.default_rng(0)
    for _ in range(40):
        a = rng.integers(0, 5, size=rng.integers(0, 30)).tolist()
        b = rng.integers(0, 5, size=rng.integers(0, 30)).tolist()
        want = jax_native.native_edit_distance(a, b)
        assert native.native_edit_distance(a, b) == want == _edit_distance_py(a, b)
        ids = np.asarray(a, np.int32)
        np.testing.assert_array_equal(native.native_ctc_collapse(ids), jax_native.native_ctc_collapse(ids))
    assert native.native_edit_distance("kitten", "sitting") == 3
    assert edit_distance(["the", "cat"], ["the", "dog", "cat"]) == 1 == _edit_distance_py(["the", "cat"],
                                                                                          ["the", "dog", "cat"])


def test_spm_spans_match_jax(lib):
    pieces = ["▁", "▁the", "▁ca", "t", "s", "▁sat", "a", "at", "▁c", "é", "ab"]
    scores = [-1.0, -2.0, -3.0, -2.5, -1.5, -4.0, -2.0, -1.0, -3.5, -6.0, -2.2]
    got = native.NativeSpmEncoder(pieces, scores, -16.0)
    want = jax_native.NativeSpmEncoder(pieces, scores, -16.0)
    rng = np.random.default_rng(1)
    alphabet = list("▁thecasabé?") + ["▁the", "▁sat"]
    for _ in range(50):
        text = "".join(rng.choice(alphabet, rng.integers(0, 20)))
        assert got.encode_spans(text) == want.encode_spans(text)


def test_sentencepiece_model_encodes_natively_as_in_python(lib):
    from thunder_tpu_torch.text.sentencepiece_model import NORMAL, SentencePieceModel

    pieces = ["<unk>", "▁", "▁the", "▁ca", "t", "s", "▁sat", "a", "at", "▁c", "é", "ab"]
    model = SentencePieceModel(pieces=pieces, scores=[0.0, -1.0, -2.0, -3.0, -2.5, -1.5, -4.0, -2.0, -1.0, -3.5,
                                                      -6.0, -2.2], types=[2] + [NORMAL] * 11)
    assert model._native_encoder() is not None
    rng = np.random.default_rng(2)
    alphabet = list("▁thecasabé?x") + ["▁the", "▁sat"]
    for _ in range(50):
        text = "".join(rng.choice(alphabet, rng.integers(0, 25)))
        assert model._encode_unigram(text) == model._encode_unigram_py(text)


# ---- LM scorers


def _corpus(seed, n=40, v=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, v, rng.integers(1, 12)).tolist() for _ in range(n)]


def test_ngram_and_arpa_scores_match_jax(lib, tmp_path):
    seqs = _corpus(0)
    port, jax = NGramLM(order=3).fit(seqs), JaxNGramLM(order=3).fit(seqs)
    got = native.NativeNGramLM.from_counts(3, 0.4, -12.0, port._counts)
    want = jax_native.NativeNGramLM.from_counts(3, 0.4, -12.0, jax._counts)
    rng = np.random.default_rng(1)
    for _ in range(200):
        ctx, tok = rng.integers(0, 8, rng.integers(0, 4)).tolist(), int(rng.integers(0, 8))
        assert got.score(ctx, tok) == want.score(ctx, tok) == pytest.approx(jax.score(ctx, tok), abs=1e-12)
    path = tmp_path / "a.arpa"
    path.write_text(ARPA)
    port_arpa, jax_arpa = ArpaLM.load(path), JaxArpaLM.load(path)
    got = native.NativeNGramLM.from_arpa_tables(3, -20.0, port_arpa._unk_id, port_arpa._tables)
    want = jax_native.NativeNGramLM.from_arpa_tables(3, -20.0, jax_arpa._unk_id, jax_arpa._tables)
    for _ in range(200):
        ctx, tok = rng.integers(0, 5, rng.integers(0, 3)).tolist(), int(rng.integers(-1, 5))
        assert got.score(ctx, tok) == want.score(ctx, tok)


# ---- the beam search


def _scorers(tmp_path):
    """(port LM, JAX LM) pairs: none, a token n-gram, an ARPA word LM with fusion, a word n-gram with hotwords."""
    tokens = list("abct ")
    seqs = _corpus(2, v=len(tokens))
    path = tmp_path / "w.arpa"
    path.write_text(ARPA.replace("cat", "cab").replace("sat", "bat"))
    texts = ["cat cab a", "a cat cat", "bat a cab"]
    return {
        "none": (None, None),
        "ngram": (NGramLM(order=3).fit(seqs), JaxNGramLM(order=3).fit(seqs)),
        "arpa_fusion": (WordFusionLM(ArpaLM.load(path), BatchTextTransformer(tokens)),
                        JaxWordFusionLM(JaxArpaLM.load(path), JaxText(tokens=tokens))),
        "word_fusion": (WordFusionLM(WordNGramLM(order=2).fit(texts), BatchTextTransformer(tokens), word_score=-0.3,
                                     hotwords={"cab": 1.5}),
                        JaxWordFusionLM(JaxWordNGramLM(order=2).fit(texts), JaxText(tokens=tokens), word_score=-0.3,
                                        hotwords={"cab": 1.5})),
    }


@pytest.mark.parametrize("scorer", ["none", "ngram", "arpa_fusion", "word_fusion"])
def test_beam_search_entry_points_match_jax(lib, tmp_path, scorer):
    port_lm, jax_lm = _scorers(tmp_path)[scorer]
    port_native = port_lm.native() if port_lm is not None else None
    jax_lm_native = jax_lm.native() if jax_lm is not None else None
    assert (port_native is None) == (port_lm is None)
    v, blank = 6, 5
    logp = np.stack([_logp(s, 40, v) for s in range(3)])
    kw = dict(beam_width=6, prune_logp=-8.0, max_tokens_per_step=4)
    for b in range(3):
        got = native.native_ctc_beam_search(logp[b], blank, return_score=True, lm=port_native, lm_weight=0.7, **kw)
        want = jax_native.native_ctc_beam_search(logp[b], blank, return_score=True, lm=jax_lm_native, lm_weight=0.7,
                                                 **kw)
        assert got[0].tolist() == want[0].tolist() and got[1] == want[1]
    lengths = [40, 23, 0]
    got = native.native_ctc_beam_search_batch(logp, lengths, blank, lm=port_native, lm_weight=0.7, n_threads=3, **kw)
    want = jax_native.native_ctc_beam_search_batch(logp, lengths, blank, lm=jax_lm_native, lm_weight=0.7, **kw)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    state = jstate = None
    for lo, hi in [(0, 13), (13, 14), (14, 40)]:
        state = native.native_ctc_beam_search_stream(logp[0, lo:hi], blank, in_beams=state, lm=port_native,
                                                     lm_weight=0.7, **kw)
        jstate = jax_native.native_ctc_beam_search_stream(logp[0, lo:hi], blank, in_beams=jstate, lm=jax_lm_native,
                                                          lm_weight=0.7, **kw)
        assert [(p.tolist(), pb, pnb) for p, pb, pnb in state] == [(p.tolist(), pb, pnb) for p, pb, pnb in jstate]


def test_beam_search_refuses_bad_arguments(lib):
    logp = _logp(0, 5, 4)
    assert native.native_ctc_beam_search(logp, blank=4) is None  # blank past V
    assert native.native_ctc_beam_search_batch(logp[None], [6], blank=0) is None  # a length past T
    assert math.isfinite(native.native_ctc_beam_search(logp, blank=0, return_score=True)[1])
