"""The port's text pipeline against the JAX package's (CPU): sentencepiece models, tokenizers, the trainer
and the BPE ``BatchTextTransformer``.

Text comes from numpy seeds: lines of words drawn from a seeded lexicon with
Zipf-like frequencies. Everything here is exact:

- ``parse_model_proto`` -> ``serialize_model_proto`` gives the JAX package's
  bytes, on the Citrinet fixture's ``tokenizer.model`` and on trained models;
- ``encode_as_pieces`` equals JAX's (unigram and BPE models, unseen
  characters and whitespace runs included);
- ``train_sentencepiece_model`` writes the same ``tokenizer.model`` and
  ``tokenizer.vocab`` bytes as JAX's trainer, unigram and BPE, with lower
  case on and off and a piece-length cap;
- the BPE ``BatchTextTransformer`` encodes and decodes as JAX's, the
  tokenizer precedence (custom function > sentencepiece > characters) is
  JAX's, and ``from_sentencepiece`` builds the same vocabulary.
"""

import tarfile
from pathlib import Path

import numpy as np
import pytest

from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.text import sentencepiece_model as jax_spm
from thunder_tpu.text import tokenizer as jax_tok
from thunder_tpu_torch.text import BatchTextTransformer, char_tokenizer, get_most_frequent_tokens, word_tokenizer
from thunder_tpu_torch.text import sentencepiece_model as spm
from thunder_tpu_torch.text import tokenizer as tok

FIXTURE = Path(__file__).parent / "fixtures" / "tiny_citrinet.nemo"


def seeded_lines(seed: int, n_lines: int, n_words: int = 300) -> list:
    """``n_lines`` lines of 3-12 words from a lexicon of ``n_words`` random lowercase words (numpy ``seed``)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lexicon = ["".join(rng.choice(letters, rng.integers(2, 10))) for _ in range(n_words)]
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    return [" ".join(rng.choice(lexicon, rng.integers(3, 13), p=p)) for _ in range(n_lines)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "text.txt"
    lines = seeded_lines(0, 400)
    lines[3] = "  The Quick   BROWN fox  "  # case and whitespace runs for the normalizer
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return path


def _train(module, corpus: Path, out: Path, **kw) -> Path:
    module.train_sentencepiece_model(str(corpus), output_dir=str(out), **kw)
    return out


TRAIN_CASES = {
    "unigram_200": dict(vocab_size=200),
    "unigram_120_cased_len4": dict(vocab_size=120, do_lower_case=False, max_sentencepiece_length=4),
    "bpe_90": dict(vocab_size=90, tokenizer_type="bpe"),
    "bpe_70_len3": dict(vocab_size=70, tokenizer_type="bpe", max_sentencepiece_length=3),
}


@pytest.fixture(scope="module", params=sorted(TRAIN_CASES))
def trained(request, corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    kw = TRAIN_CASES[request.param]
    return request.param, _train(tok, corpus, root / "port", **kw), _train(jax_tok, corpus, root / "jax", **kw)


def test_trainer_writes_the_jax_bytes(trained):
    _, port, jax = trained
    for name in ("tokenizer.model", "tokenizer.vocab"):
        assert (port / name).read_bytes() == (jax / name).read_bytes(), name
    assert len(spm.SentencePieceModel.load(str(port / "tokenizer.model")).pieces) > 50


def test_parse_serialize_round_trip_is_the_jax_bytes(trained, tmp_path):
    with tarfile.open(FIXTURE) as tar:
        tar.extract("tokenizer.model", tmp_path, filter="data")
    for path in (trained[1] / "tokenizer.model", tmp_path / "tokenizer.model"):
        data = path.read_bytes()
        got = spm.serialize_model_proto(spm.parse_model_proto(data))
        assert got == jax_spm.serialize_model_proto(jax_spm.parse_model_proto(data))
        model = spm.parse_model_proto(data)
        want = jax_spm.parse_model_proto(data)
        assert (model.pieces, model.scores, model.types, model.model_type, model.unk_id, model.normalizer_name,
                model.add_dummy_prefix, model.remove_extra_whitespaces) == (
            want.pieces, want.scores, want.types, want.model_type, want.unk_id, want.normalizer_name,
            want.add_dummy_prefix, want.remove_extra_whitespaces)


def test_encode_as_pieces_matches_jax(trained):
    name, port, _ = trained
    model = spm.SentencePieceModel.load(str(port / "tokenizer.model"))
    want_model = jax_spm.SentencePieceModel.load(str(port / "tokenizer.model"))
    assert model.model_type == (spm.BPE if name.startswith("bpe") else spm.UNIGRAM)
    lines = seeded_lines(1, 60) + ["", "   ", "Zebra QUIZ 42 café", "ünïcode and digits 0123", "a  b\tc"]
    for line in lines:
        assert model.encode_as_pieces(line) == want_model.encode_as_pieces(line), line
        assert tok.BPETokenizer(str(port / "tokenizer.model"))(line) == jax_tok.BPETokenizer(
            str(port / "tokenizer.model"))(line)
    assert model.piece_to_id("<unk>") == want_model.piece_to_id("<unk>") == 0
    assert model.piece_to_id("never-a-piece") == want_model.piece_to_id("never-a-piece")


def test_bpe_batch_text_transformer_matches_jax(trained):
    _, port, _ = trained
    got, want = BatchTextTransformer.from_sentencepiece(str(port)), JaxText.from_sentencepiece(str(port))
    assert got.vocab.itos == want.vocab.itos and got.num_tokens == want.num_tokens
    texts = seeded_lines(2, 8)
    ids, lengths = got.encode(texts)
    want_ids, want_lengths = want.encode(texts)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(lengths, want_lengths)
    assert got.decode_prediction(ids, remove_repeated=False) == want.decode_prediction(want_ids, remove_repeated=False)
    assert [t.strip() for t in got.decode_prediction(ids, remove_repeated=False)] == texts
    assert got.decode_prediction(ids) == want.decode_prediction(want_ids)


def test_citrinet_fixture_tokenizer_matches_jax(tmp_path):
    with tarfile.open(FIXTURE) as tar:
        tar.extract("tokenizer.model", tmp_path, filter="data")
    path = str(tmp_path / "tokenizer.model")
    tokens = [p for p in spm.SentencePieceModel.load(path).pieces if not p.startswith("<")]
    got = BatchTextTransformer(tokens, sentencepiece_model=path)
    want = JaxText(tokens, sentencepiece_model=path)
    texts = ["the quick brown fox", "hello world", "speech recognition on tensor processing units", "xyzzy"]
    np.testing.assert_array_equal(got.encode(texts)[0], want.encode(texts)[0])


def test_tokenizer_precedence_matches_jax(trained):
    _, port, _ = trained
    sp = str(port / "tokenizer.model")
    custom = lambda text: text.split("o")  # noqa: E731
    tokens = list("abcdefghijklmnopqrstuvwxyz ")
    for kw in (dict(custom_tokenizer_function=custom, sentencepiece_model=sp), dict(sentencepiece_model=sp), {}):
        got, want = BatchTextTransformer(tokens, **kw), JaxText(tokens, **kw)
        assert type(got.tokenizer).__name__ == type(want.tokenizer).__name__
        assert got.tokenizer("foo bar") == want.tokenizer("foo bar")


def test_plain_tokenizers_match_jax():
    corpus = " ".join(seeded_lines(3, 30))
    assert word_tokenizer(corpus) == jax_tok.word_tokenizer(corpus)
    assert char_tokenizer(corpus) == jax_tok.char_tokenizer(corpus)
    for kw in ({}, dict(minimum_frequency=3), dict(max_number_of_tokens=5)):
        assert get_most_frequent_tokens(corpus, word_tokenizer, **kw) == jax_tok.get_most_frequent_tokens(
            corpus, jax_tok.word_tokenizer, **kw)


def test_trainer_refuses_a_missing_file_and_skips_an_existing_model(corpus, tmp_path):
    with pytest.raises(ValueError, match="valid file"):
        tok.train_sentencepiece_model(str(tmp_path / "missing.txt"), 50, str(tmp_path / "out"))
    out = _train(tok, corpus, tmp_path / "sp", vocab_size=60)
    before = (out / "tokenizer.model").read_bytes()
    with pytest.warns(UserWarning, match="Skipping train"):
        tok.train_sentencepiece_model(str(corpus), 90, str(out))
    assert (out / "tokenizer.model").read_bytes() == before
