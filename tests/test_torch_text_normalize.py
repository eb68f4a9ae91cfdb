"""The port's text normalizers and subtitle writers against the JAX package's (CPU): string equality.

- ``num2words`` over seeded integers of every magnitude class, cardinal and ordinal, in every language of
  ``_CARDINALS`` (and the refusals: too large, an unknown language, a negative ordinal), the same strings or the
  same exception;
- ``expand_numbers``, ``normalize_text`` and ``lower_text`` on seeded strings of digits, ordinals, accents and
  case;
- ``word_spans``, ``to_srt`` and ``to_vtt`` on seeded token spans in the character and the sentencepiece style,
  with and without specials.
"""

import numpy as np
import pytest

from thunder_tpu.text import numbers as jax_numbers
from thunder_tpu.text import preprocess as jax_preprocess
from thunder_tpu.text import subtitles as jax_subtitles
from thunder_tpu_torch.text import expand_numbers, lower_text, normalize_text, to_srt, to_vtt, word_spans
from thunder_tpu_torch.text import numbers

LANGUAGES = sorted(jax_numbers._CARDINALS)


def _same(jax_call, port_call):
    """Both calls give the same string, or both raise the same exception type with the same message."""
    try:
        want = jax_call()
    except Exception as e:  # noqa: BLE001 - the refusals are part of the contract
        with pytest.raises(type(e)) as got:
            port_call()
        assert str(got.value) == str(e)
        return None
    assert port_call() == want
    return want


def _integers(seed):
    rng = np.random.default_rng(seed)
    small = list(range(0, 121)) + [1000, 1001, 10**6, 10**6 + 1, 10**9, 2 * 10**9 + 1]
    spread = [int(rng.integers(0, 10 ** int(rng.integers(1, 16)))) for _ in range(150)]
    return small + spread + [10**12 - 1, 10**12, 10**15 - 1, 10**15, -5, -1234]


def test_the_port_spells_the_same_languages():
    assert sorted(numbers._CARDINALS) == LANGUAGES and sorted(numbers._ORDINALS) == sorted(jax_numbers._ORDINALS)


@pytest.mark.parametrize("lang", LANGUAGES)
def test_num2words_matches_jax(lang):
    spelled = 0
    for n in _integers(LANGUAGES.index(lang)):
        for to in ("cardinal", "ordinal"):
            spelled += _same(lambda: jax_numbers.num2words(n, lang=lang, to=to),
                             lambda: numbers.num2words(n, lang=lang, to=to)) is not None
    assert spelled > 300


def test_num2words_language_codes_and_refusals():
    for lang in ("en_US", "pt-BR", "DE", "xx", "ja"):
        _same(lambda: jax_numbers.num2words(42, lang=lang), lambda: numbers.num2words(42, lang=lang))
    _same(lambda: jax_numbers.num2words(3, lang="xx", to="ordinal"), lambda: numbers.num2words(3, lang="xx",
                                                                                               to="ordinal"))


def _sentences(seed, n=60):
    rng = np.random.default_rng(seed)
    words = ["Olá", "Über", "naïve", "café", "ÉCOLE", "the", "Straße", "ﬁne", "№", "½", "x²", "Ωmega", "año"]
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 9))):
            kind = int(rng.integers(0, 4))
            if kind == 0:
                parts.append(str(rng.choice(words)))
            elif kind == 1:
                parts.append(str(int(rng.integers(0, 10 ** int(rng.integers(1, 8))))))
            elif kind == 2:
                parts.append(f"{int(rng.integers(1, 200))}º")
            else:
                parts.append(f"{int(rng.integers(0, 99))}{rng.choice(['km', '%', 'º', ''])}")
        out.append(" ".join(parts))
    return out


@pytest.mark.parametrize("lang", ["en", "pt", "es", "de", "fr", "it", "ca", "pl", "ru"])
def test_expand_numbers_matches_jax(lang):
    for text in _sentences(len(lang) + ord(lang[0])):
        _same(lambda: jax_preprocess.expand_numbers(text, language=lang), lambda: expand_numbers(text, language=lang))


def test_normalize_and_lower_match_jax():
    for text in _sentences(99):
        assert normalize_text(text) == jax_preprocess.normalize_text(text)
        assert lower_text(text) == jax_preprocess.lower_text(text)
        assert normalize_text(lower_text(text)) == jax_preprocess.normalize_text(jax_preprocess.lower_text(text))


def _token_spans(seed, style):
    rng = np.random.default_rng(seed)
    if style == "char":
        vocab = list("abcdef") + [" ", "|", "<s>", "</s>", "<unk>"]
    else:
        vocab = ["▁ab", "▁c", "de", "f", "▁", "▁x", "<s>", "</s>", "<pad>"]
    spans, t = [], float(rng.uniform(0, 2))
    for _ in range(int(rng.integers(0, 60))):
        dur = float(rng.uniform(0.02, 0.6))
        spans.append((str(rng.choice(vocab)), t, t + dur))
        t += dur + float(rng.uniform(0, 0.3))
    return spans


@pytest.mark.parametrize("style", ["char", "sentencepiece"])
def test_subtitles_match_jax(style):
    for seed in range(40):
        spans = _token_spans(seed, style)
        for specials in (None, {"<s>", "</s>"}, ()):
            assert word_spans(spans, specials) == jax_subtitles.word_spans(spans, specials)
            for kw in (dict(), dict(max_chars=8, max_seconds=1.5), dict(max_chars=200, max_seconds=60.0)):
                assert to_srt(spans, specials=specials, **kw) == jax_subtitles.to_srt(spans, specials=specials, **kw)
                assert to_vtt(spans, specials=specials, **kw) == jax_subtitles.to_vtt(spans, specials=specials, **kw)
