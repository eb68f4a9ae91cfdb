"""Word spans and subtitle files from forced-alignment output.

Port of ``thunder_tpu/text/subtitles.py``.

``CTCModule.align`` yields per-token ``(token, start_s, end_s)`` spans;
these helpers group them into words and render standard SRT / WebVTT cue
files — the practical endpoint of the alignment feature (subtitling,
karaoke highlighting, corpus segmentation).  Host-side, dependency-free.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

__all__ = ["word_spans", "to_srt", "to_vtt"]

_SP_MARK = "▁"


def word_spans(
    token_spans: Sequence[Tuple[str, float, float]],
    specials=None,
) -> List[Tuple[str, float, float]]:
    """Group aligned token spans into ``(word, start_s, end_s)`` spans.

    Handles both vocabulary styles: separator tokens (``" "``/``"|"``) end a
    word and are dropped; sentencepiece ``"▁"``-initial pieces start one.
    A word's span runs from its first token's start to its last token's end.

    ``specials``: tokens to drop entirely (a vocab's start/end/unknown/pad
    markers, which the text transform can emit into encoded targets).  By
    default any multi-character ``<...>`` token is dropped — the convention
    every shipped vocabulary uses (``<s>``, ``</s>``, ``<unk>``, ``<blank>``,
    ``<pad>``); pass an explicit collection to override.
    """
    words: List[Tuple[str, float, float]] = []
    cur, start, end = "", 0.0, 0.0

    def is_special(tok: str) -> bool:
        if specials is not None:
            return tok in specials
        return len(tok) > 1 and tok.startswith("<") and tok.endswith(">")

    def close():
        nonlocal cur
        if cur:
            words.append((cur, start, end))
            cur = ""

    for tok, s, e in token_spans:
        if is_special(tok):
            continue
        if tok in (" ", "|"):
            close()
            continue
        piece = tok
        if piece.startswith(_SP_MARK):
            close()
            piece = piece[len(_SP_MARK) :]
            if not piece:
                continue
        if not cur:
            start = s
        cur += piece
        end = e
    close()
    return words


def _fmt_ts(seconds: float, sep: str) -> str:
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def _cues(
    words: Sequence[Tuple[str, float, float]],
    max_chars: int,
    max_seconds: float,
) -> List[Tuple[float, float, str]]:
    cues: List[Tuple[float, float, str]] = []
    text, start, end = "", 0.0, 0.0
    for word, s, e in words:
        grown = f"{text} {word}".strip()
        if text and (len(grown) > max_chars or e - start > max_seconds):
            cues.append((start, end, text))
            text, start = "", s
            grown = word
        if not text:
            start = s
        text, end = grown, e
    if text:
        cues.append((start, end, text))
    return cues


def to_srt(
    token_spans: Sequence[Tuple[str, float, float]],
    max_chars: int = 42,
    max_seconds: float = 5.0,
    specials=None,
) -> str:
    """SRT subtitle document from aligned token spans.

    Words are greedily packed into cues bounded by ``max_chars`` characters
    and ``max_seconds`` duration (standard subtitle readability limits).
    """
    lines = []
    for i, (start, end, text) in enumerate(
        _cues(word_spans(token_spans, specials), max_chars, max_seconds), 1
    ):
        lines.append(f"{i}\n{_fmt_ts(start, ',')} --> {_fmt_ts(end, ',')}\n{text}\n")
    return "\n".join(lines)


def to_vtt(
    token_spans: Sequence[Tuple[str, float, float]],
    max_chars: int = 42,
    max_seconds: float = 5.0,
    specials=None,
) -> str:
    """WebVTT subtitle document from aligned token spans."""
    lines = ["WEBVTT\n"]
    for start, end, text in _cues(word_spans(token_spans, specials), max_chars, max_seconds):
        lines.append(f"{_fmt_ts(start, '.')} --> {_fmt_ts(end, '.')}\n{text}\n")
    return "\n".join(lines)
