"""Self-contained sentencepiece ``.model`` reader/writer + encoders.

Port of ``thunder_tpu/text/sentencepiece_model.py``. NeMo Citrinet checkpoints
ship a ``tokenizer.model`` protobuf, and no sentencepiece library is needed to
read it: this module implements

- a minimal protobuf *wire format* parser/serializer (no generated code),
- the subset of ``sentencepiece_model.proto`` we need (pieces with
  piece/score/type, trainer_spec.model_type, normalizer_spec),
- unigram (Viterbi) and BPE (score-greedy merge) segmentation.

The unigram Viterbi runs in the port's C++ runtime
(:class:`thunder_tpu_torch.native.NativeSpmEncoder`) where it builds, else
in the pure-Python dynamic programme: both give the same spans.

Field numbers follow the public sentencepiece_model.proto:
ModelProto{pieces=1, trainer_spec=2, normalizer_spec=3};
SentencePiece{piece=1, score=2, type=3};
TrainerSpec{model_type=3, vocab_size=4, unk_id=40, bos_id=41, eos_id=42,
pad_id=43}; NormalizerSpec{name=1, add_dummy_prefix=3,
remove_extra_whitespaces=4, escape_whitespaces=5}.
"""

from __future__ import annotations

import struct
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = ["SentencePieceModel", "parse_model_proto", "serialize_model_proto"]

WORD_BOUNDARY = "▁"  # '▁'

# piece types
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4


# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for a protobuf message body."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wtype}")
        yield fnum, wtype, val


def _field(fnum: int, wtype: int, payload: bytes) -> bytes:
    return _write_varint((fnum << 3) | wtype) + payload


def _len_field(fnum: int, payload: bytes) -> bytes:
    return _field(fnum, 2, _write_varint(len(payload)) + payload)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


@dataclass
class SentencePieceModel:
    """Parsed sentencepiece model: pieces + enough spec to tokenize."""

    pieces: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    types: List[int] = field(default_factory=list)
    model_type: int = UNIGRAM
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    normalizer_name: str = "nmt_nfkc"
    unk_id: int = 0

    _index: Dict[str, int] = field(default_factory=dict, repr=False)
    _max_piece_len: int = 1

    def __post_init__(self):
        self._reindex()

    def _reindex(self):
        self._index = {}
        self._max_piece_len = 1
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t in (NORMAL, USER_DEFINED):
                self._index[p] = i
                if len(p) > self._max_piece_len:
                    self._max_piece_len = len(p)
        self._native_enc = None  # stale after any piece change

    def _native_encoder(self):
        """The C++ Viterbi encoder (tn_spm_*), built on first use; ``None`` where the runtime does not build."""
        if self._native_enc is None:
            from thunder_tpu_torch.native import NativeSpmEncoder, native_available

            if not native_available():
                return None
            min_score = min(self.scores) if self.scores else 0.0
            pieces = list(self._index.keys())
            try:
                self._native_enc = NativeSpmEncoder(pieces, [self.scores[self._index[p]] for p in pieces],
                                                    min_score - 10.0)
            except ValueError:
                return None
        return self._native_enc

    # -- loading ----------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return parse_model_proto(f.read())

    # -- normalization ----------------------------------------------------

    def normalize(self, text: str) -> str:
        # Approximation of the nmt_nfkc(_cf) normalizers: NFKC plus optional
        # casefolding.  (The precompiled charsmap adds NMT-specific control
        # char handling that is irrelevant for ASR transcripts.)
        if self.normalizer_name != "identity":
            text = unicodedata.normalize("NFKC", text)
            if self.normalizer_name.endswith("_cf"):
                text = text.lower()
        if self.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", WORD_BOUNDARY)

    # -- encoding ---------------------------------------------------------

    def encode_as_pieces(self, text: str) -> List[str]:
        s = self.normalize(text)
        if not s:
            return []
        if self.model_type == BPE:
            return self._encode_bpe(s)
        if self.model_type == CHAR:
            return list(s)
        if self.model_type == WORD:
            return [WORD_BOUNDARY + w for w in text.split()]
        return self._encode_unigram(s)

    def _encode_unigram(self, s: str) -> List[str]:
        """Viterbi segmentation maximizing the total piece score (C++ where it builds, else the Python
        dynamic programme: the same spans)."""
        enc = self._native_encoder()
        if enc is not None:
            out = enc.encode_spans(s)
            if out is not None:
                return out
        return self._encode_unigram_py(s)

    def _encode_unigram_py(self, s: str) -> List[str]:
        """Viterbi segmentation maximizing the total piece score; an unknown character is kept as a piece
        of its own at the lowest score less 10, as sentencepiece keeps its surface."""
        n = len(s)
        min_score = min(self.scores) if self.scores else 0.0
        unk_score = min_score - 10.0
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Tuple[int, str]] = [(-1, "")] * (n + 1)
        best[0] = 0.0
        idx = self._index
        maxlen = self._max_piece_len
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            base = best[i]
            # known pieces
            upper = min(n, i + maxlen)
            for j in range(i + 1, upper + 1):
                sub = s[i:j]
                k = idx.get(sub)
                if k is not None:
                    cand = base + self.scores[k]
                    if cand > best[j]:
                        best[j] = cand
                        back[j] = (i, sub)
            # unknown single char fallback (surface kept, like sentencepiece)
            cand = base + unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, s[i : i + 1])
        out: List[str] = []
        j = n
        while j > 0:
            i, piece = back[j]
            out.append(piece)
            j = i
        out.reverse()
        return out

    def _encode_bpe(self, s: str) -> List[str]:
        """Greedy merges: repeatedly merge the adjacent pair whose
        concatenation is the highest-scoring piece in the vocab."""
        symbols = list(s)
        idx = self._index
        while len(symbols) > 1:
            best_score = None
            best_pos = -1
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                k = idx.get(merged)
                if k is not None:
                    sc = self.scores[k]
                    if best_score is None or sc > best_score:
                        best_score = sc
                        best_pos = i
            if best_pos < 0:
                break
            symbols[best_pos : best_pos + 2] = [symbols[best_pos] + symbols[best_pos + 1]]
        return symbols

    def piece_to_id(self, piece: str) -> int:
        if not hasattr(self, "_piece_ids") or len(self._piece_ids) != len(self.pieces):
            self._piece_ids = {p: i for i, p in enumerate(self.pieces)}
        return self._piece_ids.get(piece, self.unk_id)

    # -- serialization ----------------------------------------------------

    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(serialize_model_proto(self))


def parse_model_proto(data: bytes) -> SentencePieceModel:
    model = SentencePieceModel()
    model.pieces, model.scores, model.types = [], [], []
    for fnum, _, val in _iter_fields(data):
        if fnum == 1:  # SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for pf, pw, pv in _iter_fields(val):
                if pf == 1:
                    piece = pv.decode("utf-8")
                elif pf == 2:
                    score = struct.unpack("<f", pv)[0]
                elif pf == 3:
                    ptype = pv
            model.pieces.append(piece)
            model.scores.append(score)
            model.types.append(ptype)
        elif fnum == 2:  # TrainerSpec
            for tf, tw, tv in _iter_fields(val):
                if tf == 3 and tw == 0:
                    model.model_type = tv
                elif tf == 40 and tw == 0:
                    model.unk_id = tv
        elif fnum == 3:  # NormalizerSpec
            for nf, nw, nv in _iter_fields(val):
                if nf == 1:
                    model.normalizer_name = nv.decode("utf-8")
                elif nf == 3 and nw == 0:
                    model.add_dummy_prefix = bool(nv)
                elif nf == 4 and nw == 0:
                    model.remove_extra_whitespaces = bool(nv)
    # fallback unk detection
    for i, t in enumerate(model.types):
        if t == UNKNOWN:
            model.unk_id = i
            break
    model._reindex()
    return model


def serialize_model_proto(model: SentencePieceModel) -> bytes:
    out = bytearray()
    for piece, score, ptype in zip(model.pieces, model.scores, model.types):
        body = _len_field(1, piece.encode("utf-8"))
        body += _field(2, 5, struct.pack("<f", float(score)))
        if ptype != NORMAL:
            body += _field(3, 0, _write_varint(ptype))
        out += _len_field(1, bytes(body))
    trainer = _field(3, 0, _write_varint(model.model_type))
    trainer += _field(40, 0, _write_varint(model.unk_id))
    out += _len_field(2, trainer)
    norm = _len_field(1, model.normalizer_name.encode("utf-8"))
    norm += _field(3, 0, _write_varint(1 if model.add_dummy_prefix else 0))
    norm += _field(4, 0, _write_varint(1 if model.remove_extra_whitespaces else 0))
    out += _len_field(3, bytes(norm))
    return bytes(out)
