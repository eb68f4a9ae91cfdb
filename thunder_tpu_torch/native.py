"""ctypes bindings for the port's native host runtime (``csrc/thunder_native.cpp``).

Port of ``thunder_tpu/native.py``, with the same public names. The runtime is
host C++ (no CUDA): WAV and FLAC decode, resampling, edit distance, CTC
collapse, the n-gram scorers, the sentencepiece encoder, word-level fusion
and the CTC prefix beam search.

The library is built on first use, never at import: ``g++`` compiles
``thunder_tpu_torch/csrc/thunder_native.cpp`` into
``thunder_tpu_torch/build/libthunder_native_<hash>.so``, where the hash
covers the source and the flags, so an edited source is rebuilt and a stale
build is never loaded. The build holds a file lock, writes a temporary name
and renames it into place, so processes that load at once (test workers)
each see a whole library. A failed build is remembered only in this process
and only for the source it failed on.

Callers keep the JAX package's fallbacks: :func:`native_available` says
whether the library loads, and the beam entry points return ``None`` when it
does not.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = [
    "native_available",
    "native_load_wav",
    "native_load_flac",
    "native_wav_info",
    "native_resample",
    "native_edit_distance",
    "native_ctc_collapse",
    "native_ctc_beam_search",
    "native_ctc_beam_search_batch",
    "native_ctc_beam_search_stream",
    "NativeNGramLM",
    "NativeSpmEncoder",
    "NativeWordFusion",
]

SRC = Path(__file__).resolve().parent / "csrc" / "thunder_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
BUILD_TIMEOUT_S = 600


class _TnAudio(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_float)),
        ("channels", ctypes.c_int32),
        ("frames", ctypes.c_int64),
        ("sample_rate", ctypes.c_int32),
    ]


def library_path(src: Path = None, build_dir: Path = None) -> Path:
    """Where the library built from ``src`` (default :data:`SRC`) lives: named after a hash of the source and the
    flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(Path(SRC if src is None else src).read_bytes())
    return Path(BUILD_DIR if build_dir is None else build_dir) / f"libthunder_native_{digest.hexdigest()[:16]}.so"


def build(src: Path = None, build_dir: Path = None) -> Path:
    """Compile ``src`` (default :data:`SRC`) unless a library of the same hash exists; return its path.

    Raises ``RuntimeError`` when ``g++`` is missing or fails. Under an exclusive
    lock on ``build_dir/.native.lock`` a second process waits for the first one's
    build and then finds it; the output is written to a temporary name and
    renamed, so no process ever loads a partial file.
    """
    src, build_dir = Path(SRC if src is None else src), Path(BUILD_DIR if build_dir is None else build_dir)
    out = library_path(src, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native runtime of thunder_tpu_torch is built with g++ on first use")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}) on {src}:\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


_lock = threading.Lock()
_lib = None
#: library path -> why its build failed, in this process only (a new source hashes to a new path)
_failed = {}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i32p, c_i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    c_f32p, c_f64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
    i32, i64, f32, f64, vp, cp = (ctypes.c_int32, ctypes.c_int64, ctypes.c_float, ctypes.c_double, ctypes.c_void_p,
                                  ctypes.c_char_p)
    signatures = {
        "tn_load_wav": ([cp, ctypes.POINTER(_TnAudio)], ctypes.c_int),
        "tn_load_flac": ([cp, ctypes.POINTER(_TnAudio)], ctypes.c_int),
        "tn_free_audio": ([ctypes.POINTER(_TnAudio)], None),
        "tn_wav_info": ([cp, c_i64p, c_i32p, c_i32p, c_i32p], ctypes.c_int),
        "tn_resample": ([c_f32p, i64, c_f32p, i64, i32, i32, i32], ctypes.c_int),
        "tn_edit_distance": ([c_i32p, i64, c_i32p, i64], i64),
        "tn_ctc_collapse": ([c_i32p, i64, c_i32p], i64),
        "tn_ctc_beam_search_lm": ([c_f32p, i64, i64, i32, i32, f32, i32, vp, f64, c_i32p, i64, c_f64p], i64),
        "tn_ctc_beam_search_stream_lm": ([c_f32p, i64, i64, i32, i32, f32, i32, vp, f64, c_i32p, c_i32p, c_f64p,
                                          c_f64p, i32, i64, c_i32p, c_i32p, c_f64p, c_f64p, i64], i64),
        "tn_ctc_beam_search_batch": ([c_f32p, i64, i64, i64, c_i64p, i32, i32, f32, i32, vp, f64, c_i32p, i64,
                                      c_i64p, i32], i64),
        "tn_lm_create": ([i32, f64, f64], vp),
        "tn_lm_add": ([vp, c_i32p, c_i64p, i64, i32], ctypes.c_int),
        "tn_lm_create_arpa": ([i32, f64, i32], vp),
        "tn_lm_add_arpa": ([vp, c_i32p, c_f64p, c_f64p, i64, i32], ctypes.c_int),
        "tn_lm_finalize": ([vp], ctypes.c_int),
        "tn_lm_free": ([vp], None),
        "tn_lm_score": ([vp, c_i32p, i32, i32], f64),
        "tn_wfusion_create": ([vp, i32, i32, i32, i32, f64, cp, c_i64p, i32, cp, c_i64p, i32, cp, c_i64p, c_f64p, i32],
                              vp),
        "tn_wfusion_free": ([vp], None),
        "tn_spm_create": ([cp, c_i64p, c_f64p, i32, f64], vp),
        "tn_spm_free": ([vp], None),
        "tn_spm_encode": ([vp, cp, i64, c_i32p, c_i32p, i64], i64),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built on first call; ``ImportError`` when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if path in _failed:
                raise ImportError(_failed[path])
            try:
                built = build()
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                _failed[path] = f"thunder_tpu_torch native library unavailable: {e}"
                raise ImportError(_failed[path]) from e
            _lib = _bind(ctypes.CDLL(str(built)))
        return _lib


def native_available() -> bool:
    """Whether the native library loads (building it if needed)."""
    try:
        load()
    except ImportError:
        return False
    return True


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def _audio_of(status: int, audio: _TnAudio, what: str, path) -> Tuple[np.ndarray, int]:
    lib = load()
    if status != 0:
        raise ValueError(f"native {what} decode failed ({status}) for {path}")
    try:
        n = audio.channels * audio.frames
        flat = np.ctypeslib.as_array(audio.data, shape=(n,)).copy()
        return flat.reshape(audio.channels, audio.frames), int(audio.sample_rate)
    finally:
        lib.tn_free_audio(ctypes.byref(audio))


def native_load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file -> ((channels, frames) float32, sample_rate)."""
    audio = _TnAudio()
    return _audio_of(load().tn_load_wav(str(path).encode(), ctypes.byref(audio)), audio, "wav", path)


def native_load_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> ((channels, frames) float32, sample_rate)."""
    audio = _TnAudio()
    return _audio_of(load().tn_load_flac(str(path).encode(), ctypes.byref(audio)), audio, "flac", path)


def native_wav_info(path: str):
    """``(frames, rate, channels, bits)`` from a WAV header; frames are those the file holds."""
    frames, rate, channels, bits = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = load().tn_wav_info(str(path).encode(), frames, rate, channels, bits)
    if rc != 0:
        raise ValueError(f"native wav info failed ({rc}) for {path}")
    return frames.value, rate.value, channels.value, bits.value


def native_resample(x: np.ndarray, up: int, down: int, zeros: int = 16) -> np.ndarray:
    """Polyphase windowed-sinc resample of a 1-D float32 signal."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n_out = -(-x.shape[-1] * up // down)
    y = np.empty(n_out, dtype=np.float32)
    rc = load().tn_resample(_ptr(x, ctypes.c_float), x.shape[-1], _ptr(y, ctypes.c_float), n_out, up, down, zeros)
    if rc != 0:
        raise ValueError("native resample failed")
    return y


def native_edit_distance(a, b) -> int:
    """Levenshtein distance between two sequences (str or int sequences)."""
    ai = np.asarray([ord(c) for c in a] if isinstance(a, str) else a, dtype=np.int32)
    bi = np.asarray([ord(c) for c in b] if isinstance(b, str) else b, dtype=np.int32)
    return int(load().tn_edit_distance(_ptr(ai, ctypes.c_int32), len(ai), _ptr(bi, ctypes.c_int32), len(bi)))


def native_ctc_collapse(ids: np.ndarray) -> np.ndarray:
    """Drop consecutive duplicates from a 1-D int32 id sequence."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    out = np.empty_like(ids)
    m = load().tn_ctc_collapse(_ptr(ids, ctypes.c_int32), len(ids), _ptr(out, ctypes.c_int32))
    return out[:m].copy()


class NativeNGramLM:
    """Owned handle to a C++ n-gram LM (tn_lm_* ABI): stupid backoff over counts, or Katz backoff over ARPA
    entries (:meth:`from_arpa_tables`).

    Built from :class:`thunder_tpu_torch.text.lm.NGramLM`'s count tables (or ``ArpaLM``'s) so the C++ beam
    search fuses LM scores without calling back into Python per extension.
    """

    def __init__(self, order: int, backoff: float, oov_logp: float):
        self._lib = load()
        self._handle = self._lib.tn_lm_create(int(order), float(backoff), float(oov_logp))
        if not self._handle:
            raise ValueError("tn_lm_create failed (order must be >= 1, backoff > 0)")

    @classmethod
    def from_counts(cls, order: int, backoff: float, oov_logp: float, counts_by_len):
        """Build from ``{gram_len: {gram_tuple: count}}`` (NGramLM._counts)."""
        lm = cls(order, backoff, oov_logp)
        for gram_len, table in counts_by_len.items():
            if not table:
                continue
            grams = np.ascontiguousarray(list(table.keys()), dtype=np.int32)
            counts = np.ascontiguousarray(list(table.values()), dtype=np.int64)
            rc = lm._lib.tn_lm_add(lm._handle, _ptr(grams, ctypes.c_int32), _ptr(counts, ctypes.c_int64),
                                   len(counts), int(gram_len))
            if rc != 0:
                raise ValueError(f"tn_lm_add failed ({rc}) for gram_len={gram_len}")
        if lm._lib.tn_lm_finalize(lm._handle) != 0:
            raise ValueError("tn_lm_finalize failed")
        return lm

    @classmethod
    def from_arpa_tables(cls, order: int, unk_logp: float, unk_id: int, tables):
        """Build a Katz-backoff (ARPA-mode) scorer from ArpaLM's tables:
        ``{gram_len: {gram_tuple: (ln_p, ln_bow)}}``."""
        lm = cls.__new__(cls)
        lm._lib = load()
        lm._handle = lm._lib.tn_lm_create_arpa(int(order), float(unk_logp), int(unk_id))
        if not lm._handle:
            raise ValueError("tn_lm_create_arpa failed (order must be >= 1)")
        for gram_len, table in tables.items():
            if not table:
                continue
            grams = np.ascontiguousarray(list(table.keys()), dtype=np.int32)
            vals = np.asarray(list(table.values()), dtype=np.float64)
            logps = np.ascontiguousarray(vals[:, 0])
            bows = np.ascontiguousarray(vals[:, 1])
            rc = lm._lib.tn_lm_add_arpa(lm._handle, _ptr(grams, ctypes.c_int32), _ptr(logps, ctypes.c_double),
                                        _ptr(bows, ctypes.c_double), len(logps), int(gram_len))
            if rc != 0:
                raise ValueError(f"tn_lm_add_arpa failed ({rc}) for gram_len={gram_len}")
        return lm

    def score(self, context, token: int) -> float:
        ctx = np.ascontiguousarray(context, dtype=np.int32)
        return float(self._lib.tn_lm_score(self._handle, _ptr(ctx, ctypes.c_int32), len(ctx), int(token)))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tn_lm_free(handle)
            self._handle = None


def _strings_blob(strings):
    """Concatenate strings into a UTF-8 blob + int64 offsets (n+1 entries)."""
    encoded = [s.encode("utf-8") for s in strings]
    offsets = np.zeros((len(encoded) + 1,), np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


class NativeSpmEncoder:
    """Owned handle to the C++ unigram Viterbi encoder (tn_spm_*).

    Mirror of ``SentencePieceModel._encode_unigram_py`` (the same dynamic programme and tie-break, the same
    spans); built from the model's indexable pieces by ``SentencePieceModel``.
    """

    def __init__(self, pieces, scores, unk_score: float):
        self._lib = load()
        blob, offsets = _strings_blob(pieces)
        sc = np.asarray(scores, np.float64)
        self._handle = self._lib.tn_spm_create(blob, _ptr(offsets, ctypes.c_int64), _ptr(sc, ctypes.c_double),
                                               len(pieces), float(unk_score))
        if not self._handle:
            raise ValueError("tn_spm_create failed")

    def encode_spans(self, normalized_text: str):
        """Byte spans of the Viterbi pieces over normalized UTF-8 text, or
        ``None`` on error (caller falls back to the Python DP)."""
        raw = normalized_text.encode("utf-8")
        cap = len(raw) + 1
        starts = np.empty((cap,), np.int32)
        ends = np.empty((cap,), np.int32)
        n = self._lib.tn_spm_encode(self._handle, raw, len(raw), _ptr(starts, ctypes.c_int32),
                                    _ptr(ends, ctypes.c_int32), cap)
        if n < 0:
            return None
        return [raw[starts[i] : ends[i]].decode("utf-8") for i in range(n)]

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tn_spm_free(handle)
            self._handle = None


class NativeWordFusion:
    """Owned handle to the C++ word-level fusion config (tn_wfusion_*).

    Wraps a word LM's :class:`NativeNGramLM` (kept alive by reference) plus
    the acoustic token vocabulary, so the beam search scores completed words
    entirely in C++. Built by ``WordFusionLM.native()``.
    """

    def __init__(self, word_lm_native, style: str, space_id: int, bos_id: int,
                 unk_id: int, pieces, words, word_score: float = 0.0, hotwords=None):
        self._lib = load()
        self._word_lm = word_lm_native  # lifetime: C++ keeps a borrowed pointer
        pieces_blob, piece_off = _strings_blob(pieces)
        words_blob, word_off = _strings_blob(words)
        hotwords = dict(hotwords or {})
        hw_blob, hw_off = _strings_blob(list(hotwords.keys()))
        hw_boosts = np.asarray(list(hotwords.values()), np.float64)
        self._handle = self._lib.tn_wfusion_create(
            word_lm_native._handle if word_lm_native is not None else None,
            {"char": 0, "sentencepiece": 1}[style],
            int(space_id),
            int(bos_id),
            int(unk_id),
            float(word_score),
            pieces_blob,
            _ptr(piece_off, ctypes.c_int64),
            len(pieces),
            words_blob,
            _ptr(word_off, ctypes.c_int64),
            len(words),
            hw_blob,
            _ptr(hw_off, ctypes.c_int64),
            _ptr(hw_boosts, ctypes.c_double),
            len(hotwords),
        )
        if not self._handle:
            raise ValueError("tn_wfusion_create failed")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tn_wfusion_free(handle)
            self._handle = None


def _prune(prune_logp: float) -> float:
    # -inf as the most negative finite float, for portability; the C++ side compares with >=, so the
    # effect is identical either way
    pl = float(prune_logp)
    return -3.0e38 if pl == float("-inf") else pl


def _library_or_none():
    try:
        return load()
    except ImportError:
        return None


def native_ctc_beam_search(
    logp: np.ndarray,
    blank: int,
    beam_width: int = 16,
    prune_logp: float = float("-inf"),
    max_tokens_per_step: int = 0,
    return_score: bool = False,
    lm: "NativeNGramLM" = None,
    lm_weight: float = 0.0,
):
    """CTC prefix beam search over one utterance's (T, V) log-softmax.

    Returns the best collapsed label sequence (int32 array), optionally with
    its total log-probability; ``None`` if the native library is missing or
    errors (callers fall back to the numpy reference in ops/ctc_beam.py).
    ``lm`` (a :class:`NativeNGramLM` or :class:`NativeWordFusion`) fuses
    shallow LM scores in C++.
    """
    lib = _library_or_none()
    if lib is None:
        return None
    logp = np.ascontiguousarray(logp, dtype=np.float32)
    t, v = logp.shape
    out = np.empty((t + 1,), np.int32)
    score = ctypes.c_double(0.0)
    n = lib.tn_ctc_beam_search_lm(
        _ptr(logp, ctypes.c_float), t, v, int(blank), int(beam_width), _prune(prune_logp),
        int(max_tokens_per_step or 0), lm._handle if lm is not None else None, float(lm_weight),
        _ptr(out, ctypes.c_int32), len(out), ctypes.byref(score),
    )
    if n < 0:
        return None
    ids = out[:n].copy()
    return (ids, score.value) if return_score else ids


def native_ctc_beam_search_batch(
    logp: np.ndarray,
    lengths,
    blank: int,
    beam_width: int = 16,
    prune_logp: float = float("-inf"),
    max_tokens_per_step: int = 0,
    lm: "NativeNGramLM" = None,
    lm_weight: float = 0.0,
    n_threads: int = 0,
):
    """Batched CTC prefix beam search over (B, T, V) log-softmax, threaded
    over samples in C++ (n_threads <= 0 uses all cores).

    Returns a list of B best label sequences (int32 arrays), or ``None`` if
    the native library is missing or any sample fails (callers fall back to
    the per-sample numpy reference).
    """
    lib = _library_or_none()
    if lib is None:
        return None
    logp = np.ascontiguousarray(logp, dtype=np.float32)
    b, t, v = logp.shape
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    out_stride = t + 1
    out = np.empty((b, out_stride), np.int32)
    out_lens = np.empty((b,), np.int64)
    rc = lib.tn_ctc_beam_search_batch(
        _ptr(logp, ctypes.c_float), b, t, v, _ptr(lens, ctypes.c_int64), int(blank), int(beam_width),
        _prune(prune_logp), int(max_tokens_per_step or 0), lm._handle if lm is not None else None,
        float(lm_weight), _ptr(out, ctypes.c_int32), out_stride, _ptr(out_lens, ctypes.c_int64), int(n_threads),
    )
    if rc != 0 or (out_lens < 0).any():
        return None
    return [out[i, : out_lens[i]].copy() for i in range(b)]


def native_ctc_beam_search_stream(
    logp: np.ndarray,
    blank: int,
    beam_width: int = 16,
    prune_logp: float = float("-inf"),
    max_tokens_per_step: int = 0,
    in_beams=None,
    lm: "NativeNGramLM" = None,
    lm_weight: float = 0.0,
):
    """Advance carried prefix-beam state over one (T, V) log-softmax window.

    ``in_beams``: list of ``(prefix int32 array, pb, pnb)`` carried from the
    previous window (``None``/empty seeds the root beam). Returns the
    surviving beams best-first in the same format, or ``None`` if the native
    library is missing or errors (callers fall back to the numpy reference).
    ``lm`` fuses shallow LM scores in C++, seeing the full carried prefix as
    context.
    """
    lib = _library_or_none()
    if lib is None:
        return None
    logp = np.ascontiguousarray(logp, dtype=np.float32)
    t, v = logp.shape
    in_beams = list(in_beams or [])
    n_in = len(in_beams)
    in_stride = max((len(p) for p, _, _ in in_beams), default=0) or 1
    rows = max(n_in, 1)
    in_prefixes = np.zeros((rows, in_stride), np.int32)
    in_lens = np.zeros((rows,), np.int32)
    in_pb = np.zeros((rows,), np.float64)
    in_pnb = np.zeros((rows,), np.float64)
    for i, (p, pb, pnb) in enumerate(in_beams):
        p = np.asarray(p, np.int32)
        in_prefixes[i, : len(p)] = p
        in_lens[i] = len(p)
        in_pb[i], in_pnb[i] = pb, pnb
    # a window of T frames can extend a prefix by at most T tokens
    out_stride = in_stride + t + 1
    out_prefixes = np.empty((beam_width, out_stride), np.int32)
    out_lens = np.empty((beam_width,), np.int32)
    out_pb = np.empty((beam_width,), np.float64)
    out_pnb = np.empty((beam_width,), np.float64)
    n = lib.tn_ctc_beam_search_stream_lm(
        _ptr(logp, ctypes.c_float), t, v, int(blank), int(beam_width), _prune(prune_logp),
        int(max_tokens_per_step or 0), lm._handle if lm is not None else None, float(lm_weight),
        _ptr(in_prefixes, ctypes.c_int32), _ptr(in_lens, ctypes.c_int32), _ptr(in_pb, ctypes.c_double),
        _ptr(in_pnb, ctypes.c_double), n_in, in_stride, _ptr(out_prefixes, ctypes.c_int32),
        _ptr(out_lens, ctypes.c_int32), _ptr(out_pb, ctypes.c_double), _ptr(out_pnb, ctypes.c_double), out_stride,
    )
    if n < 0:
        return None
    return [
        (out_prefixes[i, : out_lens[i]].copy(), float(out_pb[i]), float(out_pnb[i]))
        for i in range(n)
    ]
