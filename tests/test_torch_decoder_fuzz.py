"""Decoder robustness of the port: corrupted and truncated audio bytes must never crash or lie (CPU).

Port of ``tests/test_decoder_fuzz.py`` over ``thunder_tpu_torch.data.audio_io``, whose WAV and FLAC decoders are
the port's C++ runtime (and its Python WAV reader). Every mutated input must either raise a clean Python exception
or decode to an array that honours two bounds, each of which can fail (``test_the_bounds_can_fail``):

- integer PCM (WAV format 1, and FLAC) decodes into [-1, 1];
- the frames decoded, and the frames a WAV header reports, fit in the file's bytes: at least one byte a sample
  after a 44-byte WAV header (the header's own bytes a sample for ``audio_info``), and at most 65,536 samples a
  channel for each 10 bytes of FLAC frames after the 42 bytes of its magic and STREAMINFO (a frame's header,
  smallest subframe and CRC take 10 bytes at least).

The source test's last assert (``np.isfinite(...).all() or True``) could not fail. Here the JAX package's
``audio_info`` fails the frame bound on the length-field corpus, and its FLAC decoder the range bound on the
byte-flip corpus (it returns corrupt frames' samples past [-1, 1]; the port's refuses them). The corpus is the
source test's: seeded, about 500 mutants a format.
"""

import numpy as np
import pytest

from thunder_tpu.data import audio_io as jax_audio_io
from thunder_tpu_torch.data import audio_io
from tests.flac_writer import write_flac

# every acceptable failure mode; anything else (IndexError, struct.error, MemoryError, ...) is a parser bug
CLEAN_ERRORS = (ValueError, OSError, RuntimeError, EOFError)

# a 4 kB input decodes to no more than this many samples in the seeded corpus (the source test's bound)
MAX_ELEMENTS = 4_000_000
WAV_HEADER_BYTES, FLAC_HEADER_BYTES, FLAC_FRAME_BYTES, FLAC_MAX_BLOCK = 44, 42, 10, 65536


def _max_frames(blob: bytes, channels: int, bytes_per_sample: int = 1) -> int:
    """The most frames a file of these bytes can hold."""
    if blob[:4] == b"fLaC":
        return FLAC_MAX_BLOCK * max(len(blob) - FLAC_HEADER_BYTES, 0) // FLAC_FRAME_BYTES
    return max(len(blob) - WAV_HEADER_BYTES, 0) // (max(channels, 1) * max(bytes_per_sample, 1))


def _integer_pcm(path, blob: bytes) -> bool:
    if blob[:4] == b"fLaC":
        return True
    try:
        return audio_io._parse_wav_header(str(path))[3] == audio_io.WAVE_FORMAT_PCM
    except CLEAN_ERRORS:
        return False


def _check_one(tmp_path, blob: bytes, name: str, load=audio_io.load_audio, info=audio_io.audio_info):
    path = tmp_path / name
    path.write_bytes(blob)
    try:
        audio, _ = load(path)
    except CLEAN_ERRORS:
        audio = None
    if audio is not None:
        assert audio.ndim == 2, (name, audio.shape)
        assert audio.size <= MAX_ELEMENTS, (name, audio.shape)
        assert audio.shape[1] <= _max_frames(blob, audio.shape[0]), (name, audio.shape, len(blob))
        if _integer_pcm(path, blob):
            assert np.all(np.abs(audio) <= 1.0), (name, float(np.nanmax(np.abs(audio))))
    if blob[:4] != b"RIFF":
        return
    try:
        meta = info(path)
    except CLEAN_ERRORS:
        return
    bound = _max_frames(blob, meta.num_channels, meta.bits_per_sample // 8)
    assert meta.num_frames <= bound, (name, meta.num_frames, bound)


def _wav_bytes() -> bytes:
    import io
    import wave

    rng = np.random.default_rng(7)
    data = np.clip(rng.standard_normal(1500) * 0.3, -1, 1)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        inter = np.stack([data, -data], axis=1)
        w.writeframes((inter * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _flac_bytes(tmp_path_factory, kind: str) -> bytes:
    rng = np.random.default_rng(11)
    samples = (rng.standard_normal((1, 2000)) * 8000).astype(np.int64)
    path = tmp_path_factory.mktemp("flac") / "x.flac"
    write_flac(str(path), samples, blocksize=512, kind=kind)
    return path.read_bytes()


@pytest.fixture(scope="module")
def wav_blob():
    return _wav_bytes()


@pytest.fixture(scope="module", params=["lpc", "fixed2"])
def flac_blob(request, tmp_path_factory):
    return _flac_bytes(tmp_path_factory, request.param)


def test_wav_truncations(tmp_path, wav_blob):
    # every header byte boundary + strided body truncations
    for n in list(range(0, 64)) + list(range(64, len(wav_blob), 101)):
        _check_one(tmp_path, wav_blob[:n], f"t{n}.wav")


def test_flac_truncations(tmp_path, flac_blob):
    for n in list(range(0, 64)) + list(range(64, len(flac_blob), 73)):
        _check_one(tmp_path, flac_blob[:n], f"t{n}.flac")


def test_wav_byte_flips(tmp_path, wav_blob):
    rng = np.random.default_rng(0)
    for i in range(300):
        pos = int(rng.integers(0, len(wav_blob)))
        # bias half the mutations into the header region where the fields live
        if i % 2 == 0:
            pos = int(rng.integers(0, 64))
        mutated = bytearray(wav_blob)
        mutated[pos] = int(rng.integers(0, 256))
        _check_one(tmp_path, bytes(mutated), f"f{i}.wav")


def _flac_flips(flac_blob):
    rng = np.random.default_rng(1)
    for i in range(300):
        pos = int(rng.integers(0, len(flac_blob)))
        if i % 2 == 0:
            pos = int(rng.integers(0, 64))
        mutated = bytearray(flac_blob)
        mutated[pos] = int(rng.integers(0, 256))
        yield i, bytes(mutated)


def test_flac_byte_flips(tmp_path, flac_blob):
    for i, mutated in _flac_flips(flac_blob):
        _check_one(tmp_path, mutated, f"f{i}.flac")


LENGTH_FIELDS = [(off, val) for off in (4, 16, 40) for val in (0, 1, 2**31 - 1, 2**32 - 1, 2**32 - 9, 0x7FFFFFF0)]


def _length_mutant(wav_blob, off, val) -> bytes:
    mutated = bytearray(wav_blob)
    mutated[off : off + 4] = int(val).to_bytes(4, "little")
    return bytes(mutated)


def test_wav_length_field_corruption(tmp_path, wav_blob):
    """Chunk-size fields (RIFF size, fmt size, data size) set to every hostile value class."""
    for off, val in LENGTH_FIELDS:
        _check_one(tmp_path, _length_mutant(wav_blob, off, val), f"len{off}_{val}.wav")


def test_wav_hostile_fmt_fields(tmp_path, wav_blob):
    """bits/channels values that break the frame-size arithmetic."""
    for off, vals in (
        (22, (0, 1, 7, 255, 65535)),  # channels
        (34, (0, 1, 4, 7, 12, 17, 63, 64, 65535)),  # bits per sample
        (20, (0, 2, 3, 0xFFFE, 65535)),  # format tag
    ):
        for val in vals:
            mutated = bytearray(wav_blob)
            mutated[off : off + 2] = int(val).to_bytes(2, "little")
            _check_one(tmp_path, bytes(mutated), f"fmt{off}_{val}.wav")


def test_magic_prefixed_garbage(tmp_path):
    rng = np.random.default_rng(2)
    for i in range(60):
        body = rng.integers(0, 256, size=int(rng.integers(0, 400)), dtype=np.uint8).tobytes()
        _check_one(tmp_path, b"RIFF" + body, f"g{i}.wav")
        _check_one(tmp_path, b"fLaC" + body, f"g{i}.flac")
        # RIFF....WAVE with garbage chunks
        _check_one(tmp_path, b"RIFF" + body[:4].ljust(4) + b"WAVE" + body, f"gw{i}.wav")


def test_flac_streaminfo_total_samples_lies(tmp_path, flac_blob):
    """A 36-bit total_samples claiming 2^35 must not drive allocation."""
    mutated = bytearray(flac_blob)
    # STREAMINFO: 4 magic + 4 blockheader + 10 bytes -> total_samples spans bytes 21..25 (low 4 bits of 21)
    for b in range(21, 26):
        mutated[b] = 0xFF
    _check_one(tmp_path, bytes(mutated), "huge.flac")


def test_the_bounds_can_fail(tmp_path, wav_blob, flac_blob):
    """Each bound trips on a decoder that breaks it: samples past [-1, 1] from integer PCM, more frames than the
    bytes hold, the JAX package's ``audio_info``, which reports a data chunk's claimed size, and the JAX package's
    FLAC decoder, which returns the samples of corrupt frames past [-1, 1] (the port's refuses them)."""
    jax_failures = 0
    for i, mutated in _flac_flips(flac_blob):
        try:
            _check_one(tmp_path, mutated, f"j{i}.flac", load=jax_audio_io.load_audio, info=jax_audio_io.audio_info)
        except AssertionError:
            jax_failures += 1
    assert jax_failures > 0
    loud = lambda p: (np.full((2, 10), 1.5, np.float32), 16000)  # noqa: E731
    with pytest.raises(AssertionError):
        _check_one(tmp_path, wav_blob, "loud.wav", load=loud)
    long = lambda p: (np.zeros((2, len(wav_blob)), np.float32), 16000)  # noqa: E731
    with pytest.raises(AssertionError):
        _check_one(tmp_path, wav_blob, "long.wav", load=long)
    with pytest.raises(AssertionError):
        _check_one(tmp_path, _length_mutant(wav_blob, 40, 2**31 - 1), "lying.wav", info=jax_audio_io.audio_info)
    _check_one(tmp_path, _length_mutant(wav_blob, 40, 2**31 - 1), "lying.wav")  # the port's reader clamps it
