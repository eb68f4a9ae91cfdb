"""The rest of the port's ``data/audio_io.py`` against the JAX package's (CPU).

- FLAC through ``load_audio`` (the native decoder) and ``audio_info`` (STREAMINFO, and a full decode when it
  gives no length): equal to the JAX package's, bit for bit;
- WAV through ``load_audio`` is read by the Python reader alone, without the native runtime, and equals the native
  decoder's samples;
- the MP3 and Ogg header parsers on synthetic headers and on the real files ``tests/test_mp3.py`` uses (skipped
  where absent, as there); the decode-hook chain on those files where a backend is installed, and its error when
  none works;
- ``resample``'s native fallback where scipy is missing, equal to the JAX package's.
"""

import builtins
import importlib.util
from dataclasses import astuple

import numpy as np
import pytest

import thunder_tpu.data.audio_io as jax_audio_io
import thunder_tpu_torch.data.audio_io as audio_io
import thunder_tpu_torch.native as native
from tests.flac_writer import write_flac
from tests.test_mp3 import MP3_V1, MP3_V25, OGG_FIXTURE
from tests.test_torch_data import PCM, _signal, wav_bytes
from thunder_tpu_torch.data import AudioFileLoader, audio_info, load_audio

needs_backend = pytest.mark.skipif(
    not any(importlib.util.find_spec(m) for m in ("soundfile", "torchaudio", "pygame")),
    reason="no compressed-audio backend installed",
)


def _flac(path, channels=1, n=4096, **kw):
    rng = np.random.default_rng(channels + n)
    t = np.arange(n) / 16000
    samples = np.stack([np.clip((0.3 * np.sin(2 * np.pi * (200 + 70 * c) * t) + 0.03 * rng.standard_normal(n))
                                * 32767, -32768, 32767) for c in range(channels)]).astype(np.int64)
    write_flac(str(path), samples, **kw)
    return samples


@pytest.mark.parametrize("kw", [dict(kind="fixed2"), dict(kind="lpc", blocksize=1024),
                                dict(kind="fixed1", stereo_mode="mid_side")], ids=["fixed2", "lpc", "mid_side"])
def test_flac_load_and_info_match_jax(tmp_path, kw):
    path = tmp_path / "a.flac"
    samples = _flac(path, channels=2 if "stereo_mode" in kw else 1, **kw)
    got, rate = load_audio(path)
    want, want_rate = jax_audio_io.load_audio(path)
    assert rate == want_rate == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (samples / 32768.0).astype(np.float32))
    assert astuple(audio_info(path)) == astuple(jax_audio_io.audio_info(path))


def test_flac_without_a_length_is_decoded_for_its_info(tmp_path):
    path = tmp_path / "open.flac"
    _flac(path, n=3000)
    blob = bytearray(path.read_bytes())
    blob[21] &= 0xF0  # STREAMINFO's 36-bit total: 0, "unknown"
    blob[22:26] = bytes(4)
    path.write_bytes(bytes(blob))
    info = audio_info(path)
    assert astuple(info) == astuple(jax_audio_io.audio_info(path)) and info.num_frames == 3000


def test_wav_is_read_by_the_python_reader(tmp_path, monkeypatch):
    path = tmp_path / "a.wav"
    path.write_bytes(wav_bytes(_signal(500, 2), 16000, PCM, 16))
    native_samples, _ = native.native_load_wav(str(path))

    def refuse(*args):
        raise AssertionError("load_audio reached the native runtime for a WAV file")

    for name in ("native_available", "native_load_wav", "load"):
        monkeypatch.setattr(native, name, refuse)
    got, rate = load_audio(path)
    assert rate == 16000
    np.testing.assert_array_equal(got, jax_audio_io.load_audio(path)[0])
    np.testing.assert_array_equal(got, native_samples)


def test_synthetic_mp3_and_ogg_headers_match_jax(tmp_path):
    for hdr in (bytes([0xFF, 0xFB, 0x90, 0x00]), bytes([0xFF, 0xE3, 0x48, 0xC0]), b"\x00\x00\x00\x00",
                bytes([0xFF, 0xFB, 0xF0, 0x00]), bytes([0xFF, 0xF3, 0x64, 0x40])):
        assert audio_io._mp3_frame_at(hdr, 0) == jax_audio_io._mp3_frame_at(hdr, 0)
    tag = b"ID3\x04\x00\x00\x00\x00\x02\x01" + b"x" * 0x101
    assert audio_io._mp3_skip_id3(tag) == jax_audio_io._mp3_skip_id3(tag) == 10 + 0x101
    frame = bytes([0xFF, 0xFB, 0x90, 0x00]) + bytes(413)
    cbr = tmp_path / "cbr.mp3"
    cbr.write_bytes(tag + frame * 40)
    assert astuple(audio_info(cbr)) == astuple(jax_audio_io.audio_info(cbr))
    payload = b"\x01vorbis" + bytes(4) + bytes([2]) + (22050).to_bytes(4, "little") + bytes(16)
    page0 = b"OggS" + bytes([0, 2]) + bytes(8) + bytes(12) + bytes([1, len(payload)]) + payload
    last = b"OggS" + bytes([0, 4]) + (44100).to_bytes(8, "little") + bytes(12) + bytes([1, 0])
    ogg = tmp_path / "x.ogg"
    ogg.write_bytes(page0 + last)
    assert astuple(audio_info(ogg)) == astuple(jax_audio_io.audio_info(ogg))
    assert (audio_info(ogg).sample_rate, audio_info(ogg).num_frames) == (22050, 44100)


@pytest.mark.parametrize("path", [MP3_V1, MP3_V25, OGG_FIXTURE], ids=["mp3_v1", "mp3_v25", "ogg"])
def test_real_file_headers_match_jax(path):
    if not path.exists():
        pytest.skip("fixture not on disk")
    assert astuple(audio_info(path)) == astuple(jax_audio_io.audio_info(path))
    if path.suffix == ".mp3":
        assert astuple(audio_io._parse_mp3_info(str(path))) == astuple(jax_audio_io._parse_mp3_info(str(path)))
        assert audio_io._mp3_first_frame(str(path))[2] == jax_audio_io._mp3_first_frame(str(path))[2]
    else:
        assert astuple(audio_io._parse_ogg_info(str(path))) == astuple(jax_audio_io._parse_ogg_info(str(path)))


@needs_backend
@pytest.mark.parametrize("path", [MP3_V1, MP3_V25, OGG_FIXTURE], ids=["mp3_v1", "mp3_v25", "ogg"])
def test_hook_chain_decodes_like_jax(path):
    if not path.exists():
        pytest.skip("fixture not on disk")
    got, rate = load_audio(path)
    want, want_rate = jax_audio_io.load_audio(path)
    assert rate == want_rate and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    loader = AudioFileLoader(force_mono=True, sample_rate=16000)
    np.testing.assert_array_equal(loader(path), jax_audio_io.AudioFileLoader(force_mono=True, sample_rate=16000)(path))


def test_hookless_error_is_informative(tmp_path, monkeypatch):
    path = tmp_path / "x.mp3"
    path.write_bytes(bytes([0xFF, 0xFB, 0x90, 0x00]) + bytes(400))
    monkeypatch.setattr(audio_io, "_DECODE_HOOKS", ())
    with pytest.raises(ValueError, match="no compressed-audio backend succeeded"):
        load_audio(path)

    def missing(p):
        raise ImportError("nope")

    monkeypatch.setattr(audio_io, "_DECODE_HOOKS", (("soundfile", missing),))
    with pytest.raises(ValueError, match="soundfile: not installed"):
        load_audio(path)


@pytest.mark.parametrize("orig,new", [(8000, 16000), (44100, 16000), (48000, 16000)])
def test_resample_falls_back_to_the_native_sinc_without_scipy(monkeypatch, orig, new):
    audio = _signal(orig // 20, 2, seed=5).T.astype(np.float32)
    real_import = builtins.__import__

    def no_scipy(name, *args, **kwargs):
        if name.startswith("scipy"):
            raise ImportError("scipy is hidden")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_scipy)
    got, want = audio_io.resample(audio, orig, new), jax_audio_io.resample(audio, orig, new)
    monkeypatch.undo()
    assert got.shape == want.shape == (2, -(-audio.shape[1] * new // orig))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, audio_io.resample(audio, orig, new)[:, : got.shape[1]])  # scipy's is another
