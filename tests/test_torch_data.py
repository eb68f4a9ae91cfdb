"""The port's WAV reader, datasets, collation and loader against the JAX package's (CPU).

- WAV at 8, 16, 24 and 32 bits PCM and 32 and 64 bits IEEE float, mono and stereo (and
  WAVE_FORMAT_EXTENSIBLE), decoded bit-equal to the JAX package's Python parser, header fields equal;
- ``resample`` and ``AudioFileLoader`` equal to JAX's (the same scipy call);
- the loader's batches and their order equal to JAX's ``DataLoader`` over two epochs, with and
  without ``shuffle`` and ``drop_last``, with durations from the manifest and from the headers;
  ``ManifestDatamodule`` and ``asr_collate`` likewise;
- the two faults of the JAX parser are not in the port: a data chunk whose size passes the file's end is
  read to the file's end in whole frames (C6), and every invalid (format, bit depth) pair raises (C7);
- truncated FLAC, Ogg and MP3 headers raise ``ValueError`` with the JAX package's messages.
"""

import json
import struct

import numpy as np
import pytest

from thunder_tpu.data import audio_io as jax_audio_io
from thunder_tpu.data.collate import asr_collate as jax_asr_collate
from thunder_tpu.data.datamodule import DataLoader as JaxDataLoader
from thunder_tpu.data.datamodule import ManifestDatamodule as JaxManifestDatamodule
from thunder_tpu.data.dataset import ManifestSpeechDataset as JaxManifestDataset
from thunder_tpu_torch.data import (
    AudioFileLoader,
    DataLoader,
    ManifestDatamodule,
    ManifestSpeechDataset,
    asr_collate,
    audio_info,
    load_audio,
    resample,
)
from thunder_tpu_torch.utils import audio_len

PCM, FLOAT, EXTENSIBLE = 1, 3, 0xFFFE


def wav_bytes(samples: np.ndarray, rate: int, fmt: int, bits: int, extensible: bool = False,
              data_size: int = None, extra_chunk: bool = True) -> bytes:
    """A RIFF/WAVE file of ``samples`` ((frames, channels) in [-1, 1)) at ``bits`` in format ``fmt``;
    ``data_size`` overrides the data chunk's declared size."""
    frames, channels = samples.shape
    if fmt == FLOAT:
        raw = samples.astype(np.float32 if bits == 32 else np.float64).tobytes()
    elif bits == 8:
        raw = np.clip(np.round(samples * 128 + 128), 0, 255).astype(np.uint8).tobytes()
    elif bits == 24:
        v = np.clip(np.round(samples * 2**23), -2**23, 2**23 - 1).astype(np.int32).reshape(-1)
        raw = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], axis=-1).astype(np.uint8).tobytes()
    else:
        dtype = {16: np.int16, 32: np.int32}[bits]
        raw = np.clip(np.round(samples * 2.0 ** (bits - 1)), -2.0 ** (bits - 1), 2.0 ** (bits - 1) - 1).astype(
            dtype).tobytes()
    block = channels * bits // 8
    fmt_body = struct.pack("<HHIIHH", EXTENSIBLE if extensible else fmt, channels, rate, rate * block, block, bits)
    if extensible:
        fmt_body += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt) + b"\x00\x00\x00\x00\x10\x00\x80\x00" \
                    b"\x00\xaa\x00\x38\x9b\x71"
    chunks = b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
    if extra_chunk:
        chunks += b"LIST" + struct.pack("<I", 5) + b"INFOx\x00"  # odd size: padded to even
    chunks += b"data" + struct.pack("<I", len(raw) if data_size is None else data_size) + raw
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def jax_python_decode(path):
    """The JAX package's pure-Python WAV parser (its fallback behind the native decoder)."""
    info, offset, size, audio_format = jax_audio_io._parse_wav_header(str(path))
    with open(path, "rb") as f:
        f.seek(offset)
        raw = f.read(size)
    flat = jax_audio_io._decode_pcm(raw, info.bits_per_sample, audio_format)
    return flat.reshape(-1, info.num_channels).T.copy(), info


def _signal(frames, channels, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((frames, channels)) * 0.3, -0.99, 0.99)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fmt,bits", [(PCM, 8), (PCM, 16), (PCM, 24), (PCM, 32), (FLOAT, 32), (FLOAT, 64)])
def test_wav_decodes_like_the_jax_parser(tmp_path, fmt, bits, channels):
    path = tmp_path / "a.wav"
    path.write_bytes(wav_bytes(_signal(1001, channels), 22050, fmt, bits))
    want, want_info = jax_python_decode(path)
    got, rate = load_audio(path)
    assert rate == 22050 and got.dtype == np.float32 and got.shape == (channels, 1001)
    np.testing.assert_array_equal(got, want)
    info = audio_info(path)
    assert (info.sample_rate, info.num_frames, info.num_channels, info.bits_per_sample) == (
        want_info.sample_rate, want_info.num_frames, want_info.num_channels, want_info.bits_per_sample)
    assert audio_len(path) == 1001 / 22050


@pytest.mark.parametrize("fmt,bits", [(PCM, 24), (FLOAT, 32)])
def test_extensible_wav_decodes_like_the_jax_parser(tmp_path, fmt, bits):
    path = tmp_path / "x.wav"
    path.write_bytes(wav_bytes(_signal(500, 2, seed=1), 48000, fmt, bits, extensible=True))
    want, _ = jax_python_decode(path)
    got, rate = load_audio(path)
    assert rate == 48000
    np.testing.assert_array_equal(got, want)


def test_data_size_past_the_file_is_clamped(tmp_path):
    """C6: a header whose data chunk claims more than the file holds reads to the file's end, in whole
    frames; the JAX parser reports the claimed duration."""
    signal = _signal(800, 2)
    path = tmp_path / "lying.wav"
    path.write_bytes(wav_bytes(signal, 16000, PCM, 16, data_size=10**9) + b"\x01")  # a stray half frame too
    info = audio_info(path)
    assert info.num_frames == 800
    assert jax_audio_io._parse_wav_header(str(path))[0].num_frames == 10**9 // 4  # the fault, unported
    got, _ = load_audio(path)
    want, _ = load_audio_of(tmp_path, signal, 16000, PCM, 16)
    np.testing.assert_array_equal(got, want)


def load_audio_of(tmp_path, signal, rate, fmt, bits):
    path = tmp_path / "honest.wav"
    path.write_bytes(wav_bytes(signal, rate, fmt, bits))
    return load_audio(path)


def test_truncated_data_reads_whole_frames(tmp_path):
    data = wav_bytes(_signal(300, 2), 16000, PCM, 24)
    path = tmp_path / "cut.wav"
    path.write_bytes(data[:-7])  # 1 frame and 1 byte short
    got, _ = load_audio(path)
    assert got.shape == (2, 298) and audio_info(path).num_frames == 298


@pytest.mark.parametrize("fmt,bits", [(PCM, 64), (PCM, 12), (PCM, 0), (FLOAT, 8), (FLOAT, 16), (FLOAT, 24),
                                      (6, 8), (7, 8), (2, 4), (EXTENSIBLE, 16)])
def test_invalid_format_and_bit_depth_pairs_raise(tmp_path, fmt, bits):
    """C7: only PCM at 8/16/24/32 bits and IEEE float at 32/64 bits decode; every other pair raises in the
    header read, before any sample is decoded."""
    frames, channels = 64, 1
    block = max(bits // 8, 1)
    fmt_body = struct.pack("<HHIIHH", fmt, channels, 16000, 16000 * block, block, bits)
    chunks = b"fmt " + struct.pack("<I", 16) + fmt_body + b"data" + struct.pack("<I", frames * block) + \
        bytes(frames * block)
    path = tmp_path / "bad.wav"
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)
    with pytest.raises(ValueError, match="unsupported WAV fmt"):
        audio_info(path)
    with pytest.raises(ValueError, match="unsupported WAV fmt"):
        load_audio(path)


#: the JAX package's messages on the truncated headers below: (load_audio's, audio_info's)
COMPRESSED_ERRORS = {
    "a.flac": (r"native flac decode failed \(-5\)", "invalid FLAC sample rate"),
    "a.ogg": ("no compressed-audio backend succeeded", "unrecognized Ogg codec"),
    "a.mp3": ("no compressed-audio backend succeeded", "no MPEG Layer III frames found"),
}


@pytest.mark.parametrize("name,head", [("a.flac", b"fLaC\x00\x00\x00\x22"), ("a.ogg", b"OggS\x00\x02"),
                                       ("a.mp3", b"ID3\x04\x00\x00")])
def test_compressed_formats_are_not_ported(tmp_path, name, head):
    """FLAC, Ogg and MP3 are ported (the name is kept from when they raised ``NotImplementedError``): a truncated
    header of each raises ``ValueError`` in the port's ``load_audio`` and ``audio_info`` with the JAX package's
    message on the same file."""
    path = tmp_path / name
    path.write_bytes(head + bytes(64))
    load_error, info_error = COMPRESSED_ERRORS[name]
    for port_fn, jax_fn, message in ((load_audio, jax_audio_io.load_audio, load_error),
                                     (audio_info, jax_audio_io.audio_info, info_error)):
        for fn in (port_fn, jax_fn):
            with pytest.raises(ValueError, match=message):
                fn(path)


@pytest.mark.parametrize("orig,new", [(8000, 16000), (44100, 16000), (48000, 16000), (16000, 16000), (22050, 8000)])
def test_resample_matches_jax(orig, new):
    audio = _signal(orig // 10, 2, seed=3).T.astype(np.float32)
    got, want = resample(audio, orig, new), jax_audio_io.resample(audio, orig, new)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("force_mono", [True, False])
def test_audio_file_loader_matches_jax(tmp_path, force_mono):
    path = tmp_path / "s.wav"
    path.write_bytes(wav_bytes(_signal(4410, 2, seed=4) * 0.5 + 0.1, 44100, PCM, 16))
    got = AudioFileLoader(force_mono=force_mono, sample_rate=16000)(path)
    audio, rate = jax_python_decode(path)[0], 44100
    want = jax_audio_io.AudioFileLoader(force_mono=force_mono, sample_rate=16000).preprocess_audio(audio, rate)
    np.testing.assert_array_equal(got, want)


def _manifest(tmp_path, n=11, with_duration=True, name="m.json"):
    rng = np.random.default_rng(5)
    rows = []
    for i in range(n):
        frames = int(rng.integers(800, 6000))
        path = tmp_path / f"u{i}.wav"
        path.write_bytes(wav_bytes(_signal(frames, 1, seed=i), 16000, PCM, 16))
        row = {"audio_filepath": str(path), "text": f"utt {i}"}
        if with_duration:
            row["duration"] = frames / 16000
        rows.append(row)
    manifest = tmp_path / name
    manifest.write_text("\n".join(json.dumps(r) for r in rows))
    return manifest


def _same_batches(got_loader, want_loader, epochs=2):
    assert len(got_loader) == len(want_loader)
    for _ in range(epochs):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want)
        for (ga, gl, gt), (wa, wl, wt) in zip(got, want):
            assert gt == wt
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(ga, wa)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("with_duration", [True, False])
def test_loader_batches_and_order_match_jax(tmp_path, shuffle, drop_last, with_duration):
    manifest = _manifest(tmp_path, with_duration=with_duration)
    kw = dict(batch_size=3, shuffle=shuffle, num_workers=3, pad_multiple=1600, seed=7, drop_last=drop_last)
    got = DataLoader(ManifestSpeechDataset(manifest), **kw)
    want = JaxDataLoader(JaxManifestDataset(manifest), **kw)
    assert got._durations() == want._durations() is not None
    _same_batches(got, want)


def test_loader_without_durations_shuffles_items_like_jax(tmp_path):
    manifest = _manifest(tmp_path)
    kw = dict(batch_size=4, shuffle=True, num_workers=2, pad_multiple=1000, seed=1, sort_by_duration=False)
    _same_batches(DataLoader(ManifestSpeechDataset(manifest), **kw), JaxDataLoader(JaxManifestDataset(manifest), **kw))


def test_manifest_datamodule_matches_jax(tmp_path):
    train, val = _manifest(tmp_path, 9, name="t.json"), _manifest(tmp_path, 4, name="v.json")
    got = ManifestDatamodule(str(train), str(val), str(val), batch_size=2, num_workers=2)
    want = JaxManifestDatamodule(str(train), str(val), str(val), batch_size=2, num_workers=2)
    got.setup("fit")
    want.setup("fit")
    assert got.steps_per_epoch == want.steps_per_epoch == 4
    _same_batches(got.train_dataloader(), want.train_dataloader())
    _same_batches(got.val_dataloader(), want.val_dataloader(), epochs=1)
    assert got.train_dataset.all_outputs() == want.train_dataset.all_outputs()


def test_asr_collate_matches_jax():
    rng = np.random.default_rng(2)
    samples = [(rng.standard_normal(n).astype(np.float32), f"t{n}") for n in (300, 1700, 1600, 5)]
    for got, want in zip(asr_collate(samples, pad_multiple=800), jax_asr_collate(samples, pad_multiple=800)):
        if isinstance(want, list):
            assert got == want
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
