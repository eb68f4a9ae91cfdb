"""Host-side audio IO: WAV decode, mono mix, DC removal, resample.

Port of the WAV path of ``thunder_tpu/data/audio_io.py`` (the JAX package's
pure-Python parser; there is no native decoder here). FLAC, MP3 and OGG are
not ported yet and raise ``NotImplementedError`` (``ROADMAP.md`` A7).
Resampling is scipy's windowed-sinc polyphase. Everything stays on the host:
the card only ever sees float32 waveform arrays.

Two faults of the JAX parser are not carried over:

- the data chunk's size is clamped to the bytes the file holds (and to whole
  frames), so a header that claims more reports the duration that is there;
- the (format, bit depth) pair is validated: PCM is 8, 16, 24 or 32 bits,
  IEEE float 32 or 64; anything else raises, nothing decodes to zeros.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple, Union

import numpy as np

__all__ = ["AudioInfo", "audio_info", "load_audio", "resample", "AudioFileLoader"]

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE
#: the bit depths each format decodes
VALID_BITS = {WAVE_FORMAT_PCM: (8, 16, 24, 32), WAVE_FORMAT_IEEE_FLOAT: (32, 64)}


@dataclass
class AudioInfo:
    sample_rate: int
    num_frames: int
    num_channels: int
    bits_per_sample: int


def _parse_wav_header(path: str) -> Tuple[AudioInfo, int, int, int]:
    """Returns ``(info, data_offset, data_size, audio_format)``; ``data_size`` is whole frames the file holds."""
    with open(path, "rb") as f:
        file_size = os.fstat(f.fileno()).st_size
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                raise ValueError(f"no data chunk found in {path}")
            chunk_id, size = header[:4], struct.unpack("<I", header[4:])[0]
            if chunk_id == b"fmt ":
                if size < 16 or size > 4096:  # spec: 16/18/40 bytes
                    raise ValueError(f"corrupt fmt chunk size {size} in {path}")
                fmt = f.read(size)
                if len(fmt) < 16:
                    raise ValueError(f"truncated fmt chunk in {path}")
                if size % 2:
                    f.read(1)
            elif chunk_id == b"data":
                if fmt is None:
                    raise ValueError(f"data chunk before fmt in {path}")
                audio_format, channels, rate = struct.unpack("<HHI", fmt[:8])
                bits = struct.unpack("<H", fmt[14:16])[0]
                if audio_format == WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 40:
                    audio_format = struct.unpack("<H", fmt[24:26])[0]
                if channels == 0 or bits not in VALID_BITS.get(audio_format, ()):
                    raise ValueError(f"unsupported WAV fmt: format={audio_format:#x} channels={channels} "
                                     f"bits={bits} in {path}")
                block = channels * (bits // 8)
                size = min(size, file_size - f.tell()) // block * block
                return AudioInfo(rate, size // block, channels, bits), f.tell(), size, audio_format
            else:
                f.seek(size + (size % 2), 1)


def _decode_pcm(raw: bytes, bits: int, audio_format: int) -> np.ndarray:
    """Little-endian samples -> float32 in [-1, 1) (float formats as stored)."""
    if bits not in VALID_BITS.get(audio_format, ()):
        raise ValueError(f"unsupported WAV format {audio_format:#x} at {bits} bits")
    if audio_format == WAVE_FORMAT_IEEE_FLOAT:
        return np.frombuffer(raw, dtype=np.float32 if bits == 32 else np.float64).astype(np.float32)
    if bits == 16:
        return np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    if bits == 32:
        return np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    if bits == 8:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
    vals = b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) | (b[:, 2].astype(np.int32) << 16)
    vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
    return vals.astype(np.float32) / float(1 << 23)


def _refuse_unported(path: str) -> None:
    """Raise for the compressed formats, which wait for A7's decoders."""
    with open(path, "rb") as f:
        magic = f.read(4)
    name = None
    if magic == b"fLaC":
        name = "FLAC"
    elif magic == b"OggS" or path.lower().endswith((".ogg", ".oga", ".opus")):
        name = "Ogg"
    elif magic != b"RIFF" and (path.lower().endswith(".mp3") or magic[:3] == b"ID3"
                               or (len(magic) >= 2 and magic[0] == 0xFF and (magic[1] & 0xE0) == 0xE0)):
        name = "MP3"
    if name is not None:
        raise NotImplementedError(f"{name} decoding is not ported to thunder_tpu_torch yet (ROADMAP.md A7): {path}")


def audio_info(path: Union[str, Path]) -> AudioInfo:
    """Header-only metadata read (for duration bucketing) of a WAV file."""
    path = str(path)
    _refuse_unported(path)
    return _parse_wav_header(path)[0]


def load_audio(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Decode a WAV file -> ``(float32 (channels, time) array, sample_rate)``."""
    path = str(path)
    _refuse_unported(path)
    info, offset, size, audio_format = _parse_wav_header(path)
    with open(path, "rb") as f:
        f.seek(offset)
        raw = f.read(size)
    flat = _decode_pcm(raw, info.bits_per_sample, audio_format)
    return flat.reshape(-1, info.num_channels).T.copy(), info.sample_rate


def resample(audio: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Polyphase windowed-sinc resampling along the last axis (``scipy.signal.resample_poly``)."""
    if orig_freq == new_freq:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(orig_freq), int(new_freq))
    return resample_poly(audio, new_freq // g, orig_freq // g, axis=-1).astype(np.float32)


class AudioFileLoader:
    """Open + canonicalize audio: mono mix by channel average, per-file mean (DC) removal, resample to
    ``sample_rate``."""

    def __init__(self, force_mono: bool = True, sample_rate: int = 16000):
        self.force_mono = force_mono
        self.sample_rate = sample_rate

    def open_audio(self, item: Union[str, Path]) -> Tuple[np.ndarray, int]:
        return load_audio(item)

    def preprocess_audio(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        if self.force_mono and audio.shape[0] > 1:
            audio = audio.mean(axis=0, keepdims=True)
        audio = audio - audio.mean(axis=1, keepdims=True)
        if self.sample_rate != sample_rate:
            audio = resample(audio, int(sample_rate), int(self.sample_rate))
        return audio.astype(np.float32)

    def __call__(self, item: Union[str, Path]) -> np.ndarray:
        audio, sr = self.open_audio(item)
        return self.preprocess_audio(audio, sr)
