"""Host-side audio IO: decode, mono mix, DC removal, resample.

Port of ``thunder_tpu/data/audio_io.py``. WAV and FLAC decode in the port's
native C++ runtime (:mod:`thunder_tpu_torch.native`, dispatch by file
magic); WAV also has the pure-Python parser, which gives the errors when the
native decoder refuses a file and decodes where the runtime does not build.
MP3 and OGG headers are parsed here, and their samples come from the first
decode hook that works (soundfile, torchaudio, pygame). Resampling is
scipy's windowed-sinc polyphase, with the native windowed sinc where scipy
is missing. Everything stays on the host: the card only ever sees float32
waveform arrays.

Two faults of the JAX package's WAV readers are not carried over, in Python
or in C++:

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


def _parse_flac_streaminfo(path: str) -> AudioInfo:
    """Read sample rate / frames / channels from the FLAC STREAMINFO block."""
    with open(path, "rb") as f:
        header = f.read(4 + 4 + 34)
    if header[:4] != b"fLaC":
        raise ValueError(f"not a FLAC file: {path}")
    if len(header) < 42:
        raise ValueError(f"truncated FLAC header: {path}")
    if header[4] & 0x7F != 0:  # first metadata block must be STREAMINFO
        raise ValueError(f"FLAC file missing STREAMINFO: {path}")
    si = header[8:]
    bits = int.from_bytes(si[10:18], "big")  # rate(20) ch(3) bps(5) total(36)
    sample_rate = bits >> 44
    channels = ((bits >> 41) & 0x7) + 1
    bps = ((bits >> 36) & 0x1F) + 1
    total = bits & ((1 << 36) - 1)
    if sample_rate == 0:
        raise ValueError(f"invalid FLAC sample rate in {path}")
    if total == 0:
        # spec-legal "unknown length": fall back to a full decode
        from thunder_tpu_torch.native import native_load_flac

        audio, rate = native_load_flac(path)
        return AudioInfo(rate, audio.shape[1], audio.shape[0], bps)
    return AudioInfo(sample_rate, total, channels, bps)


# ---------------------------------------------------------------------------
# mp3 / ogg (compressed formats): header parsing + decode-hook chain
#
# A pure-Python MPEG audio header parser (rates/channels/duration for
# bucketing) plus a chain of optional decode backends — soundfile
# (libsndfile), torchaudio, pygame (SDL_mixer) — first importable backend
# wins, as the original framework delegates these formats to torchaudio's
# ffmpeg/libsox backends.  WAV/FLAC stay on the in-repo native C++ decoders.
# ---------------------------------------------------------------------------

#: kbit/s by (is_mpeg1, bitrate_index) for Layer III
_MP3_BITRATES = {
    True: (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320),
    False: (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160),
}
#: Hz by (version_bits, samplerate_index); version bits: 0=MPEG2.5, 2=MPEG2, 3=MPEG1
_MP3_RATES = {3: (44100, 48000, 32000), 2: (22050, 24000, 16000), 0: (11025, 12000, 8000)}


def _mp3_skip_id3(data: bytes) -> int:
    """Byte offset past an ID3v2 tag (0 if none)."""
    if data[:3] != b"ID3" or len(data) < 10:
        return 0
    # syncsafe 28-bit size, excluding the 10-byte header
    size = (data[6] << 21) | (data[7] << 14) | (data[8] << 7) | data[9]
    return 10 + size


def _mp3_frame_at(data: bytes, pos: int):
    """Parse a Layer III frame header at ``pos``.

    Returns ``(frame_bytes, sample_rate, channels, samples_per_frame)`` or
    ``None`` if ``pos`` does not hold a valid header.
    """
    if pos + 4 > len(data):
        return None
    b0, b1, b2, b3 = data[pos : pos + 4]
    if b0 != 0xFF or (b1 & 0xE0) != 0xE0:
        return None
    version = (b1 >> 3) & 0x3  # 0=MPEG2.5, 1=reserved, 2=MPEG2, 3=MPEG1
    layer = (b1 >> 1) & 0x3  # 1 = Layer III
    if version == 1 or layer != 1:
        return None
    bitrate_idx = (b2 >> 4) & 0xF
    rate_idx = (b2 >> 2) & 0x3
    if bitrate_idx in (0, 15) or rate_idx == 3:
        return None  # free-format / invalid
    padding = (b2 >> 1) & 0x1
    channels = 1 if ((b3 >> 6) & 0x3) == 3 else 2
    mpeg1 = version == 3
    bitrate = _MP3_BITRATES[mpeg1][bitrate_idx] * 1000
    sample_rate = _MP3_RATES[version][rate_idx]
    spf = 1152 if mpeg1 else 576  # Layer III samples per frame (granules)
    frame_bytes = (spf // 8) * bitrate // sample_rate + padding
    return frame_bytes, sample_rate, channels, spf


def _mp3_first_frame(path: str):
    """Bounded probe: (first-frame offset, window bytes, frame tuple, data_start).

    Seeks past the ID3v2 tag (whose size is in its own header — no scan) and
    searches a growing window (256 KB, doubling) for the first valid Layer III
    header, so metadata reads never pull a whole multi-MB file into memory.
    """
    with open(path, "rb") as f:
        head = f.read(10)
        data_start = _mp3_skip_id3(head)
        f.seek(data_start)
        window = b""
        chunk = 1 << 18
        at_eof = False
        while True:
            if not at_eof:
                more = f.read(chunk)
                window += more
                at_eof = len(more) < chunk
                chunk *= 2
            pos = 0
            need_more = False
            while pos + 4 <= len(window):
                frame = _mp3_frame_at(window, pos)
                # require a second header right after (or true EOF) to reject
                # spurious 0xFF sync bytes inside tag junk
                if frame is not None:
                    nxt = pos + max(frame[0], 4)
                    if nxt + 4 <= len(window):
                        if _mp3_frame_at(window, nxt) is not None:
                            return data_start + pos, window[pos:], frame, data_start
                    elif at_eof:
                        return data_start + pos, window[pos:], frame, data_start
                    else:
                        # candidate's verification crosses the window end and
                        # more file remains: extend the window, then re-check
                        need_more = True
                        break
                pos += 1
            if at_eof and not need_more:
                raise ValueError(f"no MPEG Layer III frames found in {path}")


def _mp3_vbr_total_frames(window: bytes, frame) -> int:
    """Frame count from a Xing/Info/VBRI header in the first frame, or 0."""
    frame_bytes, rate, channels, spf = frame
    mpeg1 = spf == 1152
    side = (17 if channels == 1 else 32) if mpeg1 else (9 if channels == 1 else 17)
    for off in (4 + side, 4 + side + 2):  # +2 when a CRC follows the header
        if window[off : off + 4] in (b"Xing", b"Info") and len(window) >= off + 12:
            flags = int.from_bytes(window[off + 4 : off + 8], "big")
            if flags & 0x1:
                return int.from_bytes(window[off + 8 : off + 12], "big")
    if window[36:40] == b"VBRI" and len(window) >= 54:
        # VBRI: version(2) delay(2) quality(2) bytes(4) frames(4) after the tag
        return int.from_bytes(window[50:54], "big")
    return 0


def _parse_mp3_info(path: str) -> AudioInfo:
    """Metadata without a full decode: Xing/VBRI header, CBR filesize math,
    or (only for headerless VBR files) an exact whole-file frame scan."""
    first_pos, window, frame, _ = _mp3_first_frame(path)
    frame_bytes, sample_rate, channels, spf = frame
    vbr_frames = _mp3_vbr_total_frames(window, frame)
    if vbr_frames:
        return AudioInfo(sample_rate, vbr_frames * spf, channels, 16)
    # probe a few successive frames: constant bitrate -> filesize estimate
    bitrate = _MP3_BITRATES[spf == 1152][(window[2] >> 4) & 0xF] * 1000
    pos, cbr = 0, True
    for _ in range(8):
        fr = _mp3_frame_at(window, pos)
        if fr is None:
            break
        if _MP3_BITRATES[fr[3] == 1152][(window[pos + 2] >> 4) & 0xF] * 1000 != bitrate:
            cbr = False
            break
        pos += max(fr[0], 4)
        if pos + 4 > len(window):
            break
    size = Path(path).stat().st_size
    with open(path, "rb") as f:
        f.seek(max(0, size - 128))
        if f.read(3) == b"TAG":  # ID3v1 tail tag
            size -= 128
    if cbr:
        total = int((size - first_pos) * 8 * sample_rate / bitrate / spf) * spf
        return AudioInfo(sample_rate, max(total, spf), channels, 16)
    # headerless VBR: exact full scan (the only case that reads everything)
    data = Path(path).read_bytes()
    pos, total = first_pos, 0
    while pos + 4 <= len(data):
        fr = _mp3_frame_at(data, pos)
        if fr is None:
            pos += 1  # resync (junk between tags/frames)
            continue
        total += fr[3]
        pos += max(fr[0], 4)
    return AudioInfo(sample_rate, total, channels, 16)


def _parse_ogg_info(path: str) -> AudioInfo:
    """Ogg container metadata: codec id header + last-page granule position.

    Reads the first page for (codec, rate, channels) — Vorbis, Opus, or
    FLAC-in-Ogg — and the file tail for the final granule position, which by
    the Ogg spec is the total PCM sample count (Opus: in 48 kHz units, less
    the pre-skip).  Bounded reads only; no decode.
    """
    with open(path, "rb") as f:
        head = f.read(1 << 14)
    if head[:4] != b"OggS":
        raise ValueError(f"not an Ogg file: {path}")
    nsegs = head[26]
    payload = head[27 + nsegs : 27 + nsegs + sum(head[27 : 27 + nsegs])]
    if payload[:7] == b"\x01vorbis" and len(payload) >= 16:
        channels = payload[11]
        rate = int.from_bytes(payload[12:16], "little")
        granule_rate, pre_skip, bps = rate, 0, 16
    elif payload[:8] == b"OpusHead" and len(payload) >= 14:
        channels = payload[9]
        pre_skip = int.from_bytes(payload[10:12], "little")
        rate = 48000  # Opus always decodes at 48 kHz
        granule_rate, bps = 48000, 16
    elif payload[:5] == b"\x7fFLAC" and len(payload) >= 51:
        # Ogg-FLAC mapping header is 13 bytes (0x7F 'FLAC' major minor
        # count 'fLaC'); a 4-byte metadata block header precedes STREAMINFO
        si = payload[13 + 4 :]
        bits = int.from_bytes(si[10:18], "big")
        rate = bits >> 44
        channels = ((bits >> 41) & 0x7) + 1
        bps = ((bits >> 36) & 0x1F) + 1
        granule_rate, pre_skip = rate, 0
    else:
        raise ValueError(f"unrecognized Ogg codec in {path}")
    # last granule position: scan the tail for the final page header
    size = Path(path).stat().st_size
    with open(path, "rb") as f:
        f.seek(max(0, size - (1 << 16)))
        tail = f.read()
    last = tail.rfind(b"OggS")
    if last < 0 or last + 14 > len(tail):
        raise ValueError(f"no closing Ogg page found in {path}")
    granule = int.from_bytes(tail[last + 6 : last + 14], "little", signed=True)
    frames = max(int(granule) - pre_skip, 0)
    if granule_rate != rate and granule_rate:
        frames = frames * rate // granule_rate
    return AudioInfo(rate, frames, channels, bps)


def _load_via_soundfile(path: str):
    import soundfile as sf

    data, rate = sf.read(path, dtype="float32", always_2d=True)
    return np.ascontiguousarray(data.T), int(rate)


def _load_via_torchaudio(path: str):
    import torchaudio

    wav, rate = torchaudio.load(path)
    return wav.numpy().astype(np.float32), int(rate)


def _load_via_pygame(path: str):
    """SDL_mixer decode (mp3/ogg): init the mixer at the file's native rate
    and channel count (parsed from the headers) so no resample/upmix happens."""
    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")  # keep stdout clean
    import pygame

    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"OggS":
        # native spec from the Ogg id header so SDL_mixer neither
        # resamples nor upmixes during decode
        info = _parse_ogg_info(path)
        rate, channels = info.sample_rate, info.num_channels
    else:
        # first-frame probe only — rate/channels don't need the total duration
        _, _, frame, _ = _mp3_first_frame(path)
        _, rate, channels, _ = frame
    current = pygame.mixer.get_init()
    # size must be -16 too: a pre-initialized f32/8-bit mixer would break
    # the /32768 int16 scaling below
    if current is None or current[0] != rate or current[1] != -16 or abs(current[2]) != channels:
        pygame.mixer.quit()
        pygame.mixer.init(frequency=rate, size=-16, channels=channels)
    rate, _, channels = pygame.mixer.get_init()
    import pygame.sndarray

    arr = pygame.sndarray.array(pygame.mixer.Sound(str(path)))
    if arr.ndim == 1:
        arr = arr[:, None]
    return (arr.T.astype(np.float32) / 32768.0), int(rate)


#: (name, loader) tried in order for compressed formats; first importable wins
_DECODE_HOOKS = (
    ("soundfile", _load_via_soundfile),
    ("torchaudio", _load_via_torchaudio),
    ("pygame", _load_via_pygame),
)


def _load_via_hooks(path: str):
    errors = []
    for name, loader in _DECODE_HOOKS:
        try:
            return loader(path)
        except ImportError:
            errors.append(f"{name}: not installed")
        except Exception as e:  # backend present but failed on this file
            errors.append(f"{name}: {type(e).__name__}: {e}")
    raise ValueError(
        f"cannot decode {path}: no compressed-audio backend succeeded "
        f"({'; '.join(errors)}). Install soundfile, torchaudio, or pygame, "
        f"or convert to WAV/FLAC (decoded natively)."
    )


def _is_mp3(path: str, magic: bytes) -> bool:
    if str(path).lower().endswith(".mp3"):
        return True
    return magic[:3] == b"ID3" or (len(magic) >= 2 and magic[0] == 0xFF and (magic[1] & 0xE0) == 0xE0)


def audio_info(path: Union[str, Path]) -> AudioInfo:
    """Header-only metadata read (for duration bucketing); WAV, FLAC, MP3, or OGG."""
    path = str(path)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        return _parse_flac_streaminfo(path)
    if magic == b"OggS":
        return _parse_ogg_info(path)
    if magic[:4] != b"RIFF" and _is_mp3(path, magic):
        return _parse_mp3_info(path)
    return _parse_wav_header(path)[0]


def load_audio(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Decode an audio file -> ``(float32 (channels, time) array, sample_rate)``.

    Dispatch by file magic: FLAC goes to the native C++ decoder, WAV to the
    pure-Python reader (which needs no build and owns the header errors;
    ``native_load_wav`` decodes the same samples), MP3/OGG to the optional
    decode-hook chain (soundfile/torchaudio/pygame).
    """
    from thunder_tpu_torch.native import native_load_flac

    path = str(path)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        return native_load_flac(path)
    if magic[:4] == b"OggS" or path.lower().endswith((".ogg", ".oga", ".opus")):
        return _load_via_hooks(path)
    if magic[:4] != b"RIFF" and _is_mp3(path, magic):
        return _load_via_hooks(path)
    info, offset, size, audio_format = _parse_wav_header(path)
    with open(path, "rb") as f:
        f.seek(offset)
        raw = f.read(size)
    flat = _decode_pcm(raw, info.bits_per_sample, audio_format)
    return flat.reshape(-1, info.num_channels).T.copy(), info.sample_rate


def resample(audio: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Polyphase windowed-sinc resampling along the last axis.

    ``scipy.signal.resample_poly`` where scipy is installed; the native
    windowed sinc (``tn_resample``) where it is not, so the pipeline never
    hard-depends on scipy.
    """
    if orig_freq == new_freq:
        return audio
    from math import gcd

    g = gcd(int(orig_freq), int(new_freq))
    up, down = new_freq // g, orig_freq // g
    try:
        from scipy.signal import resample_poly
    except ImportError:
        from thunder_tpu_torch.native import native_resample

        flat = np.atleast_2d(np.asarray(audio, np.float32))
        out = np.stack([native_resample(row, up, down) for row in flat])
        return out.reshape(audio.shape[:-1] + (out.shape[-1],))
    return resample_poly(audio, up, down, axis=-1).astype(np.float32)


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
