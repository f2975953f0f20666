"""Unified audio decode API.

Decode order for a path (replaces the reference's ffmpeg-subprocess +
torchaudio stack, services/audio_processor.py:73-97):

1. ``.wav`` — first-party reader (io/wav.py; C++ fast path via
   io/native.py when built).
2. ``.ogg`` — payload-routed: Vorbis via the first-party decoders
   (C++/Python), Opus via the in-process libopus binding or the first-party
   decoder (io/opus.py, io/opusdec/), legacy Speex via the in-process
   libspeex binding (io/speex.py), Ogg-FLAC via the first-party FLAC
   decoder (io/flac.py);
   ``ffmpeg`` subprocess (the reference's own mechanism) and
   pygame/SDL_mixer as last resorts, else a clear error.
3. ``.flac`` / ``.mp3`` — first-party FLAC decoder (io/flac.py) /
   libmpg123 binding (io/mp3.py).

Every decode returns ([channels, frames] float32 in [-1, 1], rate).
"""

from __future__ import annotations

import logging
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

from audio_processor_tpu_torch.io import wav as wav_mod
from audio_processor_tpu_torch.io.wav import AudioInfo, WavError


def _ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _decode_via_ffmpeg(path: str | Path) -> Tuple[np.ndarray, int]:
    """OGG (or anything else) -> WAV bytes via ffmpeg subprocess, then
    parse with the first-party WAV reader (reference mechanism:
    services/audio_processor.py:76-86)."""
    cmd = ["ffmpeg", "-i", str(path), "-f", "wav", "-acodec",
           "pcm_s16le", "-"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.DEVNULL, check=True)
    data = proc.stdout
    # ffmpeg streams with unknown RIFF sizes; patch them for the parser.
    if len(data) > 44 and data[:4] == b"RIFF":
        import struct

        data = bytearray(data)
        struct.pack_into("<I", data, 4, len(data) - 8)
        idx = data.find(b"data")
        if idx > 0:
            struct.pack_into("<I", data, idx + 4, len(data) - idx - 8)
        data = bytes(data)
    ai, off, size = wav_mod._parse_header(data)
    n = ai.num_frames * ai.num_channels
    x = np.frombuffer(data[off:off + size], dtype="<i2", count=n) \
        .astype(np.float32) / 32768.0
    return np.ascontiguousarray(x.reshape(-1, ai.num_channels).T), \
        ai.sample_rate


def _decode_via_pygame(path: str | Path) -> Tuple[np.ndarray, int]:
    """OGG/Vorbis decode via pygame's bundled SDL_mixer (a pure
    fallback when ffmpeg is absent). The mixer is opened at the
    stream's native rate/channels (from the first-party probe) so SDL
    performs no resampling — the output is the raw Vorbis synthesis."""
    import os

    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    import pygame

    from audio_processor_tpu_torch.io.ogg import probe_ogg

    info = probe_ogg(path)
    rate = info.sample_rate if info else 44100
    channels = max(1, min(2, info.num_channels if info else 2))
    if pygame.mixer.get_init() != (rate, -16, channels):
        pygame.mixer.quit()
        pygame.mixer.init(frequency=rate, size=-16, channels=channels)
    import pygame.sndarray as sndarray

    arr = sndarray.array(pygame.mixer.Sound(str(path)))
    if arr.ndim == 1:
        arr = arr[:, None]
    x = (arr.astype(np.float32) / 32768.0).T
    return np.ascontiguousarray(x), rate


def _pygame_available() -> bool:
    try:
        import pygame  # noqa: F401

        return True
    except ImportError:
        return False


def _native_decoder():
    try:
        from audio_processor_tpu_torch.io import native

        return native if native.available() else None
    except Exception:
        return None


def load_audio(path: str | Path) -> Tuple[np.ndarray, int]:
    """Decode any supported file -> ([C, T] float32, sample_rate)."""
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix == ".wav":
        nat = _native_decoder()
        if nat is not None:
            out = nat.read_wav(p)
            if out is not None:
                return out
        return wav_mod.read(p)
    if suffix == ".mp3":
        from audio_processor_tpu_torch.io.mp3 import decode_mp3

        return decode_mp3(p.read_bytes())
    if suffix == ".flac":
        nat = _native_decoder()
        if nat is not None and getattr(nat, "has_flac", lambda: False)():
            # C++ fast path: raw-fLaC with a known total-sample count;
            # Ogg-FLAC and unknown-length streams fall through to the
            # Python decoder.
            out = nat.decode_flac(p)
            if out is not None:
                return out
        from audio_processor_tpu_torch.io.flac import decode_flac

        return decode_flac(p)
    if suffix in (".ogg", ".opus"):
        # Payload-routed decode: Vorbis goes to the first-party
        # decoders (C++ fast path native/vorbis.cpp ~590x realtime,
        # then the validated Python reference io/vorbis.py); Opus goes
        # to the in-process libopus binding (io/opus.py — first-party
        # Ogg layer, no subprocess); ffmpeg/pygame remain as last
        # resorts for anything else.
        from audio_processor_tpu_torch.io.ogg import probe_ogg

        info = probe_ogg(p)
        if info is not None and info.encoding == "opus":
            from audio_processor_tpu_torch.io import opus as opus_mod

            # Speed order: libopus (ctypes, in-process) >> ffmpeg
            # subprocess >> first-party pure-Python (3-5x realtime,
            # io/opusdec) — the last keeps dependency-free hosts
            # working but should not silently eat throughput when
            # ffmpeg exists.
            if opus_mod.available() or not _ffmpeg_available():
                try:
                    if not opus_mod.available():
                        logger.warning(
                            "libopus not found: decoding %s with the "
                            "pure-Python Opus fallback (3-5x realtime)",
                            p)
                    return opus_mod.decode_opus(p)
                except Exception as e:
                    logger.warning("in-process opus decode failed for "
                                   "%s (%s); falling back", p, e)
            elif _ffmpeg_available():
                return _decode_via_ffmpeg(p)
        if info is not None and info.encoding == "speex":
            from audio_processor_tpu_torch.io import speex as speex_mod

            if speex_mod.speex_available():
                return speex_mod.decode_speex(p)
            if _ffmpeg_available():
                return _decode_via_ffmpeg(p)
            raise WavError(
                f"cannot decode {p}: Ogg-Speex payload and neither "
                "libspeex nor ffmpeg is available")
        if info is not None and info.encoding == "flac":
            from audio_processor_tpu_torch.io.flac import decode_flac

            return decode_flac(p)
        nat = _native_decoder()
        if nat is not None and getattr(nat, "has_vorbis", lambda: False)():
            # The C++ fast path decodes one logical stream; chained
            # files (RFC 3533 §3 concatenation) go to the Python
            # decoder, which appends the chains like ffmpeg does.
            from audio_processor_tpu_torch.io.ogg import chain_segments
            if len(chain_segments(Path(p).read_bytes(),
                                  b"\x01vorbis")) == 1:
                out = nat.decode_vorbis(p)
                if out is not None:
                    return np.clip(out[0], -1.0, 1.0), out[1]
        try:
            from audio_processor_tpu_torch.io.vorbis import decode_vorbis

            pcm, rate = decode_vorbis(p)
            return np.clip(pcm, -1.0, 1.0), rate
        except Exception as e:
            logger.warning("first-party vorbis decode failed for %s "
                           "(%s); falling back", p, e)
        if _ffmpeg_available():
            return _decode_via_ffmpeg(p)
        if _pygame_available():
            return _decode_via_pygame(p)
        raise WavError(
            f"cannot decode {p}: no OGG decoder available "
            "(ffmpeg not installed and pygame/SDL_mixer not available)")
    # Unknown extension: try WAV parse, then ffmpeg.
    try:
        return wav_mod.read(p)
    except WavError:
        if _ffmpeg_available():
            return _decode_via_ffmpeg(p)
        raise


def load_audio_range(path: str | Path, start_sample: int,
                     num_samples: Optional[int] = None
                     ) -> Tuple[np.ndarray, int]:
    """Random-access decode: ([C, n] float32, rate) for one sample
    range at the file's native output rate, without decoding the
    whole file.

    - WAV: exact byte-range read (header parse + one seek, io/wav.py)
    - Ogg/Vorbis: bit-exact seek decode (header-bit frame index + one
      priming frame, io/vorbis.py)
    - Ogg/Opus: RFC 7845 pre-roll seek at 48 kHz (float tolerance,
      io/opus.py)
    - anything else: full decode + slice (correct, not random-access)

    The reference stack has no random access at all — its ffmpeg
    subprocess decodes whole files (services/audio_processor.py:76-86).
    """
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix == ".wav":
        return wav_mod.read_range(p, start_sample, num_samples)
    if suffix in (".ogg", ".opus"):
        from audio_processor_tpu_torch.io.ogg import probe_ogg

        info = probe_ogg(p)
        if info is not None and info.encoding == "opus":
            from audio_processor_tpu_torch.io import opus as opus_mod

            try:
                return opus_mod.decode_opus_range(
                    p, start_sample, num_samples)
            except Exception as e:
                logger.warning("opus range decode failed for %s "
                               "(%s); falling back", p, e)
        elif info is None or info.encoding == "vorbis":
            try:
                from audio_processor_tpu_torch.io.vorbis import (
                    decode_vorbis_range,
                )

                pcm, rate = decode_vorbis_range(p, start_sample,
                                                num_samples)
                return np.clip(pcm, -1.0, 1.0), rate
            except Exception as e:
                logger.warning("vorbis range decode failed for %s "
                               "(%s); falling back", p, e)
    pcm, rate = load_audio(p)
    stop = None if num_samples is None else start_sample + num_samples
    return np.ascontiguousarray(pcm[:, start_sample:stop]), rate


def load_audio_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode an in-memory WAV/OGG payload -> ([C, T] float32, sr).

    Serving path (serving.py): format sniffed from magic bytes. WAV
    and Ogg/Opus decode fully in memory; Ogg/Vorbis spools to a temp
    file so it gets the same decoder chain as load_audio (C++ fast
    path ~590x realtime, Python Vorbis reference, then ffmpeg/pygame
    as last resorts)."""
    head = bytes(data[:4])
    if head == b"RIFF":
        return wav_mod.read_bytes(data)
    if head == b"fLaC":
        from audio_processor_tpu_torch.io.flac import decode_flac

        return decode_flac(bytes(data))
    if head == b"OggS":
        import tempfile

        data = bytes(data)
        if b"\x7fFLAC" in data[:1024]:
            from audio_processor_tpu_torch.io.flac import decode_flac

            return decode_flac(bytes(data))
        if b"OpusHead" in data[:1024]:
            from audio_processor_tpu_torch.io import opus as opus_mod

            if opus_mod.available() or not _ffmpeg_available():
                try:
                    return opus_mod.decode_opus(data)
                except Exception as e:
                    logger.warning("in-process opus decode failed "
                                   "(%s); falling back", e)
        if b"Speex   " in data[:1024]:
            from audio_processor_tpu_torch.io import speex as speex_mod

            if speex_mod.speex_available():
                return speex_mod.decode_speex(data)
        nat = _native_decoder()
        if nat is not None and getattr(nat, "has_vorbis", lambda: False)():
            with tempfile.NamedTemporaryFile(suffix=".ogg") as f:
                f.write(data)
                f.flush()
                out = nat.decode_vorbis(f.name)
                if out is not None:
                    return np.clip(out[0], -1.0, 1.0), out[1]
        from audio_processor_tpu_torch.io.vorbis import decode_vorbis

        try:
            pcm, rate = decode_vorbis(bytes(data))
            return np.clip(pcm, -1.0, 1.0), rate
        except Exception as e:
            # Non-Vorbis payloads (e.g. Opus) go to the subprocess
            # fallbacks; otherwise surface the REAL parse error, not a
            # misleading "no decoder available".
            if _ffmpeg_available() or _pygame_available():
                with tempfile.NamedTemporaryFile(suffix=".ogg") as f:
                    f.write(data)
                    f.flush()
                    if _ffmpeg_available():
                        return _decode_via_ffmpeg(f.name)
                    return _decode_via_pygame(f.name)
            raise WavError(f"OGG payload decode failed: {e}") from e
    from audio_processor_tpu_torch.io.mp3 import decode_mp3, looks_like_mp3

    if looks_like_mp3(head):
        return decode_mp3(bytes(data))
    raise WavError(
        "unrecognized audio payload (expect WAV, OGG, FLAC or MP3)")


def probe(path: str | Path) -> Optional[AudioInfo]:
    """Header-only probe; None when the file can't be parsed.

    Replaces torchaudio.info in scan validation (pipeline.py:92)."""
    p = Path(path)
    try:
        if p.suffix.lower() == ".wav":
            nat = _native_decoder()
            if nat is not None:
                out = nat.probe_wav(p)
                if out is not None:
                    return out
            return wav_mod.info(p)
        if p.suffix.lower() in (".ogg", ".opus"):
            from audio_processor_tpu_torch.io.ogg import probe_ogg

            return probe_ogg(p)
        if p.suffix.lower() == ".mp3":
            from audio_processor_tpu_torch.io.mp3 import probe_mp3

            mi = probe_mp3(p)   # header-window read, not the whole file
            return AudioInfo(mi.sample_rate, mi.num_frames,
                             mi.num_channels, 0, "mp3")
        if p.suffix.lower() == ".flac":
            from audio_processor_tpu_torch.io.flac import probe_flac

            return probe_flac(p)
        return wav_mod.info(p)
    except Exception:
        return None
