"""MP3 (MPEG-1/2/2.5 Layer III) ingest via the system libmpg123.

BEYOND-REFERENCE, optional: the reference scans only *.wav and *.ogg
(pipeline.py:64-65) — .mp3 support is an ingest convenience for
archives that were transcoded. Decode goes through libmpg123 (the
decoder behind mpg123/ffmpeg's fallback and SDL_mixer) driven by
ctypes with the feeder API — in-process, no subprocess, no temp
files. There is deliberately NO first-party fallback: unlike WAV/
Vorbis/Opus/GSM (formats the reference pipeline must decode), MP3 is
out of the reference's contract, so an absent libmpg123 raises a
clean, actionable error instead of shipping 2,000 lines of Layer III
outside the parity surface.

``probe_mp3`` walks frame headers (ID3v2 skip, free-format rejected)
so the scanner can reject mono files and report duration without
decoding audio.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_MPG123_ADD_FLAGS = 2
_MPG123_FORCE_FLOAT = 0x400
_MPG123_GAPLESS = 0x40
_MPG123_OK = 0
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _libmpg123() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        from audio_processor_tpu_torch.io._native_lib import load_first

        def configure(lib: ctypes.CDLL) -> None:
            lib.mpg123_new.restype = ctypes.c_void_p  # AttributeError
            lib.mpg123_init()                         # on stub builds

        _lib = load_first(["libmpg123.so.0", "libmpg123.so"],
                          "mpg123", configure)
    return _lib


def mpg123_available() -> bool:
    return _libmpg123() is not None


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int]:
    """MP3 bytes -> ([C, N] float32 in [-1, 1], sample_rate)."""
    lib = _libmpg123()
    if lib is None:
        raise RuntimeError(
            "MP3 decode needs the system libmpg123 (apt install "
            "libmpg123-0); .mp3 ingest is an optional beyond-reference "
            "path with no first-party fallback")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        lib.mpg123_param(ctypes.c_void_p(h), _MPG123_ADD_FLAGS,
                         ctypes.c_long(_MPG123_FORCE_FLOAT
                                       | _MPG123_GAPLESS),
                         ctypes.c_double(0))
        if lib.mpg123_open_feed(ctypes.c_void_p(h)) != 0:
            raise RuntimeError("mpg123_open_feed failed")
        if lib.mpg123_feed(ctypes.c_void_p(h), data, len(data)) != 0:
            raise ValueError("mpg123 rejected the stream")
        rate = ctypes.c_long(0)
        ch = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        out = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        # Byte-concatenated MP3s are common and mpg123 decodes across
        # the splice, emitting NEW_FORMAT again — each format run is a
        # segment reshaped with ITS OWN channel count (one trailing
        # reshape with the last format would misinterleave the earlier
        # audio). Policy matches the chained-Ogg decoders: channels
        # conform to the first segment, a rate change raises (the
        # pipeline's resampler keys on one rate per file,
        # io/vorbis.py decode_vorbis).
        segments = []                     # (bytes, channels) per format
        chunks = []
        seg_ch = 0
        while True:
            rc = lib.mpg123_read(ctypes.c_void_p(h), out, len(out),
                                 ctypes.byref(done))
            if done.value:
                chunks.append(out.raw[:done.value])
            if rc == _MPG123_NEW_FORMAT:
                if chunks:
                    segments.append((b"".join(chunks), seg_ch))
                    chunks = []
                prev_rate = rate.value
                lib.mpg123_getformat(ctypes.c_void_p(h),
                                     ctypes.byref(rate),
                                     ctypes.byref(ch),
                                     ctypes.byref(enc))
                if prev_rate and rate.value != prev_rate:
                    raise ValueError(
                        "mid-stream sample-rate change "
                        f"({prev_rate} -> {rate.value} Hz) in spliced "
                        "MP3; one rate per file")
                seg_ch = ch.value
            elif rc in (_MPG123_NEED_MORE, _MPG123_DONE):
                break
            elif rc != _MPG123_OK:
                raise ValueError(f"mpg123 decode error rc={rc}")
        if chunks:
            segments.append((b"".join(chunks), seg_ch))
        segments = [(b, c) for (b, c) in segments if b and c > 0]
        if not segments or rate.value <= 0:
            raise ValueError("no MP3 audio decoded")
        ch0 = segments[0][1]
        outs = []
        for raw, c in segments:
            flat = np.frombuffer(raw, "<f4")
            flat = flat[:len(flat) - len(flat) % c]
            x = np.ascontiguousarray(flat.reshape(-1, c).T)
            if c != ch0:
                x = x[:1].repeat(ch0, 0) if c < ch0 else x[:ch0]
            outs.append(x)
        x = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=1)
        if not np.isfinite(x).all():      # same policy as float WAV
            x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        return np.ascontiguousarray(x), int(rate.value)
    finally:
        lib.mpg123_delete(ctypes.c_void_p(h))


# --- header-walk probe (no audio decode) ---------------------------------

_RATES = {
    # (version_bits) -> rate table; version: 3=MPEG1, 2=MPEG2, 0=MPEG2.5
    3: (44100, 48000, 32000),
    2: (22050, 24000, 16000),
    0: (11025, 12000, 8000),
}
_BITRATES_V1_L3 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192,
                   224, 256, 320)
_BITRATES_V2_L3 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128,
                   144, 160)


@dataclass(frozen=True)
class Mp3Info:
    sample_rate: int
    num_frames: int          # PCM frames (samples per channel)
    num_channels: int
    num_mp3_frames: int


def _frame_at(data: bytes, pos: int):
    """Parse a Layer III frame header at ``pos``; None when invalid.
    Returns (sample_rate, channels, samples_per_frame, frame_len,
    version_bits, kbps)."""
    if pos + 4 > len(data):
        return None
    b0, b1, b2, b3 = data[pos:pos + 4]
    if b0 != 0xFF or (b1 & 0xE0) != 0xE0:
        return None
    version = (b1 >> 3) & 0x3              # 3=MPEG1 2=MPEG2 0=MPEG2.5
    layer = (b1 >> 1) & 0x3                # 1 = Layer III
    if version == 1 or layer != 1:
        return None
    br_idx = (b2 >> 4) & 0xF
    sr_idx = (b2 >> 2) & 0x3
    if br_idx in (0, 15) or sr_idx == 3:   # free-format/bad
        return None
    sr = _RATES[version][sr_idx]
    kbps = (_BITRATES_V1_L3 if version == 3 else _BITRATES_V2_L3)[br_idx]
    padding = (b2 >> 1) & 0x1
    spf = 1152 if version == 3 else 576
    frame_len = spf // 8 * kbps * 1000 // sr + padding
    if frame_len <= 4:
        return None
    mode = (b3 >> 6) & 0x3                 # 3 = mono
    return sr, (1 if mode == 3 else 2), spf, frame_len, version, kbps


def _id3v2_end(data: bytes) -> int:
    if len(data) >= 10 and data[:3] == b"ID3":
        size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) | \
               ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
        return 10 + size
    return 0


def _first_confirmed_frame(data: bytes, total: int):
    """(pos, header) of the first sync whose follower ALSO parses (or
    that ends exactly at EOF) — a lone 0xFFEx in leading junk must not
    lock the probe's rate/channels (truncated/lying ID3 sizes, APEv2
    tags and partial first frames all produce false syncs)."""
    pos = _id3v2_end(data)
    n = len(data)
    while pos + 4 <= n:
        hdr = _frame_at(data, pos)
        if hdr is None:
            pos += 1
            continue
        nxt = pos + hdr[3]
        if nxt == total or _frame_at(data, nxt) is not None:
            return pos, hdr
        pos += 1
    return None, None


def _xing_frame_count(data: bytes, pos: int, hdr) -> int:
    """Frame count from a Xing/Info/VBRI tag in the frame at ``pos``,
    or 0. Xing sits after the side info (MPEG1: 32B stereo / 17B mono;
    MPEG2/2.5: 17/9); VBRI is fixed at 32 bytes past the header."""
    _sr, channels, _spf, frame_len, version, _k = hdr
    side = (32 if channels == 2 else 17) if version == 3 else \
           (17 if channels == 2 else 9)
    off = pos + 4 + side
    if data[off:off + 4] in (b"Xing", b"Info"):
        flags = int.from_bytes(data[off + 4:off + 8], "big")
        if flags & 0x1 and len(data) >= off + 12:
            return int.from_bytes(data[off + 8:off + 12], "big")
    off = pos + 4 + 32
    if data[off:off + 4] == b"VBRI" and len(data) >= off + 18:
        return int.from_bytes(data[off + 14:off + 18], "big")
    return 0


_PROBE_HEAD = 1 << 18     # leading bytes a path probe reads first


def probe_mp3(path_or_bytes) -> Mp3Info:
    """(rate, channels, duration) without decoding audio.

    Fast paths that avoid reading the whole file (scan validation runs
    this per .mp3; WAV/OGG/FLAC probes read a few KiB):
    1. a Xing/Info/VBRI tag in the first frame gives the exact frame
       count;
    2. otherwise, if the first frames share one bitrate (CBR), the
       count is estimated from the file size (error < 0.5%, inside the
       scanner's duration-gate tolerance).
    VBR without a Xing tag falls back to walking every frame header.
    The first frame is double-sync confirmed (its follower must parse
    too) so junk bytes can't mislabel rate/channels. Durations do not
    subtract the encoder delay/padding (unknown without the LAME tag)
    — within ~2 frames, which the duration gates tolerate.
    """
    from pathlib import Path
    fh = None
    if isinstance(path_or_bytes, (str, Path)):
        p = Path(path_or_bytes)
        total = p.stat().st_size
        fh = p
        with p.open("rb") as f:
            data = f.read(min(total, _PROBE_HEAD))
    else:
        data = bytes(path_or_bytes)
        total = len(data)

    pos, hdr = _first_confirmed_frame(data, total)
    if pos is None and fh is not None and len(data) < total:
        data = fh.read_bytes()             # huge ID3 art / late sync
        pos, hdr = _first_confirmed_frame(data, total)
    if pos is None:
        raise ValueError("no MP3 frames found")
    sr, channels, spf, frame_len, _version, kbps = hdr

    count = _xing_frame_count(data, pos, hdr)
    if count > 0:
        return Mp3Info(sr, count * spf, channels, count)

    # CBR check over the frames visible in the head window.
    cbr = True
    q, seen = pos, 0
    while q + 4 <= len(data) and seen < 64:
        h = _frame_at(data, q)
        if h is None or h[0] != sr or h[5] != kbps:
            cbr = False
            break
        q += h[3]
        seen += 1
    if cbr and seen >= 8:
        tail = 128 if total >= pos + 128 else 0   # ID3v1 allowance
        avg_len = spf * kbps * 1000 / (8 * sr) + 0.5   # ~half padded
        frames = max(1, int((total - pos - tail) / avg_len))
        return Mp3Info(sr, frames * spf, channels, frames)

    # Full walk (VBR without Xing, or short/odd files).
    if fh is not None and len(data) < total:
        data = fh.read_bytes()
    n = len(data)
    frames = samples = 0
    while pos + 4 <= n:
        h = _frame_at(data, pos)
        if h is None:
            pos += 1
            continue
        if pos + h[3] > n:
            break
        frames += 1
        samples += h[2]
        pos += h[3]
    if frames == 0:
        raise ValueError("no MP3 frames found")
    return Mp3Info(sr, samples, channels, frames)


def looks_like_mp3(data: bytes) -> bool:
    """Container sniff for serving bodies: ID3v2 tag or a Layer III
    sync at the head."""
    if len(data) >= 3 and data[:3] == b"ID3":
        return True
    if len(data) >= 4 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0:
        return (data[1] >> 1) & 0x3 == 1   # layer III
    return False
