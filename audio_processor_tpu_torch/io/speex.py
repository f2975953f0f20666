"""Ogg/Speex ingest via the system libspeex.

BEYOND-REFERENCE in codec terms but inside the reference's *container*
surface: the reference pipes every ``.ogg`` through ffmpeg
(services/audio_processor.py:76-86), which decodes Ogg-Speex — a codec
telephony archives genuinely used before Opus replaced it. Decode goes
through libspeex (the Xiph reference implementation, the same decoder
behind ffmpeg's Speex path) driven by ctypes — in-process, no
subprocess, no temp files. Like MP3 (io/mp3.py) there is deliberately
NO first-party fallback: Speex is a legacy-ingest convenience, so an
absent libspeex raises a clean, actionable error instead of shipping a
CELP decoder outside the parity surface.

Layout notes (all verified against speex 1.2 headers):
- SpeexHeader is 80 little-endian bytes: magic(8) version(20)
  version_id(4) header_size(4) rate(4) mode(4) mode_bitstream_version(4)
  nb_channels(4) bitrate(4) frame_size(4) vbr(4) frames_per_packet(4)
  extra_headers(4) reserved(8).
- Stereo is in-band intensity stereo: the decoder needs the standard
  stereo request handler installed (SPEEX_SET_HANDLER/callback id 9),
  then ``speex_decode_stereo_int`` expands each mono frame in place.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

# speex.h control ids
SPEEX_SET_ENH = 0
SPEEX_GET_FRAME_SIZE = 3
SPEEX_SET_QUALITY = 4
SPEEX_SET_COMPLEXITY = 16
SPEEX_SET_HANDLER = 20
SPEEX_SET_SAMPLING_RATE = 24
SPEEX_INBAND_STEREO = 9

_MODE_NAMES = {0: "narrowband", 1: "wideband", 2: "ultra-wideband"}


class SpeexBits(ctypes.Structure):
    """speex_bits.h struct SpeexBits (1.2 ABI)."""

    _fields_ = [
        ("chars", ctypes.c_char_p),
        ("nbBits", ctypes.c_int),
        ("charPtr", ctypes.c_int),
        ("bitPtr", ctypes.c_int),
        ("owner", ctypes.c_int),
        ("overflow", ctypes.c_int),
        ("buf_size", ctypes.c_int),
        ("reserved1", ctypes.c_int),
        ("reserved2", ctypes.c_void_p),
    ]


class SpeexCallback(ctypes.Structure):
    """speex_callbacks.h struct SpeexCallback."""

    _fields_ = [
        ("callback_id", ctypes.c_int),
        ("func", ctypes.c_void_p),
        ("data", ctypes.c_void_p),
        ("reserved1", ctypes.c_void_p),
        ("reserved2", ctypes.c_int),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _libspeex() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        from audio_processor_tpu_torch.io._native_lib import load_first

        def configure(lib: ctypes.CDLL) -> None:
            lib.speex_lib_get_mode.restype = ctypes.c_void_p
            lib.speex_decoder_init.restype = ctypes.c_void_p
            lib.speex_decoder_init.argtypes = [ctypes.c_void_p]
            lib.speex_encoder_init.restype = ctypes.c_void_p
            lib.speex_encoder_init.argtypes = [ctypes.c_void_p]
            lib.speex_stereo_state_init.restype = ctypes.c_void_p

        _lib = load_first(["libspeex.so.1", "libspeex.so"], "speex",
                          configure)
    return _lib


def speex_available() -> bool:
    return _libspeex() is not None


@dataclass(frozen=True)
class SpeexHeader:
    rate: int
    mode: int                 # 0 NB / 1 WB / 2 UWB
    nb_channels: int
    frame_size: int           # samples per frame (per channel)
    vbr: int
    frames_per_packet: int
    extra_headers: int


def parse_speex_header(packet: bytes) -> SpeexHeader:
    if packet[:8] != b"Speex   " or len(packet) < 72:
        raise ValueError("not a Speex identification header")
    (version_id, _header_size, rate, mode, _mbv, nb_channels, _bitrate,
     frame_size, vbr, fpp, extra) = struct.unpack_from("<11i", packet, 28)
    if version_id > 1:
        raise ValueError(f"unsupported Speex version_id {version_id}")
    if mode not in _MODE_NAMES:
        raise ValueError(f"unsupported Speex mode {mode}")
    if nb_channels not in (1, 2):
        raise ValueError(f"unsupported Speex channel count {nb_channels}")
    if rate <= 0 or frame_size <= 0:
        raise ValueError("corrupt Speex header (rate/frame_size)")
    return SpeexHeader(rate=rate, mode=mode, nb_channels=nb_channels,
                       frame_size=frame_size, vbr=vbr,
                       frames_per_packet=max(1, fpp),
                       extra_headers=max(0, extra))


def _decode_segment(lib: ctypes.CDLL, data: bytes) -> Tuple[np.ndarray, int]:
    """One Ogg chain -> (interleaved int16 [N*C], header). Returns the
    PCM trimmed to the final page granule when it is usable."""
    from audio_processor_tpu_torch.io.ogg import ogg_packets

    it = ogg_packets(data, b"Speex   ")
    try:
        first, _ = next(it)
    except StopIteration:
        raise ValueError("no Ogg packets found")
    head = parse_speex_header(first)
    # Packet 1 is the Vorbis-style comment packet; extra_headers more
    # follow before audio (Ogg-Speex spec / speexdec.c).
    skip = 1 + head.extra_headers

    st = lib.speex_decoder_init(
        ctypes.c_void_p(lib.speex_lib_get_mode(head.mode)))
    if not st:
        raise RuntimeError("speex_decoder_init failed")
    stereo = None
    try:
        one = ctypes.c_int(1)
        lib.speex_decoder_ctl(ctypes.c_void_p(st), SPEEX_SET_ENH,
                              ctypes.byref(one))
        rate = ctypes.c_int(head.rate)
        lib.speex_decoder_ctl(ctypes.c_void_p(st),
                              SPEEX_SET_SAMPLING_RATE, ctypes.byref(rate))
        frame_size = ctypes.c_int(0)
        lib.speex_decoder_ctl(ctypes.c_void_p(st), SPEEX_GET_FRAME_SIZE,
                              ctypes.byref(frame_size))
        n_frame = frame_size.value or head.frame_size
        if head.nb_channels == 2:
            stereo = lib.speex_stereo_state_init()
            if not stereo:
                # NULL here would be dereferenced inside libspeex on
                # the first in-band stereo request — a segfault, not
                # an exception.
                raise RuntimeError("speex_stereo_state_init failed")
            cb = SpeexCallback(
                callback_id=SPEEX_INBAND_STEREO,
                func=ctypes.cast(lib.speex_std_stereo_request_handler,
                                 ctypes.c_void_p).value,
                data=stereo)
            lib.speex_decoder_ctl(ctypes.c_void_p(st), SPEEX_SET_HANDLER,
                                  ctypes.byref(cb))

        bits = SpeexBits()
        lib.speex_bits_init(ctypes.byref(bits))
        buf = (ctypes.c_int16 * (n_frame * head.nb_channels))()
        chunks = []
        last_granule = None
        try:
            for i, (packet, granule) in enumerate(it):
                if granule is not None and granule >= 0:
                    last_granule = granule
                if i < skip or not packet:
                    continue
                lib.speex_bits_read_from(ctypes.byref(bits), packet,
                                         len(packet))
                for _ in range(head.frames_per_packet):
                    rc = lib.speex_decode_int(ctypes.c_void_p(st),
                                              ctypes.byref(bits),
                                              buf)
                    if rc == -1:        # end of stream
                        break
                    if rc == -2:
                        raise ValueError("corrupt Speex stream")
                    if head.nb_channels == 2:
                        lib.speex_decode_stereo_int(
                            buf, n_frame, ctypes.c_void_p(stereo))
                    chunks.append(np.frombuffer(buf, np.int16).copy())
        finally:
            lib.speex_bits_destroy(ctypes.byref(bits))
        if not chunks:
            raise ValueError("no Speex audio decoded")
        pcm = np.concatenate(chunks)
        if last_granule is not None and \
                0 < last_granule * head.nb_channels < len(pcm):
            pcm = pcm[:last_granule * head.nb_channels]
        return pcm, head
    finally:
        if stereo:
            lib.speex_stereo_state_destroy(ctypes.c_void_p(stereo))
        lib.speex_decoder_destroy(ctypes.c_void_p(st))


def decode_speex(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Ogg-Speex -> ([C, N] float32 in [-1, 1], sample_rate).

    Chained files (RFC 3533 §3 concatenation) are appended like the
    other Ogg decoders: later chains are channel-conformed to the
    first (io/opus.py's policy) and a mid-chain sample-rate change
    raises — the pipeline's resampler keys on one rate per file
    (io/vorbis.py decode_vorbis's policy)."""
    lib = _libspeex()
    if lib is None:
        raise RuntimeError(
            "Speex decode needs the system libspeex (apt install "
            "libspeex1); Ogg-Speex ingest is an optional "
            "beyond-reference path with no first-party fallback")
    if isinstance(path_or_bytes, (str, Path)):
        data = Path(path_or_bytes).read_bytes()
    else:
        data = bytes(path_or_bytes)
    from audio_processor_tpu_torch.io.ogg import chain_segments

    outs = []
    rate0 = ch0 = None
    for seg in chain_segments(data, b"Speex   "):
        pcm, head = _decode_segment(lib, seg)
        if rate0 is None:
            rate0, ch0 = head.rate, head.nb_channels
        elif head.rate != rate0:
            raise ValueError(
                f"chained Ogg-Speex rate change ({rate0} -> "
                f"{head.rate} Hz); one rate per file")
        x = pcm.astype(np.float32) / 32768.0
        x = x.reshape(-1, head.nb_channels).T
        if head.nb_channels != ch0:
            x = x[:1].repeat(ch0, 0) if head.nb_channels < ch0 else x[:ch0]
        outs.append(x)
    out = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=1)
    return np.ascontiguousarray(np.clip(out, -1.0, 1.0)), int(rate0)
