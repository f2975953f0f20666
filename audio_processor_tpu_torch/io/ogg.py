"""First-party OGG container probing (no third-party decoder).

Parses OGG pages directly: reads the identification header of the
first logical stream (Vorbis, Opus or Speex) for channel count /
sample rate,
and the last page's granule position for duration — enough for scan
validation (channel/empty checks, services/pipeline.py:84-108) without
decoding audio.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional

from audio_processor_tpu_torch.io.wav import AudioInfo

_CAPTURE = b"OggS"


def _first_packet(data: bytes) -> Optional[bytes]:
    """Payload of the first page (contains the ID header)."""
    if data[:4] != _CAPTURE or len(data) < 27:
        return None
    n_segs = data[26]
    if len(data) < 27 + n_segs:
        return None
    seg_table = data[27:27 + n_segs]
    payload_len = sum(seg_table)
    start = 27 + n_segs
    return data[start:start + payload_len]


def chain_segments(data: bytes, bos_magic: bytes) -> list:
    """Split a possibly-chained Ogg byte stream (RFC 3533 §3:
    complete logical streams concatenated end to end) into one byte
    segment per chain of the codec identified by ``bos_magic``
    (b"OpusHead" / b"\\x01vorbis").

    A chain boundary is a BOS page whose first packet carries the
    magic, arriving after the current chain has produced at least one
    data page — BOS pages seen before any data page are *grouped*
    (concurrent) streams, which per-segment parsers skip by serial.
    ffmpeg (the reference's decode mechanism,
    services/audio_processor.py:76-86) plays chains seamlessly."""
    # Fast path: a chain needs a second BOS magic somewhere — one
    # C-speed find rejects the overwhelmingly common single-chain
    # case without walking pages (false positives in payload bytes
    # just fall through to the exact walk).
    first = data.find(bos_magic)
    if first < 0 or data.find(bos_magic, first + 1) < 0:
        return [data]
    bounds = []
    pos, n = 0, len(data)
    seen_data = False
    while pos + 27 <= n:
        if data[pos:pos + 4] != _CAPTURE:
            pos += 1
            continue
        header_type = data[pos + 5]
        n_segs = data[pos + 26]
        seg_table = data[pos + 27:pos + 27 + n_segs]
        body = pos + 27 + n_segs
        first = data[body:body + (seg_table[0] if n_segs else 0)]
        if (header_type & 0x2) and first.startswith(bos_magic):
            if seen_data:
                bounds.append(pos)
                seen_data = False
        elif not (header_type & 0x2):
            seen_data = True
        pos = body + sum(seg_table)
    segs = []
    prev = 0
    for b in bounds:
        segs.append(data[prev:b])
        prev = b
    segs.append(data[prev:])
    return segs


def ogg_packets(data: bytes, bos_magic: bytes):
    """(packet, page_granule_or_None) pairs for the first logical
    stream whose BOS packet starts with ``bos_magic``.

    Same walk as io/opus.py's Opus-specific iterator (granule attached
    to the LAST packet completed on each page, RFC 3533 §6); factored
    here so additional Ogg payloads (Speex, FLAC) share it."""
    pos = 0
    serial = None
    partial = b""
    n = len(data)
    while pos + 27 <= n:
        if data[pos:pos + 4] != _CAPTURE:
            pos += 1
            continue
        header_type = data[pos + 5]
        granule = int.from_bytes(data[pos + 6:pos + 14], "little",
                                 signed=True)
        page_serial = int.from_bytes(data[pos + 14:pos + 18], "little")
        n_segs = data[pos + 26]
        seg_table = data[pos + 27:pos + 27 + n_segs]
        body = pos + 27 + n_segs
        if serial is None:
            first = data[body:body + (seg_table[0] if n_segs else 0)]
            if (header_type & 0x2) and not first.startswith(bos_magic):
                pos = body + sum(seg_table)
                continue
            serial = page_serial
        if page_serial != serial:
            pos = body + sum(seg_table)
            continue
        if not (header_type & 0x1):
            partial = b""
        off = body
        last_complete = -1
        for i, seg in enumerate(seg_table):
            if seg < 255:
                last_complete = i
        for i, seg in enumerate(seg_table):
            partial += data[off:off + seg]
            off += seg
            if seg < 255:
                yield partial, (granule if i == last_complete else None)
                partial = b""
        pos = off


def _last_granule(data: bytes) -> Optional[int]:
    """Granule position of the last OGG page in the buffer."""
    idx = data.rfind(_CAPTURE)
    while idx >= 0:
        if idx + 27 <= len(data):
            version = data[idx + 4]
            if version == 0:
                (granule,) = struct.unpack_from("<q", data, idx + 6)
                if granule >= 0:
                    return granule
        idx = data.rfind(_CAPTURE, 0, idx)
    return None


def probe_ogg(path: str | Path) -> Optional[AudioInfo]:
    """Cheap probe: 64 KiB head + 64 KiB tail only. For chained
    files, num_frames reflects the LAST chain's granule (an
    undercount) — deliberate: scan validation needs channels and
    non-emptiness, not exact duration, and a chain-aware count would
    read the whole file. decode paths handle chains fully."""
    p = Path(path)
    size = p.stat().st_size
    with open(p, "rb") as f:
        head = f.read(64 * 1024)
        if size > 128 * 1024:
            f.seek(-64 * 1024, 2)
            tail = f.read()
        else:
            f.seek(0)
            tail = f.read()

    packet = _first_packet(head)
    if packet is None:
        return None

    channels = sample_rate = None
    pre_skip = 0
    encoding = None
    if packet[:7] == b"\x01vorbis" and len(packet) >= 30:
        # Vorbis ID header: version(4) channels(1) rate(4) ...
        channels = packet[11]
        (sample_rate,) = struct.unpack_from("<I", packet, 12)
        encoding = "vorbis"
    elif packet[:8] == b"OpusHead" and len(packet) >= 19:
        channels = packet[9]
        (pre_skip,) = struct.unpack_from("<H", packet, 10)
        # Opus granules are always 48 kHz regardless of input rate.
        sample_rate = 48000
        encoding = "opus"
    elif packet[:8] == b"Speex   " and len(packet) >= 68:
        # SpeexHeader (speex_header.h): rate @36, nb_channels @48.
        (sample_rate,) = struct.unpack_from("<i", packet, 36)
        (channels,) = struct.unpack_from("<i", packet, 48)
        encoding = "speex"
    elif packet[:5] == b"\x7fFLAC" and len(packet) >= 51:
        from audio_processor_tpu_torch.io.flac import parse_ogg_flac_header

        si = parse_ogg_flac_header(packet)
        channels = si.channels
        sample_rate = si.sample_rate
        encoding = "flac"
    else:
        return None
    if not channels or not sample_rate or channels < 0 or sample_rate < 0:
        return None

    granule = _last_granule(tail)
    num_frames = 0
    if granule is not None:
        num_frames = max(0, granule - (pre_skip if encoding == "opus"
                                       else 0))
    return AudioInfo(sample_rate=sample_rate, num_frames=int(num_frames),
                     num_channels=int(channels), bits_per_sample=0,
                     encoding=encoding)
