"""Opus packet / TOC parsing (RFC 6716 §3).

Splits a packet into its mode / bandwidth / frame duration / channel
configuration and the list of compressed frames (codes 0-3, CBR and
VBR, padding).  Pure function of the packet bytes.

Replaces the TOC handling libopus does in opus_decode_native /
opus_packet_parse; the reference stack never parses packets itself
(it shells audio out to ffmpeg, services/audio_processor.py:76-86).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


class OpusPacketError(ValueError):
    pass


# config -> (mode, bandwidth, frame_ms)
_CONFIG = {}
for _i, _bw in enumerate(("NB", "MB", "WB")):
    for _j, _ms in enumerate((10, 20, 40, 60)):
        _CONFIG[_i * 4 + _j] = ("silk", _bw, _ms)
for _i, _bw in enumerate(("SWB", "FB")):
    for _j, _ms in enumerate((10, 20)):
        _CONFIG[12 + _i * 2 + _j] = ("hybrid", _bw, _ms)
for _i, _bw in enumerate(("NB", "WB", "SWB", "FB")):
    for _j, _ms in enumerate((2.5, 5, 10, 20)):
        _CONFIG[16 + _i * 4 + _j] = ("celt", _bw, _ms)

# audio bandwidth -> SILK internal rate kHz / CELT effective end band
SILK_KHZ = {"NB": 8, "MB": 12, "WB": 16, "SWB": 16, "FB": 16}


@dataclass
class PacketInfo:
    mode: str              # 'silk' | 'hybrid' | 'celt'
    bandwidth: str         # NB MB WB SWB FB
    frame_ms: float
    frame_size: int        # samples per frame at 48 kHz
    stereo: bool
    frames: List[bytes]
    size: int = 0          # bytes consumed (self-delimited parse)


def _parse_self_delimited(data: bytes):
    """RFC 6716 Appendix B framing (opus_packet_parse_impl with
    self_delimited=1): one extra length field delimits the final
    frame; returns (PacketInfo, bytes_consumed incl. padding)."""
    if len(data) < 1:
        raise OpusPacketError("empty packet")
    toc = data[0]
    config, stereo, code = toc >> 3, bool((toc >> 2) & 1), toc & 3
    mode, bw, ms = _CONFIG[config]
    pos = 1
    length = len(data) - 1
    pad = 0
    sizes: List[int] = []
    cbr = False
    if code == 0:
        count = 1
    elif code == 1:
        count = 2
        cbr = True
    elif code == 2:
        count = 2
        n0, pos2 = _frame_len(data, pos)
        length -= pos2 - pos
        pos = pos2
        if n0 > length:
            raise OpusPacketError("code-2 first frame overruns packet")
        sizes = [n0]
    else:
        if length < 1:
            raise OpusPacketError("code-3 packet without count byte")
        ch = data[pos]
        pos += 1
        length -= 1
        count = ch & 0x3F
        if not 1 <= count <= 48 or count * ms > 120:
            raise OpusPacketError(f"bad code-3 frame count {count}")
        if ch & 0x40:
            while True:
                if length <= 0:
                    raise OpusPacketError("truncated padding length")
                p = data[pos]
                pos += 1
                length -= 1
                tmp = 254 if p == 255 else p
                length -= tmp
                pad += tmp
                if p != 255:
                    break
        if length < 0:
            raise OpusPacketError("padding overruns packet")
        cbr = not (ch & 0x80)
        if not cbr:
            for _ in range(count - 1):
                n, pos2 = _frame_len(data, pos)
                length -= pos2 - pos
                pos = pos2
                if n > length:
                    raise OpusPacketError("VBR frame overruns packet")
                sizes.append(n)
    # the extra self-delimiting size for the last frame
    nlast, pos2 = _frame_len(data, pos)
    length -= pos2 - pos
    pos = pos2
    if nlast > length:
        raise OpusPacketError("self-delimited size overruns packet")
    if cbr:
        if nlast * count > length:
            raise OpusPacketError("CBR frames overrun packet")
        sizes = [nlast] * (count - 1)
    if sum(sizes) + nlast > length:
        raise OpusPacketError("frames overrun packet")
    sizes.append(nlast)
    frames = []
    for n in sizes:
        frames.append(bytes(data[pos:pos + n]))
        pos += n
    return (PacketInfo(mode, bw, ms, int(48 * ms), stereo, frames),
            pos + pad)


def _frame_len(data: bytes, pos: int):
    if pos >= len(data):
        raise OpusPacketError("truncated frame length")
    b = data[pos]
    if b < 252:
        return b, pos + 1
    if pos + 1 >= len(data):
        raise OpusPacketError("truncated 2-byte frame length")
    return 4 * data[pos + 1] + b, pos + 2


def parse_packet(data: bytes, self_delimited: bool = False
                 ) -> PacketInfo:
    """RFC 6716 §3.2: packet -> frames.

    With ``self_delimited`` True, parses the Appendix-B framing used
    by all but the last stream of a multistream packet (one extra
    length field delimits the otherwise-implicit final frame); the
    bytes consumed are recorded in ``PacketInfo.size``."""
    if self_delimited:
        info, size = _parse_self_delimited(data)
        info.size = size
        return info
    if len(data) < 1:
        raise OpusPacketError("empty packet")
    toc = data[0]
    config, stereo, code = toc >> 3, bool((toc >> 2) & 1), toc & 3
    mode, bw, ms = _CONFIG[config]
    frame_size = int(48 * ms)
    body = data[1:]

    if code == 0:
        if len(body) > 1275:
            raise OpusPacketError("frame exceeds 1275 bytes")
        frames = [bytes(body)]
    elif code == 1:
        if len(body) % 2:
            raise OpusPacketError("code-1 packet with odd payload")
        h = len(body) // 2
        if h > 1275:
            raise OpusPacketError("frame exceeds 1275 bytes")
        frames = [bytes(body[:h]), bytes(body[h:])]
    elif code == 2:
        n1, pos = _frame_len(data, 1)
        if n1 > len(data) - pos:
            raise OpusPacketError("code-2 first frame overruns packet")
        if len(data) - pos - n1 > 1275:
            raise OpusPacketError("frame exceeds 1275 bytes")
        frames = [bytes(data[pos:pos + n1]), bytes(data[pos + n1:])]
    else:
        if len(body) < 1:
            raise OpusPacketError("code-3 packet without count byte")
        c = body[0]
        vbr, padding, count = bool(c & 0x80), bool(c & 0x40), c & 0x3F
        if not 1 <= count <= 48 or count * ms > 120:
            raise OpusPacketError(f"bad code-3 frame count {count}")
        pos = 2  # absolute position in `data`
        end = len(data)
        if padding:
            pad = 0
            while True:
                if pos >= len(data):
                    raise OpusPacketError("truncated padding length")
                p = data[pos]
                pos += 1
                if p == 255:
                    pad += 254
                else:
                    pad += p
                    break
            if pad > len(data) - pos:
                raise OpusPacketError("padding overruns packet")
            end = len(data) - pad
        if vbr:
            lens = []
            for _ in range(count - 1):
                n, pos = _frame_len(data, pos)
                lens.append(n)
            total = sum(lens)
            if total > end - pos:
                raise OpusPacketError("VBR frames overrun packet")
            if end - pos - total > 1275:
                raise OpusPacketError("frame exceeds 1275 bytes")
            frames = []
            for n in lens:
                frames.append(bytes(data[pos:pos + n]))
                pos += n
            frames.append(bytes(data[pos:end]))
        else:
            avail = end - pos
            if avail % count:
                raise OpusPacketError("CBR payload not divisible")
            n = avail // count
            if n > 1275:
                raise OpusPacketError("frame exceeds 1275 bytes")
            frames = [bytes(data[pos + i * n:pos + (i + 1) * n])
                      for i in range(count)]
    return PacketInfo(mode, bw, ms, frame_size, stereo, frames)
