"""First-party FLAC decoder (pure Python + numpy, no libFLAC).

BEYOND-REFERENCE in extension terms but inside the reference's decode
reach: the reference pipes non-WAV audio through ffmpeg
(services/audio_processor.py:76-86), which decodes FLAC — the standard
lossless archive format for call recordings. This module implements
the full FLAC bitstream (frames with CRC-8/CRC-16 verification,
CONSTANT / VERBATIM / FIXED 0-4 / LPC 1-32 subframes, RICE and RICE2
residual partitions including escape codes, wasted bits, and the
left-side / right-side / mid-side stereo decorrelations) plus the
Ogg-FLAC mapping (RFC 5334), and verifies the STREAMINFO MD5 over the
decoded samples when present.

Layout mirrors the format spec's decoder stages (RFC 9639), not any
particular implementation. Validation: losslessness against the
first-party test encoder across the full subframe/stereo/bps matrix,
cross-checked sample-exact against pygame/SDL's dr_flac on the same
fixtures (tests/test_flac.py).

Performance notes: rice partitions decode via a set-bit index walk
with batched value-bit gathers, FIXED predictors via exact int64
repeated cumsum; only LPC synthesis is a per-sample loop (exact
integer semantics: the >> shift truncation feeds back).
"""

from __future__ import annotations

import hashlib
import logging
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class FlacError(ValueError):
    pass


class _Truncated(FlacError):
    """Bit reader ran past its window — either the stream really is
    truncated, or the frame is larger than the decode-window
    heuristic (spec-valid rice codes have unbounded unary quotients);
    _decode_frame retries once with the full remaining stream."""


_BLOCK_SIZE_CODES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                     8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                     13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATE_CODES = {1: 88200, 2: 176400, 3: 192000, 4: 8000,
                      5: 16000, 6: 22050, 7: 24000, 8: 32000,
                      9: 44100, 10: 48000, 11: 96000}
_SAMPLE_SIZE_CODES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_CRC8_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = ((_c << 1) ^ 0x07) & 0xFF if _c & 0x80 else (_c << 1) & 0xFF
    _CRC8_TABLE.append(_c)

_CRC16_TABLE = []
for _i in range(256):
    _c = _i << 8
    for _ in range(8):
        _c = ((_c << 1) ^ 0x8005) & 0xFFFF if _c & 0x8000 \
            else (_c << 1) & 0xFFFF
    _CRC16_TABLE.append(_c)


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8_TABLE[c ^ b]
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC16_TABLE[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF)
    return c


@dataclass(frozen=True)
class StreamInfo:
    min_block: int
    max_block: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int          # 0 = unknown
    md5: bytes


def parse_streaminfo(block: bytes) -> StreamInfo:
    if len(block) < 34:
        raise FlacError("short STREAMINFO")
    min_block, max_block = struct.unpack_from(">HH", block, 0)
    packed = int.from_bytes(block[10:18], "big")
    sample_rate = packed >> 44
    channels = ((packed >> 41) & 0x7) + 1
    bps = ((packed >> 36) & 0x1F) + 1
    total = packed & ((1 << 36) - 1)
    return StreamInfo(min_block, max_block, sample_rate, channels, bps,
                      total, block[18:34])


def _parse_metadata(data: bytes, pos: int) -> Tuple[StreamInfo, int]:
    """Walk metadata blocks from ``pos`` (after the fLaC marker);
    -> (StreamInfo, offset of the first frame)."""
    info = None
    while pos + 4 <= len(data):
        hdr = data[pos]
        is_last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + size]
        if btype == 0:
            info = parse_streaminfo(body)
        pos += 4 + size
        if is_last:
            break
    if info is None:
        raise FlacError("missing STREAMINFO")
    return info, pos


_POW2 = np.power(2.0, np.arange(62, -1, -1))  # float64-exact to 2^53 sums


class _FrameReader:
    """MSB-first bit reader over one frame's byte region.

    Fixed-width fields read via byte arithmetic; rice partitions via a
    set-bit index walk over an unpacked bit array (amortized O(set
    bits) per frame).
    """

    def __init__(self, data: bytes, byte_start: int, byte_bound: int):
        self.data = data
        self.base = byte_start
        chunk = np.frombuffer(data, np.uint8,
                              count=min(byte_bound, len(data)) - byte_start,
                              offset=byte_start)
        self.bits = np.unpackbits(chunk)
        self.ones = np.flatnonzero(self.bits)
        self.n_ones = len(self.ones)
        self.pos = 0                      # bit offset within chunk
        self.j = 0                        # index into self.ones

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        if p + n > len(self.bits):
            raise _Truncated("truncated frame")
        self.pos = p + n
        seg = self.bits[p:p + n]
        if n <= 62:
            return int(seg @ _POW2[62 - n + 1:])
        v = 0
        for b in seg:
            v = (v << 1) | int(b)
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if n and v >= (1 << (n - 1)) else v

    def read_signed_block(self, count: int, width: int) -> np.ndarray:
        """``count`` signed ints of ``width`` bits, vectorized."""
        if count == 0 or width == 0:
            return np.zeros(count, np.int64)
        p = self.pos
        if p + count * width > len(self.bits):
            raise _Truncated("truncated frame")
        self.pos = p + count * width
        seg = self.bits[p:p + count * width].reshape(count, width)
        vals = (seg @ _POW2[63 - width:]).astype(np.int64)
        sign = 1 << (width - 1)
        return np.where(vals >= sign, vals - (1 << width), vals)

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.base + (self.pos >> 3)

    def rice_partition(self, count: int, k: int) -> np.ndarray:
        """``count`` rice codes with parameter ``k`` -> zigzag-decoded
        int64 residuals."""
        if count == 0:
            return np.zeros(0, np.int64)
        ones = self.ones
        n_ones = self.n_ones
        # advance the set-bit pointer to >= pos (value bits of earlier
        # codes may themselves be set bits — skip them)
        j = self.j
        p0 = self.pos
        p = p0
        if j < n_ones and ones[j] < p:
            j = int(np.searchsorted(ones, p))
        T = np.empty(count, np.int64)  # terminator-bit index per code
        step = 1 + k
        for i in range(count):
            while True:
                if j >= n_ones:
                    raise _Truncated("truncated rice partition")
                t = ones[j]
                j += 1
                if t >= p:
                    break
            T[i] = t
            p = t + step
        if p > len(self.bits):
            raise _Truncated("truncated rice partition")
        self.pos = p
        self.j = j
        # quotient = gap between each code's start and its terminator
        starts = np.empty(count, np.int64)
        starts[0] = p0
        starts[1:] = T[:-1] + step
        q = T - starts
        if k:
            idx = T[:, None] + 1 + np.arange(k)
            vb = self.bits[idx]
            vals = (vb @ _POW2[63 - k:]).astype(np.int64)
        else:
            vals = np.zeros(count, np.int64)
        u = (q << k) | vals
        return (u >> 1) ^ -(u & 1)


def _utf8_coded(r: _FrameReader) -> int:
    """FLAC's extended UTF-8 coded frame/sample number."""
    b0 = r.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    if n < 1 or n > 6:
        raise FlacError("bad UTF-8 coded number")
    v = b0 & (mask - 1)
    for _ in range(n):
        c = r.read(8)
        if (c & 0xC0) != 0x80:
            raise FlacError("bad UTF-8 continuation")
        v = (v << 6) | (c & 0x3F)
    return v


def _fixed_predict(order: int, warmup: np.ndarray,
                   res: np.ndarray) -> np.ndarray:
    """Exact FIXED-predictor reconstruction via repeated cumsum."""
    if order == 0:
        return res.copy()
    diffs = [warmup.astype(np.int64)]
    for _ in range(order):
        diffs.append(np.diff(diffs[-1]))
    cur = res.astype(np.int64)
    for j in range(order, 0, -1):
        cur = diffs[j - 1][-1] + np.cumsum(cur)
    return np.concatenate([warmup, cur])


def _lpc_predict(order: int, shift: int, coefs: List[int],
                 warmup: np.ndarray, res: np.ndarray) -> np.ndarray:
    """Exact LPC reconstruction: x[i] = res[i] +
    ((sum coef[j] * x[i-1-j]) >> shift). The arithmetic-shift
    truncation feeds back, so this is a per-sample loop (Python ints:
    exact)."""
    n = order + len(res)
    out: List[int] = [int(v) for v in warmup]
    rl = res.tolist()
    cf = list(coefs)
    for i in range(len(rl)):
        acc = 0
        base = order + i
        for j, c in enumerate(cf):
            acc += c * out[base - 1 - j]
        out.append(rl[i] + (acc >> shift))
    try:
        return np.array(out, np.int64)
    except OverflowError:
        # Corrupt residuals can blow the predictor feedback past
        # int64 — wrap two's-complement (the frame dies at CRC-16;
        # valid streams never come near the bound).
        return np.array([((v + (1 << 63)) & ((1 << 64) - 1))
                         - (1 << 63) for v in out], np.int64)


def _read_subframe(r: _FrameReader, n: int, bps: int) -> np.ndarray:
    if r.read(1):
        raise FlacError("subframe padding bit set")
    sftype = r.read(6)
    wasted = 0
    if r.read(1):
        wasted = 1
        while r.read(1) == 0:
            wasted += 1
    eff = bps - wasted
    if eff <= 0:
        raise FlacError("wasted bits exceed sample size")
    if sftype == 0:                      # CONSTANT
        out = np.full(n, r.read_signed(eff), np.int64)
    elif sftype == 1:                    # VERBATIM
        out = r.read_signed_block(n, eff)
    elif 8 <= sftype <= 12:              # FIXED order 0-4
        order = sftype - 8
        warmup = r.read_signed_block(order, eff)
        res = _read_residual(r, n, order)
        out = _fixed_predict(order, warmup, res)
    elif sftype >= 32:                   # LPC order 1-32
        order = sftype - 31
        warmup = r.read_signed_block(order, eff)
        prec = r.read(4)
        if prec == 15:
            raise FlacError("invalid LPC precision escape")
        prec += 1
        shift = r.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coefs = [r.read_signed(prec) for _ in range(order)]
        res = _read_residual(r, n, order)
        out = _lpc_predict(order, shift, coefs, warmup, res)
    else:
        raise FlacError(f"reserved subframe type {sftype}")
    if wasted:
        out = out << wasted
    return out


def _read_residual(r: _FrameReader, n: int, order: int) -> np.ndarray:
    method = r.read(2)
    if method > 1:
        raise FlacError(f"reserved residual method {method}")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    po = r.read(4)
    n_part = 1 << po
    if n % n_part:
        raise FlacError("block size not divisible by partitions")
    chunks = []
    for i in range(n_part):
        cnt = (n >> po) - (order if i == 0 else 0)
        if cnt < 0:
            raise FlacError("partition smaller than predictor order")
        k = r.read(pbits)
        if k == escape:
            width = r.read(5)
            chunks.append(r.read_signed_block(cnt, width))
        else:
            chunks.append(r.rice_partition(cnt, k))
    return np.concatenate(chunks) if len(chunks) > 1 else chunks[0]


def _decode_frame(data: bytes, pos: int, info: StreamInfo
                  ) -> Tuple[np.ndarray, int, int, int]:
    """Decode one frame at byte offset ``pos``.

    -> (samples [n, channels] int32, sample_rate, bps, next_pos).

    The bit reader unpacks a bounded window (keeps per-frame work
    proportional to typical frame sizes, not the remaining file). A
    spec-valid frame CAN exceed it — rice unary quotients are
    unbounded — so a truncation inside the window retries once over
    the full remaining stream before declaring the data short."""
    # window sized from STREAMINFO max_block (~5 bytes/sample covers
    # 33-bit verbatim); the _Truncated retry below self-heals a lying
    # max_block, so undersizing is a perf bug, never a decode failure
    max_block = info.max_block if 0 < info.max_block <= 65535 else 65535
    bound = pos + 64 + info.channels * (max_block * 5 + 16)
    if bound < len(data):
        try:
            return _decode_frame_bounded(data, pos, info, bound)
        except _Truncated:
            pass
    return _decode_frame_bounded(data, pos, info, len(data))


def _decode_frame_bounded(data: bytes, pos: int, info: StreamInfo,
                          bound: int
                          ) -> Tuple[np.ndarray, int, int, int]:
    r = _FrameReader(data, pos, min(bound, len(data)))
    if r.read(14) != 0b11111111111110:
        raise FlacError(f"bad frame sync at byte {pos}")
    if r.read(1):
        raise FlacError("reserved frame header bit set")
    r.read(1)                            # blocking strategy
    bs_code = r.read(4)
    sr_code = r.read(4)
    ch_code = r.read(4)
    ss_code = r.read(3)
    if r.read(1):
        raise FlacError("reserved frame header bit set")
    _utf8_coded(r)
    if bs_code == 0:
        raise FlacError("reserved block size code 0")
    elif bs_code == 6:
        n = r.read(8) + 1
    elif bs_code == 7:
        n = r.read(16) + 1
    else:
        n = _BLOCK_SIZE_CODES[bs_code]
    if sr_code == 0:
        sr = info.sample_rate
    elif sr_code == 12:
        sr = r.read(8) * 1000
    elif sr_code == 13:
        sr = r.read(16)
    elif sr_code == 14:
        sr = r.read(16) * 10
    elif sr_code == 15:
        raise FlacError("invalid sample rate code")
    else:
        sr = _SAMPLE_RATE_CODES[sr_code]
    bps = info.bits_per_sample if ss_code == 0 \
        else _SAMPLE_SIZE_CODES.get(ss_code)
    if bps is None:
        raise FlacError(f"reserved sample size code {ss_code}")
    header_len = r.pos >> 3
    expect = crc8(data[pos:pos + header_len])
    got = r.read(8)
    if got != expect:
        raise FlacError(f"frame header CRC-8 mismatch at byte {pos}")

    if ch_code < 8:
        channels = ch_code + 1
        subs = [_read_subframe(r, n, bps) for _ in range(channels)]
    elif ch_code == 8:                   # left/side
        left = _read_subframe(r, n, bps)
        side = _read_subframe(r, n, bps + 1)
        subs = [left, left - side]
        channels = 2
    elif ch_code == 9:                   # right/side
        side = _read_subframe(r, n, bps + 1)
        right = _read_subframe(r, n, bps)
        subs = [right + side, right]
        channels = 2
    elif ch_code == 10:                  # mid/side
        mid = _read_subframe(r, n, bps)
        side = _read_subframe(r, n, bps + 1)
        mid = (mid << 1) | (side & 1)
        subs = [(mid + side) >> 1, (mid - side) >> 1]
        channels = 2
    else:
        raise FlacError(f"reserved channel assignment {ch_code}")

    r.align()
    end = r.byte_pos()
    if end + 2 > len(data):
        raise FlacError("truncated frame (missing CRC-16)")
    expect16 = crc16(data[pos:end])
    (got16,) = struct.unpack_from(">H", data, end)
    if got16 != expect16:
        raise FlacError(f"frame CRC-16 mismatch at byte {pos}")
    frame = np.stack(subs, axis=1).astype(np.int32)
    return frame, sr, bps, end + 2


def decode_flac_stream(data: bytes, info: StreamInfo, pos: int
                       ) -> Tuple[np.ndarray, int, int]:
    """Decode frames from ``pos`` to end -> ([n, C] int32, rate, bps).

    Stops cleanly at trailing non-FLAC bytes (ID3v1 tags and the
    like, which libFLAC/ffmpeg also tolerate) once the STREAMINFO
    sample count is reached."""
    frames = []
    sr = info.sample_rate
    bps = info.bits_per_sample
    n = len(data)
    decoded = 0
    while pos + 2 < n:
        if info.total_samples and decoded >= info.total_samples:
            break
        frame, sr, bps, pos = _decode_frame(data, pos, info)
        frames.append(frame)
        decoded += len(frame)
    if not frames:
        raise FlacError("no FLAC frames decoded")
    out = np.concatenate(frames, axis=0)
    if info.total_samples and len(out) > info.total_samples:
        out = out[:info.total_samples]
    return out, sr, bps


def _verify_md5(samples: np.ndarray, info: StreamInfo, bps: int):
    """STREAMINFO MD5 is over interleaved little-endian samples at the
    minimum byte width; verified when present and the sample count is
    complete (byte-aligned bit depths only)."""
    if info.md5 == b"\x00" * 16 or bps % 8 or not info.total_samples:
        return
    if len(samples) != info.total_samples:
        return
    width = bps // 8
    inter = samples.reshape(-1).astype("<i4").tobytes()
    if width == 4:
        raw = inter
    else:
        b = np.frombuffer(inter, np.uint8).reshape(-1, 4)
        raw = b[:, :width].tobytes()
    if hashlib.md5(raw).digest() != info.md5:
        raise FlacError("decoded audio fails the STREAMINFO MD5 check")


def _to_float(samples: np.ndarray, bps: int) -> np.ndarray:
    scale = float(1 << (bps - 1))
    x = samples.astype(np.float32).T / scale
    return np.ascontiguousarray(np.clip(x, -1.0, 1.0))


def _skip_id3v2(data: bytes) -> int:
    """Offset past a leading ID3v2 tag (0 when absent). libFLAC and
    ffmpeg both tolerate ID3v2-prefixed .flac files, so taggers that
    prepend one don't break ingest."""
    if len(data) < 10 or data[:3] != b"ID3":
        return 0
    size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) \
        | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
    off = 10 + size + (10 if data[5] & 0x10 else 0)  # footer flag
    return off if off < len(data) else 0


def decode_flac(path_or_bytes) -> Tuple[np.ndarray, int]:
    """FLAC file/bytes -> ([C, N] float32 in [-1, 1], sample_rate)."""
    if isinstance(path_or_bytes, (str, Path)):
        data = Path(path_or_bytes).read_bytes()
    else:
        data = bytes(path_or_bytes)
    if data[:4] == b"OggS":
        return _decode_ogg_flac(data)
    start = _skip_id3v2(data)
    if data[start:start + 4] != b"fLaC":
        raise FlacError("not a FLAC stream (missing fLaC marker)")
    info, pos = _parse_metadata(data, start + 4)
    samples, sr, bps = decode_flac_stream(data, info, pos)
    _verify_md5(samples, info, bps)
    return _to_float(samples, bps), sr


# ------------------------------------------------------ Ogg mapping

def parse_ogg_flac_header(packet: bytes) -> StreamInfo:
    """RFC 5334 / Ogg-FLAC mapping BOS packet: 0x7F 'FLAC' maj min
    nheaders(2BE) 'fLaC' STREAMINFO-block."""
    if packet[:5] != b"\x7fFLAC" or len(packet) < 51:
        raise FlacError("not an Ogg-FLAC identification packet")
    if packet[9:13] != b"fLaC":
        raise FlacError("Ogg-FLAC packet missing fLaC marker")
    return parse_streaminfo(packet[17:51])


def _decode_ogg_flac(data: bytes) -> Tuple[np.ndarray, int]:
    from audio_processor_tpu_torch.io.ogg import chain_segments, ogg_packets

    outs = []
    rate0 = ch0 = None
    for seg in chain_segments(data, b"\x7fFLAC"):
        it = ogg_packets(seg, b"\x7fFLAC")
        try:
            first, _ = next(it)
        except StopIteration:
            raise FlacError("no Ogg packets found")
        info = parse_ogg_flac_header(first)
        n_headers = struct.unpack_from(">H", first, 7)[0]
        body = bytearray()
        skipped = 0
        last_granule = None
        for pkt, granule in it:
            if granule is not None and granule >= 0:
                last_granule = granule
            # Header packets have the metadata-block layout; when the
            # count is 0 (unknown) they are identified by NOT starting
            # with a frame sync.
            if skipped < n_headers or (n_headers == 0 and len(pkt) >= 2
                                       and not (pkt[0] == 0xFF
                                                and (pkt[1] & 0xFC)
                                                == 0xF8)):
                skipped += 1
                continue
            body.extend(pkt)
        samples, sr, bps = decode_flac_stream(bytes(body), info, 0)
        if last_granule and 0 < last_granule < len(samples):
            samples = samples[:last_granule]
        x = _to_float(samples, bps)
        if rate0 is None:
            rate0, ch0 = sr, x.shape[0]
        elif sr != rate0:
            raise FlacError(
                f"chained Ogg-FLAC rate change ({rate0} -> {sr} Hz); "
                "one rate per file (io/vorbis.py's chain policy)")
        if x.shape[0] != ch0:
            x = x[:1].repeat(ch0, 0) if x.shape[0] < ch0 else x[:ch0]
        outs.append(x)
    out = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=1)
    return out, int(rate0)


# ----------------------------------------------------------- probing

def probe_flac(path_or_bytes):
    """Header-only probe -> AudioInfo (or raises FlacError)."""
    from audio_processor_tpu_torch.io.wav import AudioInfo

    if isinstance(path_or_bytes, (str, Path)):
        with open(path_or_bytes, "rb") as f:
            data = f.read(256 * 1024)
    else:
        data = bytes(path_or_bytes[:256 * 1024])
    start = _skip_id3v2(data)
    if data[start:start + 4] != b"fLaC":
        raise FlacError("not a FLAC stream")
    info, _ = _parse_metadata(data, start + 4)
    return AudioInfo(sample_rate=info.sample_rate,
                     num_frames=int(info.total_samples),
                     num_channels=info.channels,
                     bits_per_sample=info.bits_per_sample,
                     encoding="flac")
