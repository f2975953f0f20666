"""In-process Ogg/Opus decode via the system ``libopus``.

The reference decodes every non-WAV container by shelling out to an
``ffmpeg`` subprocess (services/audio_processor.py:76-86). The TPU
build decodes Vorbis payloads fully first-party (io/vorbis.py,
native/vorbis.cpp); Opus payloads decode IN PROCESS here: the Ogg
container layer (page/packet demux, granule math, pre-skip and
end-trim semantics per RFC 7845) is first-party and shared with the
Vorbis decoder, and the Opus frame decode itself binds the system
``libopus`` through ctypes — no subprocess, no ffmpeg binary, no
temp files.

Channel mapping families 0 (mono/stereo — the call-center format) and
1 (Vorbis-order surround, via the multistream API) are supported.

Output: ([channels, frames] float32 in [-1, 1], 48000). Opus always
decodes at 48 kHz regardless of the encoder's input rate; downstream
resampling (dsp/resample.py) handles the 16 kHz ASR rate exactly as
it does for 44.1 kHz Vorbis output.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

# Maximum samples in one Opus packet: 120 ms at 48 kHz.
_MAX_FRAME = 5760
_SR = 48000


class OpusError(Exception):
    pass


_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    name = ctypes.util.find_library("opus")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
        lib.opus_decoder_create.restype = ctypes.c_void_p
        lib.opus_decoder_create.argtypes = [
            ctypes.c_int32, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.opus_decode_float.restype = ctypes.c_int
        lib.opus_decode_float.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
        lib.opus_multistream_decoder_create.restype = ctypes.c_void_p
        lib.opus_multistream_decoder_create.argtypes = [
            ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.opus_multistream_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.opus_multistream_decode_float.restype = ctypes.c_int
        lib.opus_multistream_decode_float.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
        # Packet duration from the TOC byte alone (no decode) — the
        # basis of the seek index (decode_opus_range).
        lib.opus_packet_get_nb_samples.restype = ctypes.c_int
        lib.opus_packet_get_nb_samples.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    """True when the system libopus can be loaded."""
    return _load() is not None


class OpusHead:
    """Parsed identification header (RFC 7845 §5.1)."""

    def __init__(self, packet: bytes):
        if packet[:8] != b"OpusHead" or len(packet) < 19:
            raise OpusError("not an OpusHead packet")
        self.version = packet[8]
        if self.version >> 4 != 0:  # major version must be 0
            raise OpusError(f"unsupported OpusHead version {self.version}")
        self.channels = packet[9]
        if self.channels < 1:
            raise OpusError("OpusHead: zero channels")
        self.pre_skip = struct.unpack_from("<H", packet, 10)[0]
        self.input_sample_rate = struct.unpack_from("<I", packet, 12)[0]
        self.output_gain_q8 = struct.unpack_from("<h", packet, 16)[0]
        self.mapping_family = packet[18]
        if self.mapping_family == 0:
            if self.channels > 2:
                raise OpusError(
                    "mapping family 0 allows at most 2 channels")
            self.stream_count = 1
            self.coupled_count = self.channels - 1
            self.mapping = bytes(range(self.channels))
        else:
            if len(packet) < 21 + self.channels:
                raise OpusError("truncated channel mapping table")
            self.stream_count = packet[19]
            self.coupled_count = packet[20]
            self.mapping = packet[21:21 + self.channels]
            if self.stream_count < 1 or \
                    self.coupled_count > self.stream_count:
                raise OpusError("invalid stream/coupled counts")
            nout = self.stream_count + self.coupled_count
            if any(m != 255 and m >= nout for m in self.mapping):
                raise OpusError("channel mapping index out of range")


class _Decoder:
    """RAII wrapper over opus(_multistream)_decoder."""

    def __init__(self, head: OpusHead):
        lib = _load()
        if lib is None:
            raise OpusError("libopus not available")
        self._lib = lib
        self._head = head
        err = ctypes.c_int(0)
        if head.mapping_family == 0:
            self._ptr = lib.opus_decoder_create(
                _SR, head.channels, ctypes.byref(err))
            self._multi = False
        else:
            self._ptr = lib.opus_multistream_decoder_create(
                _SR, head.channels, head.stream_count,
                head.coupled_count, bytes(head.mapping),
                ctypes.byref(err))
            self._multi = True
        if not self._ptr or err.value != 0:
            raise OpusError(f"decoder create failed (err={err.value})")
        self._buf = np.empty(_MAX_FRAME * head.channels, np.float32)
        self._cbuf = self._buf.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float))

    def decode(self, packet: bytes) -> np.ndarray:
        """One packet -> [n, channels] float32 (a copy)."""
        fn = (self._lib.opus_multistream_decode_float if self._multi
              else self._lib.opus_decode_float)
        n = fn(self._ptr, packet, len(packet), self._cbuf,
               _MAX_FRAME, 0)
        if n < 0:
            raise OpusError(f"opus_decode_float failed (err={n})")
        ch = self._head.channels
        return self._buf[:n * ch].reshape(n, ch).copy()

    def close(self):
        if getattr(self, "_ptr", None):
            if self._multi:
                self._lib.opus_multistream_decoder_destroy(self._ptr)
            else:
                self._lib.opus_decoder_destroy(self._ptr)
            self._ptr = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class _FallbackDecoder:
    """First-party decoder with the _Decoder interface, used when the
    system libopus is unavailable (mapping families 0 and 1).
    SILK-mode streams decode bit-exactly vs libopus; see
    audio_processor_tpu/io/opusdec/."""

    def __init__(self, head: "OpusHead"):
        from audio_processor_tpu_torch.io.opusdec.decoder import (
            OpusDecoder, OpusMSDecoder)
        if head.mapping_family == 0:
            self._dec = OpusDecoder(head.channels)
        else:
            self._dec = OpusMSDecoder(head.channels,
                                      head.stream_count,
                                      head.coupled_count,
                                      head.mapping)

    def decode(self, packet: bytes) -> np.ndarray:
        return self._dec.decode(packet)

    def close(self):
        self._dec = None


def _make_decoder(head: "OpusHead"):
    return _Decoder(head) if _load() is not None \
        else _FallbackDecoder(head)


def _packet_nb_samples(packet: bytes) -> int:
    """48 kHz duration of one packet from the TOC (+ code-3 count
    byte) alone — opus_packet_get_nb_samples semantics.  Deliberately
    does NOT validate the framing: multistream packets concatenate
    several elementary streams after the first TOC, which a full
    parse would reject even though the duration is well-defined."""
    if len(packet) < 1:
        raise OpusError("empty packet")
    toc = packet[0]
    config, code = toc >> 3, toc & 3
    if config < 12:
        frame_size = (480, 960, 1920, 2880)[config & 3]  # SILK

    elif config < 16:
        frame_size = (480, 960)[config & 1]       # hybrid: 10/20 ms
    else:
        frame_size = 120 << (config & 3)          # CELT: 2.5-20 ms
    if code == 0:
        count = 1
    elif code in (1, 2):
        count = 2
    else:
        if len(packet) < 2:
            raise OpusError("truncated code-3 packet")
        count = packet[1] & 0x3F
        if count < 1:
            raise OpusError("invalid code-3 frame count")
    return frame_size * count


def _ogg_opus_packets(data: bytes):
    """(packet, page_granule_or_None) pairs for the first Opus stream.

    The granule is attached to the LAST packet completed on each page
    (Ogg granule semantics); intermediate packets get None."""
    pos = 0
    serial = None
    partial = b""
    n = len(data)
    while pos + 27 <= n:
        if data[pos:pos + 4] != b"OggS":
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
            # Bind to the first stream whose BOS packet is OpusHead.
            first = data[body:body + (seg_table[0] if n_segs else 0)]
            if (header_type & 0x2) and not first.startswith(b"OpusHead"):
                pos = body + sum(seg_table)
                continue
            serial = page_serial
        if page_serial != serial:
            pos = body + sum(seg_table)
            continue
        if not (header_type & 0x1):
            partial = b""
        off = body
        # Index of the last segment that completes a packet, so the
        # page granule can be attached to that packet.
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


def _parse_stream(data: bytes):
    """-> (OpusHead, [(audio_packet, page_granule_or_None), ...])."""
    it = _ogg_opus_packets(data)
    try:
        first, _ = next(it)
    except StopIteration:
        raise OpusError("no Ogg packets found")
    head = OpusHead(first)
    try:
        tags, _ = next(it)  # OpusTags (RFC 7845 §5.2), unused
    except StopIteration:
        raise OpusError("missing OpusTags packet")
    if tags[:8] != b"OpusTags":
        raise OpusError("second packet is not OpusTags")
    return head, [(p, g) for p, g in it if p]


def _finish(pcm: np.ndarray, head: OpusHead) -> np.ndarray:
    if head.output_gain_q8:
        pcm = pcm * (10.0 ** (head.output_gain_q8 / (20.0 * 256.0)))
    return np.ascontiguousarray(np.clip(pcm.T, -1.0, 1.0))


def _chain_segments(data: bytes) -> List[bytes]:
    """One byte segment per Opus chain (RFC 7845 §4); see
    io/ogg.py chain_segments for the boundary rule."""
    from audio_processor_tpu_torch.io.ogg import chain_segments
    return chain_segments(data, b"OpusHead")


def _conform_channels(pcm: np.ndarray, ch: int) -> np.ndarray:
    """Match a later chain's [C, N] output to the first chain's
    channel count: duplicate mono up, average down."""
    c = pcm.shape[0]
    if c == ch:
        return pcm
    if c == 1:
        return np.repeat(pcm, ch, axis=0)
    if ch == 1:
        return np.ascontiguousarray(
            pcm.mean(axis=0, keepdims=True).astype(pcm.dtype))
    if c > ch:
        return np.ascontiguousarray(pcm[:ch])
    return np.concatenate(
        [pcm, np.repeat(pcm[-1:], ch - c, axis=0)], axis=0)


def _decode_chain(data: bytes) -> np.ndarray:
    """One logical Opus stream -> [C, N] float32 (trimmed, gained)."""
    head, packets = _parse_stream(data)
    dec = _make_decoder(head)
    try:
        parts: List[np.ndarray] = []
        last_granule: Optional[int] = None
        for packet, granule in packets:
            parts.append(dec.decode(packet))
            if granule is not None and granule >= 0:
                last_granule = granule
    finally:
        dec.close()

    if not parts:
        raise OpusError("no audio packets")
    pcm = np.concatenate(parts, axis=0)  # [N, ch] at 48 kHz
    # Trim: drop pre_skip from the start; the final granule counts
    # samples INCLUDING pre_skip, so valid length = granule - pre_skip.
    start = min(head.pre_skip, pcm.shape[0])
    end = pcm.shape[0]
    if last_granule is not None:
        end = min(end, last_granule)
    return _finish(pcm[start:end], head)


def decode_opus(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Decode an Ogg/Opus file or byte buffer.

    Returns ([channels, frames] float32 in [-1, 1], 48000), with
    RFC 7845 pre-skip dropped, the tail trimmed to the final page's
    granule position, and the header output gain applied. Chained
    streams decode end to end (each chain applies its own pre-skip/
    granule trim and gain; later chains are channel-conformed to the
    first)."""
    if isinstance(path_or_bytes, (str, Path)):
        data = Path(path_or_bytes).read_bytes()
    else:
        data = bytes(path_or_bytes)
    segs = _chain_segments(data)
    out = _decode_chain(segs[0])
    if len(segs) == 1:
        return out, _SR
    chained = [out] + [
        _conform_channels(_decode_chain(s), out.shape[0])
        for s in segs[1:]]
    return np.ascontiguousarray(np.concatenate(chained, axis=1)), _SR


def decode_opus_stream(path_or_bytes):
    """Streaming decode: (48000, iterator of [C, n] float32 blocks).

    Concatenating the blocks equals decode_opus exactly; peak memory
    is one packet's PCM. Pre-skip / end-granule trims are applied per
    block in raw-sample coordinates (granules come from a header-only
    page scan before any decode). Chained streams yield each chain's
    blocks in sequence, channel-conformed to the first chain."""
    if isinstance(path_or_bytes, (str, Path)):
        data = Path(path_or_bytes).read_bytes()
    else:
        data = bytes(path_or_bytes)
    segs = _chain_segments(data)
    first_head, _ = _parse_stream(segs[0])
    out_ch = first_head.channels

    def chain_gen(seg):
        head, packets = _parse_stream(seg)
        last_granule = None
        for _, g in packets:
            if g is not None and g >= 0:
                last_granule = g
        dec = _make_decoder(head)
        try:
            pos = 0                      # raw samples decoded so far
            for packet, _ in packets:
                pcm = dec.decode(packet)
                lo = max(0, head.pre_skip - pos)
                hi = pcm.shape[0]
                if last_granule is not None:
                    hi = min(hi, max(0, last_granule - pos))
                pos += pcm.shape[0]
                if lo < hi:
                    yield _conform_channels(
                        _finish(pcm[lo:hi], head), out_ch)
        finally:
            dec.close()

    def gen():
        for seg in segs:
            yield from chain_gen(seg)

    return _SR, gen()


def decode_opus_range(path_or_bytes, start_sample: int,
                      num_samples: Optional[int] = None,
                      preroll_samples: int = 23040
                      ) -> Tuple[np.ndarray, int]:
    """Seek + decode one PCM range -> ([C, n] float32, 48000).

    Positions are in decode_opus's output space (48 kHz, pre-skip
    removed, granule-trimmed). Packet positions come from the TOC
    byte (opus_packet_get_nb_samples) with no decoding; a fresh
    decoder starts ``preroll_samples`` before the range (default
    480 ms — 6x the RFC 7845 §4.4 minimum pre-roll; measured decoder
    convergence: 160 ms -> ~2e-2 error, 320 ms -> ~1e-4,
    480 ms -> ~6e-7) so the codec state converges before the first
    kept sample. Output therefore matches the same slice of a full
    decode to float tolerance, not bit-exactly (a seek clamped to
    packet 0 is bit-exact)."""
    if isinstance(path_or_bytes, (str, Path)):
        data = Path(path_or_bytes).read_bytes()
    else:
        data = bytes(path_or_bytes)
    segs = _chain_segments(data)
    if len(segs) > 1:
        # Chained file: TOC-index seeking assumes one contiguous
        # packet timeline, so fall back to a full decode + slice
        # (correct, linear cost; chained seeks are an exotic case).
        full, _ = decode_opus(data)
        stop = full.shape[1] if num_samples is None \
            else min(full.shape[1], max(0, start_sample) + num_samples)
        lo = min(max(0, start_sample), stop)
        return np.ascontiguousarray(full[:, lo:stop]), _SR
    head, packets = _parse_stream(data)
    lib = _load()

    # TOC-byte duration index: raw-space start position of each packet.
    starts = np.empty(len(packets) + 1, np.int64)
    starts[0] = 0
    last_granule: Optional[int] = None
    for i, (packet, granule) in enumerate(packets):
        if lib is not None:
            n = lib.opus_packet_get_nb_samples(packet, len(packet), _SR)
        else:
            try:
                n = _packet_nb_samples(packet)
            except ValueError as e:
                raise OpusError(f"bad packet at index {i}: {e}") from e
        if n < 0:
            raise OpusError(f"bad packet TOC at index {i} (err={n})")
        starts[i + 1] = starts[i] + n
        if granule is not None and granule >= 0:
            last_granule = granule
    total_raw = int(starts[-1])
    end_raw = total_raw if last_granule is None \
        else min(total_raw, last_granule)

    out_len = max(0, end_raw - head.pre_skip)
    start_sample = max(0, start_sample)
    stop = out_len if num_samples is None \
        else min(out_len, start_sample + num_samples)
    start_sample = min(start_sample, stop)
    ch = head.channels
    if start_sample >= stop:
        return np.zeros((ch, 0), np.float32), _SR

    raw_lo = start_sample + head.pre_skip
    raw_hi = stop + head.pre_skip
    import bisect

    first = max(0, bisect.bisect_right(
        starts, max(0, raw_lo - preroll_samples)) - 1)
    dec = _make_decoder(head)
    try:
        parts: List[np.ndarray] = []
        pos = int(starts[first])
        for packet, _ in packets[first:]:
            pcm = dec.decode(packet)
            lo = max(0, raw_lo - pos)
            hi = min(pcm.shape[0], raw_hi - pos)
            pos += pcm.shape[0]
            if lo < hi:
                parts.append(pcm[lo:hi])
            if pos >= raw_hi:
                break
    finally:
        dec.close()
    pcm = np.concatenate(parts, axis=0) if parts \
        else np.zeros((0, ch), np.float32)
    return _finish(pcm, head), _SR
