"""First-party Ogg/Vorbis-I decoder (pure Python + numpy).

Implements the Vorbis I specification end to end — Ogg packet
reassembly, LSb-first bitstream reading, codebook/huffman decode,
floor1 curve synthesis, residue decode (formats 0/1/2), channel
coupling, IMDCT and lapped windowing — replacing the reference's
ffmpeg-subprocess OGG path (services/audio_processor.py:76-86) with
code we own. Validated against SDL_mixer's decode of a real Vorbis
file (tests/test_vorbis.py).

This is the correctness reference; a C++ port for throughput is the
natural next step (io/native.py already hosts the WAV fast path).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


# ----------------------------------------------------------------------
# Ogg packet layer
# ----------------------------------------------------------------------

def ogg_packets(data: bytes):
    """Yield complete logical packets of the FIRST logical stream."""
    pos = 0
    serial = None
    partial = b""
    n = len(data)
    while pos + 27 <= n:
        if data[pos:pos + 4] != b"OggS":
            pos += 1
            continue
        header_type = data[pos + 5]
        page_serial = int.from_bytes(data[pos + 14:pos + 18], "little")
        n_segs = data[pos + 26]
        seg_table = data[pos + 27:pos + 27 + n_segs]
        body = pos + 27 + n_segs
        if serial is None:
            serial = page_serial
        if page_serial != serial:
            pos = body + sum(seg_table)
            continue
        if not (header_type & 0x1):
            partial = b""  # fresh packet starts this page
        off = body
        for i, seg in enumerate(seg_table):
            partial += data[off:off + seg]
            off += seg
            if seg < 255:
                yield partial
                partial = b""
        pos = off
    if partial:
        yield partial


class BitReader:
    """Vorbis bit packing: LSb of each byte first."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0          # bit position
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.nbits:
            raise EOFError("out of bits")
        out = 0
        got = 0
        pos = self.pos
        while got < n:
            byte = self.data[pos >> 3]
            bit_off = pos & 7
            take = min(8 - bit_off, n - got)
            chunk = (byte >> bit_off) & ((1 << take) - 1)
            out |= chunk << got
            got += take
            pos += take
        self.pos = pos
        return out

    def read_signed_flag(self) -> bool:
        return bool(self.read(1))


def ilog(x: int) -> int:
    """Vorbis ilog: position of the highest set bit (ilog(0) = 0)."""
    r = 0
    while x > 0:
        r += 1
        x >>= 1
    return r


def float32_unpack(x: int) -> float:
    mantissa = x & 0x1FFFFF
    sign = x & 0x80000000
    exponent = (x & 0x7FE00000) >> 21
    value = float(mantissa) * (2.0 ** (exponent - 788))
    return -value if sign else value


# ----------------------------------------------------------------------
# Codebooks
# ----------------------------------------------------------------------

class Codebook:
    def __init__(self, br: BitReader):
        if br.read(24) != 0x564342:
            raise ValueError("codebook sync lost")
        self.dimensions = br.read(16)
        self.entries = br.read(24)
        lengths = np.zeros(self.entries, np.int32)
        ordered = br.read(1)
        if not ordered:
            sparse = br.read(1)
            for i in range(self.entries):
                if sparse:
                    if br.read(1):
                        lengths[i] = br.read(5) + 1
                    else:
                        lengths[i] = 0   # unused entry
                else:
                    lengths[i] = br.read(5) + 1
        else:
            current_entry = 0
            current_length = br.read(5) + 1
            while current_entry < self.entries:
                number = br.read(ilog(self.entries - current_entry))
                lengths[current_entry:current_entry + number] = \
                    current_length
                current_entry += number
                current_length += 1
        self.lengths = lengths
        self._build_huffman()

        self.lookup_type = br.read(4)
        self.vq: Optional[np.ndarray] = None
        if self.lookup_type == 0:
            pass
        elif self.lookup_type in (1, 2):
            minimum = float32_unpack(br.read(32))
            delta = float32_unpack(br.read(32))
            value_bits = br.read(4) + 1
            sequence_p = br.read(1)
            if self.lookup_type == 1:
                lookup_values = _lookup1_values(self.entries,
                                                self.dimensions)
            else:
                lookup_values = self.entries * self.dimensions
            mults = np.array([br.read(value_bits)
                              for _ in range(lookup_values)], np.float64)
            vq = np.zeros((self.entries, self.dimensions), np.float64)
            if self.lookup_type == 1:
                for e in range(self.entries):
                    last = 0.0
                    idx_div = 1
                    for d in range(self.dimensions):
                        off = (e // idx_div) % lookup_values
                        v = mults[off] * delta + minimum + last
                        vq[e, d] = v
                        if sequence_p:
                            last = v
                        idx_div *= lookup_values
            else:
                for e in range(self.entries):
                    last = 0.0
                    for d in range(self.dimensions):
                        v = mults[e * self.dimensions + d] * delta \
                            + minimum + last
                        vq[e, d] = v
                        if sequence_p:
                            last = v
            self.vq = vq.astype(np.float32)
        else:
            raise ValueError(f"bad lookup type {self.lookup_type}")

    # ------------------------------------------------------------------
    def _build_huffman(self):
        """Assign codewords per spec 3.2.1: entries take the lowest
        available leaf of their length, in entry order. Implemented as
        subtree splitting over 32-bit left-aligned codes."""
        self.decode_table: Dict[Tuple[int, int], int] = {}
        used = [e for e in range(self.entries) if self.lengths[e] > 0]
        if not used:
            self.min_len = 0
            return
        if len(used) == 1:
            # Single-entry codebook: one 1-bit codeword (value 0).
            self.decode_table[(1, 0)] = used[0]
            self.min_len = 1
            return
        available = [0] * 33
        first = True
        for e in used:
            l = int(self.lengths[e])
            if first:
                code32 = 0
                for y in range(1, l + 1):
                    available[y] = 1 << (32 - y)
                available_set = True  # noqa: F841
                self.decode_table[(l, 0)] = e
                first = False
                continue
            z = l
            while z > 0 and available[z] == 0:
                z -= 1
            if z == 0:
                raise ValueError("over-subscribed huffman tree")
            res = available[z]
            available[z] = 0
            self.decode_table[(l, res >> (32 - l))] = e
            for y in range(z + 1, l + 1):
                available[y] = res | (1 << (32 - y))
        self.min_len = min(int(self.lengths[e]) for e in used)

    def decode(self, br: BitReader) -> int:
        """Read one huffman codeword (MSB-first accumulation)."""
        code = 0
        length = 0
        table = self.decode_table
        for _ in range(32):
            code = (code << 1) | br.read(1)
            length += 1
            e = table.get((length, code))
            if e is not None:
                return e
        raise ValueError("invalid huffman code")

    def decode_vq(self, br: BitReader) -> np.ndarray:
        e = self.decode(br)
        return self.vq[e]


def _lookup1_values(entries: int, dimensions: int) -> int:
    """Greatest integer v with v**dimensions <= entries."""
    v = int(math.floor(entries ** (1.0 / dimensions)))
    while (v + 1) ** dimensions <= entries:
        v += 1
    while v ** dimensions > entries:
        v -= 1
    return v


# ----------------------------------------------------------------------
# Setup-header components
# ----------------------------------------------------------------------

@dataclass
class Floor1:
    partition_class_list: List[int] = field(default_factory=list)
    class_dimensions: List[int] = field(default_factory=list)
    class_subclasses: List[int] = field(default_factory=list)
    class_masterbooks: List[int] = field(default_factory=list)
    subclass_books: List[List[int]] = field(default_factory=list)
    multiplier: int = 1
    x_list: List[int] = field(default_factory=list)

    @classmethod
    def parse(cls, br: BitReader) -> "Floor1":
        f = cls()
        partitions = br.read(5)
        f.partition_class_list = [br.read(4) for _ in range(partitions)]
        max_class = max(f.partition_class_list, default=-1)
        for _ in range(max_class + 1):
            f.class_dimensions.append(br.read(3) + 1)
            sub = br.read(2)
            f.class_subclasses.append(sub)
            f.class_masterbooks.append(br.read(8) if sub else -1)
            f.subclass_books.append(
                [br.read(8) - 1 for _ in range(1 << sub)])
        f.multiplier = br.read(2) + 1
        rangebits = br.read(4)
        f.x_list = [0, 1 << rangebits]
        for cl in f.partition_class_list:
            for _ in range(f.class_dimensions[cl]):
                f.x_list.append(br.read(rangebits))
        if len(set(f.x_list)) != len(f.x_list):
            raise ValueError("non-unique floor1 X values")
        return f


@dataclass
class Residue:
    kind: int = 0
    begin: int = 0
    end: int = 0
    partition_size: int = 0
    classifications: int = 0
    classbook: int = 0
    cascade: List[int] = field(default_factory=list)
    books: List[List[int]] = field(default_factory=list)

    @classmethod
    def parse(cls, br: BitReader, kind: int) -> "Residue":
        r = cls(kind=kind)
        r.begin = br.read(24)
        r.end = br.read(24)
        r.partition_size = br.read(24) + 1
        r.classifications = br.read(6) + 1
        r.classbook = br.read(8)
        r.cascade = []
        for _ in range(r.classifications):
            high = 0
            low = br.read(3)
            if br.read(1):
                high = br.read(5)
            r.cascade.append((high << 3) | low)
        r.books = []
        for c in range(r.classifications):
            row = []
            for pas in range(8):
                row.append(br.read(8) if (r.cascade[c] >> pas) & 1
                           else -1)
            r.books.append(row)
        return r


@dataclass
class Mapping:
    submaps: int = 1
    coupling: List[Tuple[int, int]] = field(default_factory=list)
    mux: List[int] = field(default_factory=list)
    submap_floor: List[int] = field(default_factory=list)
    submap_residue: List[int] = field(default_factory=list)

    @classmethod
    def parse(cls, br: BitReader, channels: int) -> "Mapping":
        m = cls()
        m.submaps = br.read(4) + 1 if br.read(1) else 1
        if br.read(1):  # square polar coupling
            steps = br.read(8) + 1
            bits = ilog(channels - 1)
            for _ in range(steps):
                m.coupling.append((br.read(bits), br.read(bits)))
        if br.read(2) != 0:
            raise ValueError("reserved mapping bits set")
        if m.submaps > 1:
            m.mux = [br.read(4) for _ in range(channels)]
        else:
            m.mux = [0] * channels
        for _ in range(m.submaps):
            br.read(8)  # unused time config
            m.submap_floor.append(br.read(8))
            m.submap_residue.append(br.read(8))
        return m


@dataclass
class Mode:
    blockflag: int = 0
    mapping: int = 0


class VorbisSetup:
    def __init__(self, ident: bytes, setup: bytes):
        br = BitReader(ident)
        if br.read(8) != 1 or ident[1:7] != b"vorbis":
            raise ValueError("bad identification header")
        br.pos = 7 * 8
        if br.read(32) != 0:
            raise ValueError("unsupported vorbis version")
        self.channels = br.read(8)
        self.sample_rate = br.read(32)
        br.read(32)  # bitrate max
        br.read(32)  # nominal
        br.read(32)  # min
        self.blocksize0 = 1 << br.read(4)
        self.blocksize1 = 1 << br.read(4)
        if not br.read(1):
            raise ValueError("framing bit")

        br = BitReader(setup)
        if br.read(8) != 5 or setup[1:7] != b"vorbis":
            raise ValueError("bad setup header")
        br.pos = 7 * 8
        ncb = br.read(8) + 1
        self.codebooks = [Codebook(br) for _ in range(ncb)]

        # time domain transforms (placeholders)
        for _ in range(br.read(6) + 1):
            if br.read(16) != 0:
                raise ValueError("bad time transform")

        self.floors: List[Floor1] = []
        for _ in range(br.read(6) + 1):
            ftype = br.read(16)
            if ftype != 1:
                raise ValueError(f"floor type {ftype} not supported "
                                 "(floor0 is obsolete)")
            self.floors.append(Floor1.parse(br))

        self.residues: List[Residue] = []
        for _ in range(br.read(6) + 1):
            rtype = br.read(16)
            if rtype > 2:
                raise ValueError("bad residue type")
            self.residues.append(Residue.parse(br, rtype))

        self.mappings: List[Mapping] = []
        for _ in range(br.read(6) + 1):
            if br.read(16) != 0:
                raise ValueError("bad mapping type")
            self.mappings.append(Mapping.parse(br, self.channels))

        self.modes: List[Mode] = []
        for _ in range(br.read(6) + 1):
            blockflag = br.read(1)
            if br.read(16) != 0 or br.read(16) != 0:
                raise ValueError("bad mode transform")
            self.modes.append(Mode(blockflag, br.read(8)))
        if not br.read(1):
            raise ValueError("setup framing bit")


# ----------------------------------------------------------------------
# Floor1 synthesis (spec 7.2.3-7.2.4)
# ----------------------------------------------------------------------

_FLOOR1_RANGES = [256, 128, 86, 64]

# The spec's floor1_inverse_dB_table is geometric from 1.0649863e-7
# (index 0) to 1.0 (index 255).
_INV_DB = (1.0649863e-07 ** (1.0 - np.arange(256) / 255.0)).astype(
    np.float32)


def _low_neighbor(x_list, i):
    best, best_x = -1, -1
    for j in range(i):
        if x_list[j] < x_list[i] and x_list[j] > best_x:
            best, best_x = j, x_list[j]
    return best


def _high_neighbor(x_list, i):
    best, best_x = -1, 1 << 30
    for j in range(i):
        if x_list[j] > x_list[i] and x_list[j] < best_x:
            best, best_x = j, x_list[j]
    return best


def _render_point(x0, y0, x1, y1, X):
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    err = ady * (X - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0, y0, x1, y1, v, n):
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    base = int(dy / adx)  # truncate toward zero
    x = x0
    y = y0
    err = 0
    sy = base - 1 if dy < 0 else base + 1
    ady -= abs(base) * adx
    if x0 < n:
        v[x0] = _INV_DB[min(y0, 255)]
    for x in range(x0 + 1, min(x1, n)):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        v[x] = _INV_DB[min(y, 255)]


def decode_floor1(br: BitReader, f: Floor1, codebooks, n_half: int
                  ) -> Optional[np.ndarray]:
    """Returns the linear floor curve [n_half] or None (unused)."""
    if not br.read(1):
        return None
    frange = _FLOOR1_RANGES[f.multiplier - 1]
    bits = ilog(frange - 1)
    y = [br.read(bits), br.read(bits)]
    for cl in f.partition_class_list:
        cdim = f.class_dimensions[cl]
        cbits = f.class_subclasses[cl]
        csub = (1 << cbits) - 1
        cval = 0
        if cbits:
            cval = codebooks[f.class_masterbooks[cl]].decode(br)
        for _ in range(cdim):
            book = f.subclass_books[cl][cval & csub]
            cval >>= cbits
            y.append(codebooks[book].decode(br) if book >= 0 else 0)

    # Amplitude synthesis.
    x_list = f.x_list
    npts = len(x_list)
    final_y = [0] * npts
    step2 = [False] * npts
    step2[0] = step2[1] = True
    final_y[0] = y[0]
    final_y[1] = y[1]
    for i in range(2, npts):
        low = _low_neighbor(x_list, i)
        high = _high_neighbor(x_list, i)
        predicted = _render_point(x_list[low], final_y[low],
                                  x_list[high], final_y[high], x_list[i])
        val = y[i]
        highroom = frange - predicted
        lowroom = predicted
        room = 2 * min(highroom, lowroom)
        if val:
            step2[low] = True
            step2[high] = True
            step2[i] = True
            if val >= room:
                if highroom > lowroom:
                    final_y[i] = val - lowroom + predicted
                else:
                    final_y[i] = predicted - val + highroom - 1
            elif val & 1:
                final_y[i] = predicted - ((val + 1) >> 1)
            else:
                final_y[i] = predicted + (val >> 1)
        else:
            step2[i] = False
            final_y[i] = predicted
    final_y = [min(max(v, 0), frange - 1) for v in final_y]

    # Curve synthesis over step2 points sorted by x.
    pts = sorted((x_list[i], final_y[i]) for i in range(npts) if step2[i])
    v = np.zeros(n_half, np.float32)
    hx = 0
    hy = pts[0][1]
    lx, ly = pts[0]
    for hx, hy in pts[1:]:
        _render_line(lx, ly * f.multiplier, hx, hy * f.multiplier, v,
                     n_half)
        lx, ly = hx, hy
    if hx < n_half:
        v[hx:] = _INV_DB[min(hy * f.multiplier, 255)]
    return v


# ----------------------------------------------------------------------
# Residue decode (spec 8.6)
# ----------------------------------------------------------------------

def decode_residue(br: BitReader, r: Residue, codebooks,
                   do_not_decode: List[bool], n_half: int) -> np.ndarray:
    ch = len(do_not_decode)
    if r.kind == 2:
        vectors = np.zeros((1, n_half * ch), np.float32)
        dnd = [all(do_not_decode)]
        actual_size = n_half * ch
    else:
        vectors = np.zeros((ch, n_half), np.float32)
        dnd = do_not_decode
        actual_size = n_half

    begin = min(r.begin, actual_size)
    end = min(r.end, actual_size)
    n_to_read = end - begin
    if n_to_read <= 0:
        out = vectors
    else:
        classbook = codebooks[r.classbook]
        cpc = classbook.dimensions          # classwords per codeword
        psize = r.partition_size
        partitions_to_read = n_to_read // psize
        nch = vectors.shape[0]
        classifs = np.zeros((nch, partitions_to_read + cpc), np.int64)
        for pas in range(8):
            partition_count = 0
            while partition_count < partitions_to_read:
                if pas == 0:
                    for j in range(nch):
                        if dnd[j]:
                            continue
                        temp = classbook.decode(br)
                        for i in range(cpc - 1, -1, -1):
                            classifs[j, partition_count + i] = \
                                temp % r.classifications
                            temp //= r.classifications
                for _ in range(cpc):
                    if partition_count >= partitions_to_read:
                        break
                    for j in range(nch):
                        if dnd[j]:
                            continue
                        vq = int(classifs[j, partition_count])
                        book_idx = r.books[vq][pas]
                        if book_idx < 0:
                            continue
                        book = codebooks[book_idx]
                        offset = begin + partition_count * psize
                        dims = book.dimensions
                        vec = vectors[j]
                        if r.kind == 0:
                            step = psize // dims
                            for i in range(step):
                                e = book.decode_vq(br)
                                vec[offset + i:offset + i
                                    + step * dims:step] += e
                        else:  # kind 1 or 2 (contiguous)
                            i = 0
                            while i < psize:
                                e = book.decode_vq(br)
                                vec[offset + i:offset + i + dims] += e
                                i += dims
                    partition_count += 1

    if r.kind == 2:
        # de-interleave channels
        return vectors[0].reshape(n_half, ch).T.copy()
    return vectors


# ----------------------------------------------------------------------
# IMDCT + windows
# ----------------------------------------------------------------------

def _imdct_matrix(n: int) -> np.ndarray:
    """[n/2, n] matrix: y = X @ M (textbook IMDCT, Vorbis scaling)."""
    m = n // 2
    j = np.arange(n)[None, :]
    k = np.arange(m)[:, None]
    return np.cos(np.pi / m * (j + 0.5 + m / 2.0) * (k + 0.5) / 2.0 * 2.0
                  ).astype(np.float32)


def _vorbis_window(n: int) -> np.ndarray:
    j = np.arange(n)
    return np.sin(0.5 * np.pi
                  * np.sin(np.pi / n * (j + 0.5)) ** 2).astype(np.float32)


# ----------------------------------------------------------------------
# Top-level decoder
# ----------------------------------------------------------------------

class VorbisDecoder:
    def __init__(self, data: bytes):
        packets = ogg_packets(data)
        ident = next(packets)
        _comment = next(packets)
        setup = next(packets)
        self.setup = VorbisSetup(ident, setup)
        self._audio_packets = list(packets)
        self._last_granule = _last_granule_position(data)
        self._frames_cache: Optional[List[Tuple[int, int]]] = None

    def decode(self) -> Tuple[np.ndarray, int]:
        out = list(self.stream())
        if not out:
            return (np.zeros((self.setup.channels, 0), np.float32),
                    self.setup.sample_rate)
        return np.concatenate(out, axis=1), self.setup.sample_rate

    def stream(self, start_sample: int = 0,
               end_sample: Optional[int] = None):
        """Generator of [ch, n] float32 PCM blocks, one per decoded
        audio packet (overlap-add already applied), end-trimmed to the
        stream's last granule position (clamped per block, so a
        granulepos cutting into several lapped blocks truncates the
        same as a whole-file decode-then-slice).
        Peak memory is O(blocksize), not O(file) — long calls decode
        incrementally (the reference buffers ffmpeg's full output,
        audio_processor.py:76-86).

        ``start_sample``/``end_sample`` select a PCM range (seeking):
        frame positions are indexed with a light header-bit scan
        (mode/blockflag only, no floor/residue decode), then decoding
        starts at the one priming frame before the range — the
        libvorbisfile ov_pcm_seek regime. The concatenated output is
        bit-identical to the same slice of a full decode (tested)."""
        if end_sample is not None and end_sample <= start_sample:
            return
        first_pkt, base = 0, 0
        if start_sample > 0:
            frames = self._frame_index()
            if not frames:
                return
            import bisect

            positions = [c for _, c in frames]
            # Largest frame k with c_k <= start: decode from frame k
            # (primes the overlap-add); frame k+1 yields the segment
            # starting at c_k.
            k0 = max(0, bisect.bisect_right(positions, start_sample) - 1)
            first_pkt, base = frames[k0]
        for pos, seg in self._segments(first_pkt, base):
            if end_sample is not None and pos >= end_sample:
                return
            a = max(0, start_sample - pos)
            b = seg.shape[1] if end_sample is None else \
                min(seg.shape[1], end_sample - pos)
            if a < b:
                yield seg[:, a:b]

    def _frame_index(self) -> List[Tuple[int, int]]:
        """(packet_index, cumulative_pcm_position) for every audio
        frame, from header bits alone. Reads exactly the bits the
        decode loop reads before it can no longer drop the packet
        (packet type, mode, window flags), so the frame sequence —
        including corrupt/non-audio packets skipped by ``continue``
        and truncated packets salvaged by the end-of-packet rule —
        matches _segments packet for packet."""
        if getattr(self, "_frames_cache", None) is not None:
            return self._frames_cache
        s = self.setup
        mode_bits = ilog(len(s.modes) - 1)
        frames: List[Tuple[int, int]] = []
        prev_n = 0
        pos = 0
        for idx, pkt in enumerate(self._audio_packets):
            br = BitReader(pkt)
            try:
                if br.read(1) != 0:
                    continue
                mode_idx = br.read(mode_bits)
                if mode_idx >= len(s.modes):
                    continue
                mode = s.modes[mode_idx]
                n = s.blocksize1 if mode.blockflag else s.blocksize0
                if mode.blockflag:
                    br.read(1)
                    br.read(1)
            except EOFError:
                continue
            if frames:
                pos += prev_n // 4 + n // 4
            frames.append((idx, pos))
            prev_n = n
        self._frames_cache = frames
        return frames

    def _segments(self, first_pkt: int = 0, base_pos: int = 0):
        """Decode packets from ``first_pkt`` on, yielding
        (global_pcm_position, [ch, n] block) pairs. ``base_pos`` is
        the stream position of the first yielded segment (frame
        cumulative position of ``first_pkt``) so the last-granule end
        trim stays correct for mid-stream starts."""
        s = self.setup
        ch = s.channels
        imdct = {n: _imdct_matrix(n)
                 for n in {s.blocksize0, s.blocksize1}}
        windows = {}
        mode_bits = ilog(len(s.modes) - 1)
        prev_frame: Optional[np.ndarray] = None  # [ch, prev_n] windowed
        prev_n = 0
        produced = base_pos          # global position of next yield

        for pkt in self._audio_packets[first_pkt:]:
            br = BitReader(pkt)
            mapping = None
            n = 0
            floors = None
            residue_out = None
            try:
                if br.read(1) != 0:
                    continue  # not an audio packet
                mode_idx = br.read(mode_bits)
                if mode_idx >= len(s.modes):
                    continue  # corrupt packet
                mode = s.modes[mode_idx]
                n = s.blocksize1 if mode.blockflag else s.blocksize0
                prev_flag = next_flag = 1
                if mode.blockflag:
                    prev_flag = br.read(1)
                    next_flag = br.read(1)
                mapping = s.mappings[mode.mapping]
                n_half = n // 2

                floors = []
                no_residue = []
                for c in range(ch):
                    fl = s.floors[mapping.submap_floor[mapping.mux[c]]]
                    curve = decode_floor1(br, fl, s.codebooks, n_half)
                    floors.append(curve)
                    no_residue.append(curve is None)
                # Coupling: a coupled pair decodes if either side does.
                for mag, ang in mapping.coupling:
                    if not (no_residue[mag] and no_residue[ang]):
                        no_residue[mag] = no_residue[ang] = False

                residue_out = np.zeros((ch, n_half), np.float32)
                for sm in range(mapping.submaps):
                    chans = [c for c in range(ch) if mapping.mux[c] == sm]
                    dnd = [no_residue[c] for c in chans]
                    r = s.residues[mapping.submap_residue[sm]]
                    dec = decode_residue(br, r, s.codebooks, dnd, n_half)
                    for i, c in enumerate(chans):
                        residue_out[c] = dec[i]
            except EOFError:
                # spec: end-of-packet during audio decode is legal —
                # keep what was fully decoded for THIS packet only
                # (never reuse a previous packet's floors/residue).
                if mapping is None or n == 0:
                    continue
                n_half = n // 2
                if floors is None:
                    floors = []
                floors = floors + [None] * (ch - len(floors))
                if residue_out is None:
                    residue_out = np.zeros((ch, n_half), np.float32)

            # Inverse coupling (last step first).
            for mag, ang in reversed(mapping.coupling):
                M = residue_out[mag].copy()
                A = residue_out[ang].copy()
                pos = M > 0
                apos = A > 0
                newM = np.where(pos, np.where(apos, M, M + A),
                                np.where(apos, M, M - A))
                newA = np.where(pos, np.where(apos, M - A, M),
                                np.where(apos, M + A, M))
                residue_out[mag] = newM
                residue_out[ang] = newA

            # Floor x residue -> spectrum -> IMDCT.
            spectrum = np.zeros((ch, n_half), np.float32)
            for c in range(ch):
                if floors[c] is not None:
                    spectrum[c] = floors[c] * residue_out[c]
            frame = spectrum @ imdct[n]                       # [ch, n]

            wkey = (n, prev_flag, next_flag)
            if wkey not in windows:
                windows[wkey] = _make_window(n, s.blocksize0,
                                             bool(mode.blockflag),
                                             prev_flag, next_flag)
            frame = frame * windows[wkey]

            if prev_frame is not None:
                span = prev_n // 4 + n // 4
                seg = np.zeros((ch, span), np.float32)
                prev_part = prev_frame[:, prev_n // 2:
                                       prev_n // 2 + span]
                seg[:, :prev_part.shape[1]] += prev_part
                cur_part = frame[:, max(0, n // 2 - span):n // 2]
                seg[:, span - cur_part.shape[1]:] += cur_part
                # End trim: clamp EVERY block to the stream's last
                # granule position in global coordinates. A legal
                # (edited/truncated) stream's final-page granulepos
                # may cut into more than the final lapped block, so a
                # final-block-only trim would leave excess samples
                # (position accounting stays in untrimmed space).
                out = seg
                if self._last_granule is not None:
                    keep = max(0, min(span,
                                      self._last_granule - produced))
                    out = seg[:, :keep]
                if out.shape[1]:
                    yield produced, out
                produced += span
            prev_frame = frame
            prev_n = n


def _make_window(n: int, blocksize0: int, is_long: bool,
                 prev_flag: int, next_flag: int) -> np.ndarray:
    """Vorbis window with short slopes on transition sides."""
    w = np.zeros(n, np.float32)
    left_n = n if (not is_long or prev_flag) else blocksize0
    right_n = n if (not is_long or next_flag) else blocksize0
    left = _vorbis_window(left_n)[:left_n // 2]
    right = _vorbis_window(right_n)[right_n // 2:]
    ls = n // 4 - left_n // 4
    w[ls:ls + left_n // 2] = left
    w[ls + left_n // 2:n // 2] = 1.0
    rs = 3 * n // 4 - right_n // 4
    w[n // 2:rs] = 1.0
    w[rs:rs + right_n // 2] = right
    return w


def _last_granule_position(data: bytes) -> Optional[int]:
    idx = data.rfind(b"OggS")
    while idx >= 0:
        if idx + 27 <= len(data) and data[idx + 4] == 0:
            g = int.from_bytes(data[idx + 6:idx + 14], "little",
                               signed=True)
            if g >= 0:
                return g
        idx = data.rfind(b"OggS", 0, idx)
    return None


def _chain_segments(data: bytes) -> list:
    """One byte segment per Vorbis chain (RFC 3533 §3 concatenation);
    see io/ogg.py chain_segments for the boundary rule."""
    from audio_processor_tpu_torch.io.ogg import chain_segments
    return chain_segments(data, b"\x01vorbis")


def _conform_channels(pcm: np.ndarray, ch: int) -> np.ndarray:
    """Match a later chain's [C, N] block to the first chain's
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


def decode_vorbis(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Decode an Ogg/Vorbis file -> ([C, T] float32 in [-1, 1], rate).

    Chained streams decode end to end at the first chain's sample
    rate (a rate change mid-chain raises — the pipeline's resampler
    keys on one rate per file); later chains are channel-conformed
    to the first."""
    if isinstance(path_or_bytes, (str, Path)):
        data = Path(path_or_bytes).read_bytes()
    else:
        data = bytes(path_or_bytes)
    segs = _chain_segments(data)
    out, rate = VorbisDecoder(segs[0]).decode()
    if len(segs) == 1:
        return out, rate
    parts = [out]
    for seg in segs[1:]:
        nxt, r2 = VorbisDecoder(seg).decode()
        if r2 != rate:
            raise ValueError(
                f"chained Vorbis sample-rate change {rate} -> {r2} "
                f"not supported")
        parts.append(_conform_channels(nxt, out.shape[0]))
    return np.ascontiguousarray(np.concatenate(parts, axis=1)), rate


def decode_vorbis_stream(path_or_bytes, start_sample: int = 0,
                         end_sample: Optional[int] = None):
    """Streaming decode: (sample_rate, iterator of [C, n] float32
    blocks). Concatenating the blocks equals decode_vorbis exactly
    (tested); peak memory is per-block. ``start_sample``/
    ``end_sample`` seek to a PCM range (see VorbisDecoder.stream)."""
    if isinstance(path_or_bytes, (str, Path)):
        data = Path(path_or_bytes).read_bytes()
    else:
        data = bytes(path_or_bytes)
    segs = _chain_segments(data)
    if len(segs) == 1:
        dec = VorbisDecoder(data)
        return dec.setup.sample_rate, dec.stream(start_sample,
                                                 end_sample)
    first = VorbisDecoder(segs[0])
    rate, ch = first.setup.sample_rate, first.setup.channels
    if start_sample == 0 and end_sample is None:
        def gen():
            for i, seg in enumerate(segs):
                dec = first if i == 0 else VorbisDecoder(seg)
                if dec.setup.sample_rate != rate:
                    raise ValueError(
                        "chained Vorbis sample-rate change "
                        f"{rate} -> {dec.setup.sample_rate} "
                        "not supported")
                for block in dec.stream(0, None):
                    yield _conform_channels(block, ch)
        return rate, gen()
    # Seek into a chained file: granule indexing is per chain, so
    # fall back to a full decode + slice in one block (correct,
    # linear cost; chained seeks are an exotic case).
    full, _ = decode_vorbis(data)
    stop = full.shape[1] if end_sample is None \
        else min(full.shape[1], end_sample)
    lo = min(max(0, start_sample), stop)

    def one():
        if stop > lo:
            yield np.ascontiguousarray(full[:, lo:stop])
    return rate, one()


def decode_vorbis_range(path_or_bytes, start_sample: int,
                        num_samples: Optional[int] = None
                        ) -> Tuple[np.ndarray, int]:
    """Seek + decode one PCM range -> ([C, n] float32, rate).

    Bit-identical to ``decode_vorbis(...)[0][:, start:start+num]`` but
    decodes only the frames overlapping the range plus one priming
    frame (header-bit frame index; the libvorbisfile ov_pcm_seek
    regime — the reference's ffmpeg path has no seek at all,
    services/audio_processor.py:76-86)."""
    if isinstance(path_or_bytes, (str, Path)):
        data = Path(path_or_bytes).read_bytes()
    else:
        data = bytes(path_or_bytes)
    end = None if num_samples is None else start_sample + num_samples
    rate, blocks = decode_vorbis_stream(data, start_sample, end)
    out = list(blocks)
    if not out:
        ch = VorbisDecoder(_chain_segments(data)[0]).setup.channels
        return np.zeros((ch, 0), np.float32), rate
    return np.concatenate(out, axis=1), rate
