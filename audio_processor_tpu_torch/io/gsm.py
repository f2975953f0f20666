"""GSM 06.10 full-rate decode (WAV tag 0x0031, "MS GSM" / WAV49).

The classic telephony archive codec: 160-sample 8 kHz frames in 260
bits. WAV files (tag 0x0031) use Microsoft's WAV49 framing — 65-byte
blocks holding TWO frames as one 520-bit little-endian bit stream
(libgsm's encoder emits 32 then 33 bytes per pair; its decoder
consumes 33 then 32 — the middle byte carries the chained nibble).

Fast path: the system ``libgsm`` via ctypes (no subprocess). Fallback:
a first-party ETSI 06.10 decoder below — RPE inverse-APCM, long-term
synthesis, LAR interpolation + reflection-coefficient lattice,
de-emphasis — in the spec's exact saturating 16-bit arithmetic,
bit-exact vs libgsm (test_gsm). The reference pipeline reaches this
format through torchaudio's sox/soundfile backends
(audio_processor.py:76-86 routes all decode through torchaudio).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

FRAME_SAMPLES = 160
BLOCK_SAMPLES = 320          # WAV49: two frames per 65-byte block
BLOCK_BYTES = 65

# --- ETSI 06.10 tables (spec constants; shared by every implementation)
_MIC = (-32, -32, -16, -16, -8, -8, -4, -4)
_B = (0, 0, 2048, -2560, 94, -1792, -341, -1144)
_INVA = (13107, 13107, 13107, 13107, 19223, 17476, 31454, 29708)
_QLB = (3277, 11469, 21299, 32767)
_FAC = (18431, 20479, 22527, 24575, 26623, 28671, 30719, 32767)
_LAR_BITS = (6, 6, 5, 5, 4, 4, 3, 3)

_MAX, _MIN = 32767, -32768


def _sat(x: int) -> int:
    return _MAX if x > _MAX else _MIN if x < _MIN else x


def _mult_r(a: int, b: int) -> int:
    if a == _MIN and b == _MIN:
        return _MAX
    return _sat((a * b + 16384) >> 15)


class _BitReaderLSB:
    """LSB-first field extraction over a byte stream (WAV49 packing)."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0
        self._buf = 0
        self._n = 0

    def take(self, bits: int) -> int:
        while self._n < bits:
            self._buf |= self._data[self._pos] << self._n
            self._pos += 1
            self._n += 8
        v = self._buf & ((1 << bits) - 1)
        self._buf >>= bits
        self._n -= bits
        return v


class _BitReaderMSB:
    """MSB-first field extraction (standard 33-byte framing)."""

    def __init__(self, data: bytes):
        self._data = data
        self._bit = 0

    def take(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            byte = self._data[self._bit >> 3]
            v = (v << 1) | ((byte >> (7 - (self._bit & 7))) & 1)
            self._bit += 1
        return v


def _read_frame_params(take):
    lar = [take(b) for b in _LAR_BITS]
    subs = []
    for _ in range(4):
        nc = take(7)
        bc = take(2)
        mc = take(2)
        xmaxc = take(6)
        xmc = [take(3) for _ in range(13)]
        subs.append((nc, bc, mc, xmaxc, xmc))
    return lar, subs


class GsmDecoder:
    """First-party stateful GSM 06.10 decoder (one logical stream)."""

    def __init__(self):
        self._drp = np.zeros(160, np.int64)     # LTP history [-120..39]
        self._nrp = 40
        self._v = [0] * 9                       # lattice state
        self._msr = 0
        self._larpp_prev = [0] * 8

    # -- per-frame stages ------------------------------------------------
    def _rpe_decode(self, nc, bc, mc, xmaxc, xmc):
        # xmaxc -> exponent / mantissa (ETSI 5.2.15 inverse)
        exp = 0
        if xmaxc > 15:
            exp = (xmaxc >> 3) - 1
        mant = xmaxc - (exp << 3)
        if mant == 0:
            exp, mant = -4, 7
        else:
            while mant <= 7:
                mant = (mant << 1) | 1
                exp -= 1
            mant -= 8
        # inverse APCM over the 13 residual samples (vectorized)
        temp1 = _FAC[mant]
        temp2 = 6 - exp                          # in [0, 10]
        temp3 = (1 << (temp2 - 1)) if temp2 >= 1 else 0
        x = (np.asarray(xmc, np.int64) << 1) - 7
        x <<= 12
        x = (x * temp1 + 16384) >> 15            # |x| small: no sat
        x = np.clip(x + temp3, _MIN, _MAX)
        xmp = x >> temp2
        # RPE grid positioning
        ep = np.zeros(40, np.int64)
        ep[mc:mc + 39:3] = xmp
        return ep

    def _ltp(self, nc, bc, erp):
        nr = nc if 40 <= nc <= 120 else self._nrp
        self._nrp = nr
        brp = _QLB[bc]
        # retire the previous subframe's samples into history FIRST so
        # drp[k - Nr] sees them at -40..-1 (libgsm shifts at subframe
        # end; shifting at the next subframe's start is equivalent)
        self._drp[:120] = self._drp[40:]
        hist = self._drp[120 - nr:160 - nr]      # drp[k - Nr], k=0..39
        drpp = (brp * hist + 16384) >> 15        # brp>0, hist int16
        new = np.clip(erp + drpp, _MIN, _MAX)
        self._drp[120:] = new
        return new

    def _lar_to_rp(self, larp: int) -> int:
        temp = _sat(-larp) if larp < 0 else larp  # GSM_ABS
        if temp < 11059:
            temp <<= 1
        elif temp < 20070:
            temp = _sat(temp + 11059)
        else:
            temp = _sat((temp >> 2) + 26112)
        return _sat(0 - temp) if larp < 0 else temp

    def _short_term(self, larc, wt):
        # LARc -> LARpp (ETSI 5.2.8 decode)
        larpp = []
        for i in range(8):
            t1 = _sat(_sat(larc[i] + _MIC[i]) << 10)
            t1 = _sat(t1 - _sat(_B[i] << 1))
            t1 = _mult_r(_INVA[i], t1)
            larpp.append(_sat(t1 + t1))
        prev = self._larpp_prev
        zones = ((0, 13, lambda o, n: _sat(_sat((o >> 2) + (n >> 2))
                                           + (o >> 1))),
                 (13, 27, lambda o, n: _sat((o >> 1) + (n >> 1))),
                 (27, 40, lambda o, n: _sat(_sat((o >> 2) + (n >> 2))
                                            + (n >> 1))),
                 (40, 160, lambda o, n: n))
        out = np.empty(160, np.int64)
        v = self._v
        for lo, hi, mix in zones:
            rrp = [self._lar_to_rp(mix(prev[i], larpp[i]))
                   for i in range(8)]
            for k in range(lo, hi):
                sri = int(wt[k])
                for i in range(7, -1, -1):
                    t1 = rrp[i]
                    t2 = _mult_r(t1, v[i])
                    sri = _sat(sri - t2)
                    t1 = _mult_r(t1, sri)
                    v[i + 1] = _sat(v[i] + t1)
                v[0] = sri
                out[k] = sri
        self._larpp_prev = larpp
        return out

    def _postprocess(self, sr):
        out = np.empty(160, np.int64)
        msr = self._msr
        for k in range(160):
            msr = _sat(int(sr[k]) + _mult_r(msr, 28180))
            # truncate the 3 LSBs in 16-bit two's complement (the
            # Python & would strip the sign)
            out[k] = ((_sat(msr + msr) & 0xFFF8) ^ 0x8000) - 0x8000
        self._msr = msr
        return out

    # -- public ----------------------------------------------------------
    def decode_frame_params(self, lar, subs) -> np.ndarray:
        wt = np.empty(160, np.int64)
        for j, (nc, bc, mc, xmaxc, xmc) in enumerate(subs):
            erp = self._rpe_decode(nc, bc, mc, xmaxc, xmc)
            wt[j * 40:(j + 1) * 40] = self._ltp(nc, bc, erp)
        sr = self._short_term(lar, wt)
        out = self._postprocess(sr)
        return out.astype(np.int16)

    def decode_wav49_block(self, block: bytes) -> np.ndarray:
        """One 65-byte WAV49 block -> 320 int16 samples (a trailing
        33-byte half block yields 160)."""
        rd = _BitReaderLSB(block)
        frames = [self.decode_frame_params(*_read_frame_params(rd.take))]
        if len(block) >= BLOCK_BYTES:
            frames.append(
                self.decode_frame_params(*_read_frame_params(rd.take)))
        return np.concatenate(frames)

    def decode_standard_frame(self, frame: bytes) -> np.ndarray:
        """One 33-byte magic-0xD frame -> 160 int16 samples."""
        if (frame[0] >> 4) != 0xD:
            raise ValueError("bad GSM frame magic")
        rd = _BitReaderMSB(frame)
        rd.take(4)
        return self.decode_frame_params(*_read_frame_params(rd.take))


# --- libgsm ctypes fast path ---------------------------------------------

_GSM_OPT_WAV49 = 4
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _libgsm() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        for name in ("libgsm.so.1", "libgsm.so", "gsm"):
            try:
                lib = ctypes.CDLL(name)
                lib.gsm_create.restype = ctypes.c_void_p
                _lib = lib
                break
            except OSError:
                continue
    return _lib


def libgsm_available() -> bool:
    return _libgsm() is not None


def _decode_wav49_libgsm(raw: bytes, num_frames: int) -> np.ndarray:
    lib = _libgsm()
    g = lib.gsm_create()
    try:
        lib.gsm_option(ctypes.c_void_p(g), _GSM_OPT_WAV49,
                       ctypes.byref(ctypes.c_int(1)))
        out = np.zeros(((len(raw) // BLOCK_BYTES + 1) * BLOCK_SAMPLES,),
                       "<i2")
        pos = n = 0
        buf = ctypes.create_string_buffer(raw, len(raw))
        while pos + 33 <= len(raw) and n + FRAME_SAMPLES <= len(out):
            # WAV49 decode consumes 33 bytes then 32 per block pair
            for step in (33, 32):
                if pos + step > len(raw):
                    break
                sub = (ctypes.c_char * step).from_buffer(buf, pos)
                dst = out[n:n + FRAME_SAMPLES]
                if lib.gsm_decode(
                        ctypes.c_void_p(g), sub,
                        dst.ctypes.data_as(ctypes.c_void_p)) != 0:
                    raise ValueError("libgsm: corrupt GSM frame")
                pos += step
                n += FRAME_SAMPLES
        return out[:min(n, num_frames)]
    finally:
        lib.gsm_destroy(ctypes.c_void_p(g))


def decode_wav49(raw: bytes, num_frames: int) -> np.ndarray:
    """WAV49 payload bytes -> [num_frames] int16 (mono by spec).

    Prefers libgsm; falls back to the first-party decoder. Both paths
    are bit-exact against each other (test_gsm differential fuzz).
    """
    if _libgsm() is not None:
        return _decode_wav49_libgsm(raw, num_frames)
    dec = GsmDecoder()
    chunks = []
    pos, n = 0, 0
    while pos + 33 <= len(raw) and n < num_frames:
        block = raw[pos:pos + BLOCK_BYTES]
        samples = dec.decode_wav49_block(block)
        chunks.append(samples)
        pos += BLOCK_BYTES
        n += len(samples)
    if not chunks:
        return np.zeros(0, np.int16)
    return np.concatenate(chunks)[:num_frames]
