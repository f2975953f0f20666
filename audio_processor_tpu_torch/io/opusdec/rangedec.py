"""RFC 6716 §4.1 range decoder (the entropy coder shared by SILK and
CELT), including the reverse-direction raw-bits reader.

Semantics follow the spec's normative decoder exactly (32-bit value /
range state, byte-wise renormalization, raw bits consumed from the
packet tail); validated end-to-end by decoding libopus-encoded
streams bit-exactly (tests/test_opusdec.py).
"""

from __future__ import annotations

SYM_BITS = 8
CODE_BITS = 32
SYM_MAX = (1 << SYM_BITS) - 1
CODE_TOP = 1 << (CODE_BITS - 1)
CODE_BOT = CODE_TOP >> SYM_BITS
CODE_EXTRA = (CODE_BITS - 2) % SYM_BITS + 1  # 7
WINDOW_SIZE = 32
UINT_BITS = 8
BITRES = 3

_M32 = 0xFFFFFFFF


def ilog(x: int) -> int:
    """Position of the highest set bit + 1 (EC_ILOG); ilog(0) == 0."""
    return x.bit_length()


class RangeDecoder:
    __slots__ = ("buf", "storage", "offs", "end_offs", "end_window",
                 "nend_bits", "nbits_total", "val", "rng", "rem",
                 "error", "_ext")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.storage = len(buf)
        self.offs = 0
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = CODE_BITS + 1 \
            - ((CODE_BITS - CODE_EXTRA) // SYM_BITS) * SYM_BITS
        self.error = 0
        self.rng = 1 << CODE_EXTRA
        self.rem = self._read_byte()
        self.val = self.rng - 1 - (self.rem >> (SYM_BITS - CODE_EXTRA))
        self._normalize()

    # -- byte sources ---------------------------------------------------
    def _read_byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _read_byte_from_end(self) -> int:
        if self.end_offs < self.storage:
            self.end_offs += 1
            return self.buf[self.storage - self.end_offs]
        return 0

    # -- core -----------------------------------------------------------
    def _normalize(self) -> None:
        while self.rng <= CODE_BOT:
            self.nbits_total += SYM_BITS
            self.rng = (self.rng << SYM_BITS) & _M32
            sym = self.rem
            self.rem = self._read_byte()
            sym = ((sym << SYM_BITS | self.rem)
                   >> (SYM_BITS - CODE_EXTRA))
            self.val = (((self.val << SYM_BITS) + (SYM_MAX & ~sym))
                        & (CODE_TOP - 1))

    def decode(self, ft: int) -> int:
        """ec_decode: cumulative frequency of the next symbol."""
        self._ext = self.rng // ft
        s = self.val // self._ext
        return ft - min(s + 1, ft)

    def decode_bin(self, bits: int) -> int:
        self._ext = self.rng >> bits
        s = self.val // self._ext
        return (1 << bits) - min(s + 1, 1 << bits)

    def update(self, fl: int, fh: int, ft: int) -> None:
        s = self._ext * (ft - fh)
        self.val -= s
        self.rng = self._ext * (fh - fl) if fl > 0 else self.rng - s
        self._normalize()

    def dec_bit_logp(self, logp: int) -> int:
        r = self.rng
        d = self.val
        s = r >> logp
        ret = d < s  # val counts from the range top -> small val = "1"
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return int(ret)

    def dec_icdf(self, icdf, ftb: int) -> int:
        """Decode one symbol from an inverse-CDF table (uint8)."""
        s = self.rng
        d = self.val
        r = s >> ftb
        ret = -1
        while True:
            ret += 1
            t = s
            s = r * int(icdf[ret])
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        self._normalize()
        return ret

    def dec_uint(self, ft: int) -> int:
        assert ft > 1
        ft -= 1
        ftb = ilog(ft)
        if ftb > UINT_BITS:
            ftb -= UINT_BITS
            ft1 = (ft >> ftb) + 1
            s = self.decode(ft1)
            self.update(s, s + 1, ft1)
            t = (s << ftb) | self.dec_bits(ftb)
            if t <= ft:
                return t
            self.error = 1
            return ft
        s = self.decode(ft + 1)
        self.update(s, s + 1, ft + 1)
        return s

    def dec_bits(self, bits: int) -> int:
        window = self.end_window
        available = self.nend_bits
        if available < bits:
            while available <= WINDOW_SIZE - SYM_BITS:
                window |= self._read_byte_from_end() << available
                available += SYM_BITS
        ret = window & ((1 << bits) - 1)
        window >>= bits
        available -= bits
        self.end_window = window
        self.nend_bits = available
        self.nbits_total += bits
        return ret

    # -- bit accounting -------------------------------------------------
    def tell(self) -> int:
        return self.nbits_total - ilog(self.rng)

    def tell_frac(self) -> int:
        """Bits used so far in 1/8 bit units (ec_tell_frac)."""
        correction = (35733, 38967, 42495, 46340,
                      50535, 55109, 60097, 65535)
        nbits = self.nbits_total << BITRES
        lg = ilog(self.rng)
        rng_q15 = self.rng >> (lg - 16)
        b = (rng_q15 >> 12) - 8
        b += int(rng_q15 > correction[b])
        lg = (lg << 3) + b
        return nbits - lg
