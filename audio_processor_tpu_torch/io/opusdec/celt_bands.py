"""CELT band shape decoding (RFC 6716 §4.3.4, reference bands.c +
vq.c): the recursive band-split machinery (theta angles, time-freq
resolution changes, Hadamard reordering, folding, noise fill), PVQ
dequantization with spreading rotations, stereo merge, and
anti-collapse.

The entropy layer (theta coding, qn computation, PVQ sizes, bit
rebalancing) is integer-exact with the reference; the signal math is
float (the reference's float build) and is held to tolerance by the
end-to-end tests.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from audio_processor_tpu_torch.io.opusdec import _tables as T
from audio_processor_tpu_torch.io.opusdec.celt_cwrs import cwrsi, pvq_v
from audio_processor_tpu_torch.io.opusdec.celt_rate import (BITRES, EBANDS,
                                                      bits2pulses,
                                                      get_pulses,
                                                      pulses2bits)
from audio_processor_tpu_torch.io.opusdec.rangedec import RangeDecoder

NB_BANDS = 21
SPREAD_NONE = 0
SPREAD_AGGRESSIVE = 3
QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16
_LOGN = [int(v) for v in T.CELT_LOGN]
_ORDERY = [int(v) for v in T.CELT_ORDERY]
_BIT_INTERLEAVE = [int(v) for v in T.CELT_BIT_INTERLEAVE]
_BIT_DEINTERLEAVE = [int(v) for v in T.CELT_BIT_DEINTERLEAVE]
_CACHE_INDEX = T.CELT_CACHE_INDEX.reshape(-1)
_CACHE_BITS = T.CELT_CACHE_BITS
_EXP2_TABLE8 = [16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048]


def _cdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def lcg_rand(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def frac_mul16(a: int, b: int) -> int:
    def i16(x):
        x &= 0xFFFF
        return x - 0x10000 if x >= 0x8000 else x
    return (16384 + i16(a) * i16(b)) >> 15


def bitexact_cos(x: int) -> int:
    tmp = (4096 + x * x) >> 13
    x2 = tmp
    x2 = (32767 - x2) + frac_mul16(
        x2, -7651 + frac_mul16(x2, 8277 + frac_mul16(-626, x2)))
    return 1 + x2


def bitexact_log2tan(isin: int, icos: int) -> int:
    lc = icos.bit_length()
    ls = isin.bit_length()
    icos <<= 15 - lc
    isin <<= 15 - ls
    return ((ls - lc) * (1 << 11)
            + frac_mul16(isin, frac_mul16(isin, -2597) + 7932)
            - frac_mul16(icos, frac_mul16(icos, -2597) + 7932))


def celt_exp2(x: float) -> float:
    return math.exp(0.6931471805599453 * x)


# --------------------------------------------------------------------
# vq.c
# --------------------------------------------------------------------

_SPREAD_FACTOR = [15, 10, 5]


def _exp_rotation1(x: np.ndarray, length: int, stride: int,
                   c: float, s: float) -> None:
    ms = -s
    for i in range(length - stride):
        x1 = x[i]
        x2 = x[i + stride]
        x[i + stride] = c * x2 + s * x1
        x[i] = c * x1 + ms * x2
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = x[i]
        x2 = x[i + stride]
        x[i + stride] = c * x2 + s * x1
        x[i] = c * x1 + ms * x2


def exp_rotation(x: np.ndarray, length: int, direction: int,
                 stride: int, k: int, spread: int) -> None:
    if 2 * k >= length or spread == SPREAD_NONE:
        return
    factor = _SPREAD_FACTOR[spread - 1]
    gain = float(length) / (length + factor * k)
    theta = 0.5 * gain * gain
    c = math.cos(0.5 * math.pi * theta)
    s = math.cos(0.5 * math.pi * (1.0 - theta))
    stride2 = 0
    if length >= 8 * stride:
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride \
                + (stride >> 2) < length:
            stride2 += 1
    length //= stride
    for i in range(stride):
        seg = x[i * length:(i + 1) * length]
        if direction < 0:
            if stride2:
                _exp_rotation1(seg, length, stride2, s, c)
            _exp_rotation1(seg, length, 1, c, s)
        else:
            _exp_rotation1(seg, length, 1, c, -s)
            if stride2:
                _exp_rotation1(seg, length, stride2, s, -c)


def renormalise_vector(x: np.ndarray, n: int, gain: float) -> None:
    e = 1e-15 + float(np.sum(x[:n] * x[:n]))
    g = gain / math.sqrt(e)
    x[:n] *= g


def _extract_collapse_mask(iy: List[int], n: int, b: int) -> int:
    if b <= 1:
        return 1
    n0 = n // b
    mask = 0
    for i in range(b):
        tmp = 0
        for j in range(n0):
            tmp |= iy[i * n0 + j]
        mask |= int(tmp != 0) << i
    return mask


def alg_unquant(x: np.ndarray, n: int, k: int, spread: int, b: int,
                rd: RangeDecoder, gain: float) -> int:
    iy = cwrsi(n, k, rd.dec_uint(pvq_v(n, k)))
    iyv = np.array(iy, np.int64)
    ryy = float(iyv @ iyv)
    g = gain / math.sqrt(ryy)
    x[:n] = g * iyv
    exp_rotation(x, n, -1, b, k, spread)
    return _extract_collapse_mask(iy, n, b)


# --------------------------------------------------------------------
# bands.c helpers
# --------------------------------------------------------------------

def haar1(x: np.ndarray, n0: int, stride: int) -> None:
    n0 >>= 1
    rt = 0.70710678
    n = n0 * 2 * stride
    v = x[:n]
    # numpy's fixed per-op overhead loses to the scalar butterflies
    # below ~8 pairs (profiled); most calls are tiny.
    if n > 32 and (v.base is None or v.flags.c_contiguous):
        m = v.reshape(n0, 2, stride)  # [j, even/odd, i] view
        a = rt * m[:, 0]
        b = rt * m[:, 1]
        m[:, 0] = a + b
        m[:, 1] = a - b
        return
    for i in range(stride):
        for j in range(n0):
            a = rt * x[stride * 2 * j + i]
            b = rt * x[stride * (2 * j + 1) + i]
            x[stride * 2 * j + i] = a + b
            x[stride * (2 * j + 1) + i] = a - b


def deinterleave_hadamard(x: np.ndarray, n0: int, stride: int,
                          hadamard: bool) -> None:
    n = n0 * stride
    # tmp[row(i), j] = x[j*stride + i]: a [n0, stride] -> transpose
    # gather with an optional Hadamard row order.
    cols = np.asarray(x[:n]).reshape(n0, stride).T   # [stride, n0] copy
    tmp = np.empty((stride, n0), x.dtype)
    if hadamard:
        tmp[_ORDERY[stride - 2:2 * stride - 2]] = cols
    else:
        tmp = cols
    x[:n] = tmp.reshape(n)


def interleave_hadamard(x: np.ndarray, n0: int, stride: int,
                        hadamard: bool) -> None:
    n = n0 * stride
    rows = np.asarray(x[:n]).reshape(stride, n0)
    if hadamard:
        rows = rows[_ORDERY[stride - 2:2 * stride - 2]]
    x[:n] = rows.T.reshape(n)


def special_hybrid_folding(norm: np.ndarray, norm2: Optional[np.ndarray],
                           start: int, m: int, dual_stereo: bool) -> None:
    n1 = m * (EBANDS[start + 1] - EBANDS[start])
    n2 = m * (EBANDS[start + 2] - EBANDS[start + 1])
    norm[n1:n2] = norm[2 * n1 - n2:n1]
    if dual_stereo and norm2 is not None:
        norm2[n1:n2] = norm2[2 * n1 - n2:n1]


def stereo_merge(x: np.ndarray, y: np.ndarray, mid: float,
                 n: int) -> None:
    xp = float(np.dot(x[:n], y[:n]))
    side = float(np.dot(y[:n], y[:n]))
    xp *= mid
    el = mid * mid + side - 2 * xp
    er = mid * mid + side + 2 * xp
    if er < 6e-4 or el < 6e-4:
        y[:n] = x[:n]
        return
    lgain = 1.0 / math.sqrt(el)
    rgain = 1.0 / math.sqrt(er)
    l = mid * x[:n]
    r = y[:n].copy()
    x[:n] = lgain * (l - r)
    y[:n] = rgain * (l + r)


def _compute_qn(n: int, b: int, offset: int, pulse_cap: int,
                stereo: bool) -> int:
    n2 = 2 * n - 1
    if stereo and n == 2:
        n2 -= 1
    qb = _cdiv(b + n2 * offset, n2)
    qb = min(b - pulse_cap - (4 << BITRES), qb)
    qb = min(8 << BITRES, qb)
    if qb < (1 << BITRES >> 1):
        return 1
    qn = _EXP2_TABLE8[qb & 0x7] >> (14 - (qb >> BITRES))
    return ((qn + 1) >> 1) << 1


# --------------------------------------------------------------------
# band context + theta
# --------------------------------------------------------------------

class BandCtx:
    __slots__ = ("rd", "i", "intensity", "spread", "tf_change",
                 "remaining_bits", "seed", "disable_inv")

    def __init__(self, rd: RangeDecoder, intensity: int, spread: int,
                 seed: int, disable_inv: bool):
        self.rd = rd
        self.i = 0
        self.intensity = intensity
        self.spread = spread
        self.tf_change = 0
        self.remaining_bits = 0
        self.seed = seed
        self.disable_inv = disable_inv


class SplitCtx:
    __slots__ = ("inv", "imid", "iside", "delta", "itheta", "qalloc")


def compute_theta(ctx: BandCtx, sctx: SplitCtx, n: int, b: int,
                  b_blocks: int, b0: int, lm: int, stereo: bool,
                  fill: int):
    """bands.c compute_theta (decode side) -> (b, fill)."""
    rd = ctx.rd
    i = ctx.i
    itheta = 0
    inv = 0
    pulse_cap = _LOGN[i] + lm * (1 << BITRES)
    offset = (pulse_cap >> 1) - (QTHETA_OFFSET_TWOPHASE
                                 if stereo and n == 2 else QTHETA_OFFSET)
    qn = _compute_qn(n, b, offset, pulse_cap, stereo)
    if stereo and i >= ctx.intensity:
        qn = 1
    tell = rd.tell_frac()
    if qn != 1:
        if stereo and n > 2:
            p0 = 3
            x0 = qn // 2
            ft = p0 * (x0 + 1) + x0
            fs = rd.decode(ft)
            if fs < (x0 + 1) * p0:
                x = fs // p0
            else:
                x = x0 + 1 + (fs - (x0 + 1) * p0)
            rd.update(p0 * x if x <= x0 else (x - 1 - x0) + (x0 + 1) * p0,
                      p0 * (x + 1) if x + 1 <= x0
                      else (x - x0) + (x0 + 1) * p0,
                      ft)
            itheta = x
        elif b0 > 1 or stereo:
            itheta = rd.dec_uint(qn + 1)
        else:
            ft = ((qn >> 1) + 1) * ((qn >> 1) + 1)
            fm = rd.decode(ft)
            if fm < ((qn >> 1) * ((qn >> 1) + 1) >> 1):
                itheta = (math.isqrt(8 * fm + 1) - 1) >> 1
                fs = itheta + 1
                fl = itheta * (itheta + 1) >> 1
            else:
                itheta = (2 * (qn + 1)
                          - math.isqrt(8 * (ft - fm - 1) + 1)) >> 1
                fs = qn + 1 - itheta
                fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1)
            rd.update(fl, fl + fs, ft)
        itheta = itheta * 16384 // qn
    elif stereo:
        if b > 2 << BITRES and ctx.remaining_bits > 2 << BITRES:
            inv = rd.dec_bit_logp(2)
        if inv and ctx.disable_inv:
            inv = 0
        itheta = 0
    qalloc = rd.tell_frac() - tell
    b -= qalloc

    if itheta == 0:
        imid = 32767
        iside = 0
        fill &= (1 << b_blocks) - 1
        delta = -16384
    elif itheta == 16384:
        imid = 0
        iside = 32767
        fill &= ((1 << b_blocks) - 1) << b_blocks
        delta = 16384
    else:
        imid = bitexact_cos(itheta)
        iside = bitexact_cos(16384 - itheta)
        delta = frac_mul16((n - 1) << 7,
                           bitexact_log2tan(iside, imid))

    sctx.inv = inv
    sctx.imid = imid
    sctx.iside = iside
    sctx.delta = delta
    sctx.itheta = itheta
    sctx.qalloc = qalloc
    return b, fill


def _quant_band_n1(ctx: BandCtx, x: np.ndarray,
                   y: Optional[np.ndarray],
                   lowband_out: Optional[np.ndarray]) -> int:
    vecs = [x] if y is None else [x, y]
    for v in vecs:
        sign = 0
        if ctx.remaining_bits >= 1 << BITRES:
            sign = ctx.rd.dec_bits(1)
            ctx.remaining_bits -= 1 << BITRES
        v[0] = -1.0 if sign else 1.0
    if lowband_out is not None:
        lowband_out[0] = x[0]
    return 1


# --------------------------------------------------------------------
# the recursion
# --------------------------------------------------------------------

def quant_partition(ctx: BandCtx, x: np.ndarray, n: int, b: int,
                    b_blocks: int, lowband: Optional[np.ndarray],
                    lm: int, gain: float, fill: int) -> int:
    rd = ctx.rd
    i = ctx.i
    b0 = b_blocks
    cache_base = int(_CACHE_INDEX[(lm + 1) * NB_BANDS + i])
    cache0 = int(_CACHE_BITS[cache_base])
    if lm != -1 and b > int(_CACHE_BITS[cache_base + cache0]) + 12 \
            and n > 2:
        n >>= 1
        y = x[n:]
        lm -= 1
        if b_blocks == 1:
            fill = (fill & 1) | (fill << 1)
        b_blocks = (b_blocks + 1) >> 1

        sctx = SplitCtx()
        b, fill = compute_theta(ctx, sctx, n, b, b_blocks, b0, lm,
                                False, fill)
        imid = sctx.imid
        iside = sctx.iside
        delta = sctx.delta
        itheta = sctx.itheta
        qalloc = sctx.qalloc
        mid = imid / 32768.0
        side = iside / 32768.0

        if b0 > 1 and (itheta & 0x3fff):
            if itheta > 8192:
                delta -= delta >> (4 - lm)
            else:
                delta = min(0, delta + (n << BITRES >> (5 - lm)))
        mbits = max(0, min(b, _cdiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc

        next_lowband2 = lowband[n:] if lowband is not None else None

        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_partition(ctx, x, n, mbits, b_blocks, lowband,
                                 lm, gain * mid, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_partition(ctx, y, n, sbits, b_blocks,
                                  next_lowband2, lm, gain * side,
                                  fill >> b_blocks) << (b0 >> 1)
        else:
            cm = quant_partition(ctx, y, n, sbits, b_blocks,
                                 next_lowband2, lm, gain * side,
                                 fill >> b_blocks) << (b0 >> 1)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_partition(ctx, x, n, mbits, b_blocks, lowband,
                                  lm, gain * mid, fill)
        return cm

    # no-split leaf
    q = bits2pulses(i, lm, b)
    curr_bits = pulses2bits(i, lm, q)
    ctx.remaining_bits -= curr_bits
    while ctx.remaining_bits < 0 and q > 0:
        ctx.remaining_bits += curr_bits
        q -= 1
        curr_bits = pulses2bits(i, lm, q)
        ctx.remaining_bits -= curr_bits

    if q != 0:
        return alg_unquant(x, n, get_pulses(q), ctx.spread, b_blocks,
                           rd, gain)

    # no pulses: noise fill or fold
    cm_mask = (1 << b_blocks) - 1
    fill &= cm_mask
    if not fill:
        x[:n] = 0.0
        return 0
    if lowband is None:
        for j in range(n):
            ctx.seed = lcg_rand(ctx.seed)
            v = ctx.seed
            if v >= 1 << 31:
                v -= 1 << 32
            x[j] = float(v >> 20)
        cm = cm_mask
    else:
        for j in range(n):
            ctx.seed = lcg_rand(ctx.seed)
            tmp = 1.0 / 256
            if not (ctx.seed & 0x8000):
                tmp = -tmp
            x[j] = lowband[j] + tmp
        cm = fill
    renormalise_vector(x, n, gain)
    return cm


def quant_band(ctx: BandCtx, x: np.ndarray, n: int, b: int,
               b_blocks: int, lowband: Optional[np.ndarray], lm: int,
               lowband_out: Optional[np.ndarray], gain: float,
               lowband_scratch: Optional[np.ndarray],
               fill: int) -> int:
    n0 = n
    n_b = n // b_blocks
    b0 = b_blocks
    time_divide = 0
    recombine = 0
    long_blocks = b0 == 1
    tf_change = ctx.tf_change

    if n == 1:
        return _quant_band_n1(ctx, x, None, lowband_out)

    if tf_change > 0:
        recombine = tf_change

    if lowband_scratch is not None and lowband is not None and \
            (recombine or ((n_b & 1) == 0 and tf_change < 0) or b0 > 1):
        lowband_scratch[:n] = lowband[:n]
        lowband = lowband_scratch

    for k in range(recombine):
        if lowband is not None:
            haar1(lowband, n >> k, 1 << k)
        fill = _BIT_INTERLEAVE[fill & 0xF] \
            | _BIT_INTERLEAVE[fill >> 4] << 2
    b_blocks >>= recombine
    n_b <<= recombine

    while (n_b & 1) == 0 and tf_change < 0:
        if lowband is not None:
            haar1(lowband, n_b, b_blocks)
        fill |= fill << b_blocks
        b_blocks <<= 1
        n_b >>= 1
        time_divide += 1
        tf_change += 1
    b0 = b_blocks
    n_b0 = n_b

    if b0 > 1 and lowband is not None:
        deinterleave_hadamard(lowband, n_b >> recombine,
                              b0 << recombine, long_blocks)

    cm = quant_partition(ctx, x, n, b, b_blocks, lowband, lm, gain,
                         fill)

    # resynthesis (always, this is a decoder)
    if b0 > 1:
        interleave_hadamard(x, n_b >> recombine, b0 << recombine,
                            long_blocks)
    n_b = n_b0
    b_blocks = b0
    for _ in range(time_divide):
        b_blocks >>= 1
        n_b <<= 1
        cm |= cm >> b_blocks
        haar1(x, n_b, b_blocks)
    for k in range(recombine):
        cm = _BIT_DEINTERLEAVE[cm]
        haar1(x, n0 >> k, 1 << k)
    b_blocks <<= recombine

    if lowband_out is not None:
        nrm = math.sqrt(n0)
        for j in range(n0):
            lowband_out[j] = nrm * x[j]
    cm &= (1 << b_blocks) - 1
    return cm


def quant_band_stereo(ctx: BandCtx, x: np.ndarray, y: np.ndarray,
                      n: int, b: int, b_blocks: int,
                      lowband: Optional[np.ndarray], lm: int,
                      lowband_out: Optional[np.ndarray],
                      lowband_scratch: Optional[np.ndarray],
                      fill: int) -> int:
    rd = ctx.rd
    if n == 1:
        return _quant_band_n1(ctx, x, y, lowband_out)

    orig_fill = fill
    sctx = SplitCtx()
    b, fill = compute_theta(ctx, sctx, n, b, b_blocks, b_blocks, lm,
                            True, fill)
    inv = sctx.inv
    imid = sctx.imid
    iside = sctx.iside
    delta = sctx.delta
    itheta = sctx.itheta
    qalloc = sctx.qalloc
    mid = imid / 32768.0
    side = iside / 32768.0

    if n == 2:
        mbits = b
        sbits = 0
        if itheta != 0 and itheta != 16384:
            sbits = 1 << BITRES
        mbits -= sbits
        c = itheta > 8192
        ctx.remaining_bits -= qalloc + sbits
        x2 = y if c else x
        y2 = x if c else y
        sign = 0
        if sbits:
            sign = rd.dec_bits(1)
        sign = 1 - 2 * sign
        cm = quant_band(ctx, x2, n, mbits, b_blocks, lowband, lm,
                        lowband_out, 1.0, lowband_scratch, orig_fill)
        y2[0] = -sign * x2[1]
        y2[1] = sign * x2[0]
        x[0] *= mid
        x[1] *= mid
        y[0] *= side
        y[1] *= side
        tmp = x[0]
        x[0] = tmp - y[0]
        y[0] = tmp + y[0]
        tmp = x[1]
        x[1] = tmp - y[1]
        y[1] = tmp + y[1]
    else:
        mbits = max(0, min(b, _cdiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_band(ctx, x, n, mbits, b_blocks, lowband, lm,
                            lowband_out, 1.0, lowband_scratch, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_band(ctx, y, n, sbits, b_blocks, None, lm,
                             None, side, None, fill >> b_blocks)
        else:
            cm = quant_band(ctx, y, n, sbits, b_blocks, None, lm,
                            None, side, None, fill >> b_blocks)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_band(ctx, x, n, mbits, b_blocks, lowband, lm,
                             lowband_out, 1.0, lowband_scratch, fill)

    if n != 2:
        stereo_merge(x, y, mid, n)
    if inv:
        y[:n] = -y[:n]
    return cm


def quant_all_bands(start: int, end: int, x_full: np.ndarray,
                    y_full: Optional[np.ndarray], collapse_masks,
                    pulses: List[int], short_blocks: bool, spread: int,
                    dual_stereo: int, intensity: int,
                    tf_res: List[int], total_bits: int, balance: int,
                    rd: RangeDecoder, lm: int, coded_bands: int,
                    seed: int, disable_inv: bool):
    """bands.c quant_all_bands (decode side).  x_full/y_full are the
    full [M*eBands[21]] coefficient buffers; returns the updated
    noise seed."""
    m = 1 << lm
    b_blocks = m if short_blocks else 1
    c = 2 if y_full is not None else 1
    norm_offset = m * EBANDS[start]
    norm_len = m * EBANDS[NB_BANDS - 1] - norm_offset
    _norm = np.zeros(c * norm_len, np.float64)
    norm = _norm[:norm_len]
    norm2 = _norm[norm_len:] if c == 2 else None
    lowband_scratch = np.zeros(m * (EBANDS[NB_BANDS]
                                    - EBANDS[NB_BANDS - 1]),
                               np.float64)

    lowband_offset = 0
    update_lowband = True
    ctx = BandCtx(rd, intensity, spread, seed, disable_inv)
    for i in range(start, end):
        ctx.i = i
        last = i == end - 1
        x = x_full[m * EBANDS[i]:]
        y = y_full[m * EBANDS[i]:] if y_full is not None else None
        n = m * EBANDS[i + 1] - m * EBANDS[i]
        tell = rd.tell_frac()

        if i != start:
            balance -= tell
        remaining_bits = total_bits - tell - 1
        ctx.remaining_bits = remaining_bits
        if i <= coded_bands - 1:
            curr_balance = _cdiv(balance, min(3, coded_bands - i))
            b = max(0, min(16383, min(remaining_bits + 1,
                                      pulses[i] + curr_balance)))
        else:
            b = 0

        if (m * EBANDS[i] - n >= m * EBANDS[start]
                or i == start + 1) and \
                (update_lowband or lowband_offset == 0):
            lowband_offset = i
        if i == start + 1:
            special_hybrid_folding(norm, norm2, start, m,
                                   bool(dual_stereo))

        tf_change = tf_res[i]
        ctx.tf_change = tf_change
        scratch = None if last else lowband_scratch

        if lowband_offset != 0 and \
                (spread != SPREAD_AGGRESSIVE or b_blocks > 1
                 or tf_change < 0):
            effective_lowband = max(
                0, m * EBANDS[lowband_offset] - norm_offset - n)
            fold_start = lowband_offset
            while True:
                fold_start -= 1
                if m * EBANDS[fold_start] <= \
                        effective_lowband + norm_offset:
                    break
            fold_end = lowband_offset - 1
            while True:
                fold_end += 1
                if not (fold_end < i and m * EBANDS[fold_end]
                        < effective_lowband + norm_offset + n):
                    break
            x_cm = y_cm = 0
            fold_i = fold_start
            while True:
                x_cm |= collapse_masks[fold_i * c + 0]
                y_cm |= collapse_masks[fold_i * c + c - 1]
                fold_i += 1
                if fold_i >= fold_end:
                    break
        else:
            effective_lowband = -1
            x_cm = y_cm = (1 << b_blocks) - 1

        if dual_stereo and i == intensity:
            dual_stereo = 0
            for j in range(m * EBANDS[i] - norm_offset):
                norm[j] = 0.5 * (norm[j] + norm2[j])

        if dual_stereo:
            x_cm = quant_band(
                ctx, x, n, b // 2, b_blocks,
                norm[effective_lowband:]
                if effective_lowband != -1 else None,
                lm,
                None if last
                else norm[m * EBANDS[i] - norm_offset:],
                1.0, scratch, x_cm)
            y_cm = quant_band(
                ctx, y, n, b // 2, b_blocks,
                norm2[effective_lowband:]
                if effective_lowband != -1 else None,
                lm,
                None if last
                else norm2[m * EBANDS[i] - norm_offset:],
                1.0, scratch, y_cm)
        else:
            if y is not None:
                x_cm = quant_band_stereo(
                    ctx, x, y, n, b, b_blocks,
                    norm[effective_lowband:]
                    if effective_lowband != -1 else None,
                    lm,
                    None if last
                    else norm[m * EBANDS[i] - norm_offset:],
                    scratch, x_cm | y_cm)
                y_cm = x_cm
            else:
                x_cm = quant_band(
                    ctx, x, n, b, b_blocks,
                    norm[effective_lowband:]
                    if effective_lowband != -1 else None,
                    lm,
                    None if last
                    else norm[m * EBANDS[i] - norm_offset:],
                    1.0, scratch, x_cm | y_cm)
                y_cm = x_cm
        collapse_masks[i * c + 0] = x_cm & 0xFF
        collapse_masks[i * c + c - 1] = y_cm & 0xFF
        balance += pulses[i] + tell
        update_lowband = b > (n << BITRES)
    return ctx.seed


def anti_collapse(x_full: np.ndarray, collapse_masks, lm: int, c: int,
                  size: int, start: int, end: int, log_e: np.ndarray,
                  prev1_log_e: np.ndarray, prev2_log_e: np.ndarray,
                  pulses: List[int], seed: int) -> None:
    """bands.c anti_collapse: noise-fill fully-collapsed MDCTs of
    transient frames.  x_full is [C, size]; energies are [2, 21]."""
    for i in range(start, end):
        n0 = EBANDS[i + 1] - EBANDS[i]
        depth = ((1 + pulses[i]) // n0) >> lm
        thresh = 0.5 * celt_exp2(-0.125 * depth)
        sqrt_1 = 1.0 / math.sqrt(n0 << lm)
        for ch in range(c):
            prev1 = prev1_log_e[ch, i]
            prev2 = prev2_log_e[ch, i]
            if c == 1:
                prev1 = max(prev1, prev1_log_e[1, i])
                prev2 = max(prev2, prev2_log_e[1, i])
            ediff = max(0.0, log_e[ch, i] - min(prev1, prev2))
            r = 2.0 * celt_exp2(-ediff)
            if lm == 3:
                r *= 1.41421356
            r = min(thresh, r) * sqrt_1
            xb = x_full[ch, EBANDS[i] << lm:]
            renormalize = False
            for k in range(1 << lm):
                if not (collapse_masks[i * c + ch] & (1 << k)):
                    for j in range(n0):
                        seed = lcg_rand(seed)
                        xb[(j << lm) + k] = r if (seed & 0x8000) else -r
                    renormalize = True
            if renormalize:
                renormalise_vector(xb, n0 << lm, 1.0)
