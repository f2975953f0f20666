"""CELT bit allocation (RFC 6716 §4.3.3, reference rate.c): converts
the frame's bit budget plus boosts/trim into per-band PVQ bit counts,
fine-energy bits and priorities, and the coded-band / intensity /
dual-stereo decisions.  Pure integer math — must be exact, since the
entropy decoder's position depends on every decision here.
"""

from __future__ import annotations

from typing import List, Tuple

from audio_processor_tpu_torch.io.opusdec import _tables as T
from audio_processor_tpu_torch.io.opusdec.rangedec import RangeDecoder

BITRES = 3
NB_BANDS = 21
MAX_FINE_BITS = 8
FINE_OFFSET = 21
LOG_MAX_PSEUDO = 6
ALLOC_STEPS = 6

EBANDS = [int(v) for v in T.CELT_EBANDS]          # 22 entries
_LOGN = [int(v) for v in T.CELT_LOGN]
_ALLOC_VECTORS = T.CELT_ALLOC_VECTORS             # [11, 21]
_CACHE_INDEX = T.CELT_CACHE_INDEX.reshape(-1)     # [5*21] int16
_CACHE_BITS = T.CELT_CACHE_BITS                   # [392] uint8
_CACHE_CAPS = T.CELT_CACHE_CAPS.reshape(-1)       # [4*2*21] uint8
_LOG2_FRAC = [int(v) for v in T.CELT_LOG2_FRAC]
_N_ALLOC_VECTORS = _ALLOC_VECTORS.shape[0]


def get_pulses(i: int) -> int:
    return i if i < 8 else (8 + (i & 7)) << ((i >> 3) - 1)


def bits2pulses(band: int, lm: int, bits: int) -> int:
    lm += 1
    base = int(_CACHE_INDEX[lm * NB_BANDS + band])
    lo = 0
    hi = int(_CACHE_BITS[base])
    bits -= 1
    for _ in range(LOG_MAX_PSEUDO):
        mid = (lo + hi + 1) >> 1
        if int(_CACHE_BITS[base + mid]) >= bits:
            hi = mid
        else:
            lo = mid
    lo_val = -1 if lo == 0 else int(_CACHE_BITS[base + lo])
    if bits - lo_val <= int(_CACHE_BITS[base + hi]) - bits:
        return lo
    return hi


def pulses2bits(band: int, lm: int, pulses: int) -> int:
    lm += 1
    base = int(_CACHE_INDEX[lm * NB_BANDS + band])
    return 0 if pulses == 0 else int(_CACHE_BITS[base + pulses]) + 1


def init_caps(lm: int, C: int) -> List[int]:
    caps = []
    for i in range(NB_BANDS):
        n = (EBANDS[i + 1] - EBANDS[i]) << lm
        caps.append(
            (int(_CACHE_CAPS[NB_BANDS * (2 * lm + C - 1) + i]) + 64)
            * C * n >> 2)
    return caps


def _interp_bits2pulses(start: int, end: int, skip_start: int,
                        bits1: List[int], bits2: List[int],
                        thresh: List[int], cap: List[int], total: int,
                        skip_rsv: int, intensity_rsv: int,
                        dual_stereo_rsv: int, C: int, lm: int,
                        rd: RangeDecoder):
    alloc_floor = C << BITRES
    stereo = 1 if C > 1 else 0
    logM = lm << BITRES
    bits = [0] * NB_BANDS
    ebits = [0] * NB_BANDS
    fine_priority = [0] * NB_BANDS

    lo, hi = 0, 1 << ALLOC_STEPS
    for _ in range(ALLOC_STEPS):
        mid = (lo + hi) >> 1
        psum = 0
        done = False
        for j in range(end - 1, start - 1, -1):
            tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS)
            if tmp >= thresh[j] or done:
                done = True
                psum += min(tmp, cap[j])
            elif tmp >= alloc_floor:
                psum += alloc_floor
        if psum > total:
            hi = mid
        else:
            lo = mid
    psum = 0
    done = False
    for j in range(end - 1, start - 1, -1):
        tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS)
        if tmp < thresh[j] and not done:
            tmp = alloc_floor if tmp >= alloc_floor else 0
        else:
            done = True
        tmp = min(tmp, cap[j])
        bits[j] = tmp
        psum += tmp

    # Skip decisions, working back from the last coded band.
    coded_bands = end
    while True:
        j = coded_bands - 1
        if j <= skip_start:
            total += skip_rsv
            break
        left = total - psum
        percoeff = left // (EBANDS[coded_bands] - EBANDS[start])
        left -= (EBANDS[coded_bands] - EBANDS[start]) * percoeff
        rem = max(left - (EBANDS[j] - EBANDS[start]), 0)
        band_width = EBANDS[coded_bands] - EBANDS[j]
        band_bits = bits[j] + percoeff * band_width + rem
        if band_bits >= max(thresh[j], alloc_floor + (1 << BITRES)):
            if rd.dec_bit_logp(1):
                break
            psum += 1 << BITRES
            band_bits -= 1 << BITRES
        psum -= bits[j] + intensity_rsv
        if intensity_rsv > 0:
            intensity_rsv = _LOG2_FRAC[j - start]
        psum += intensity_rsv
        if band_bits >= alloc_floor:
            psum += alloc_floor
            bits[j] = alloc_floor
        else:
            bits[j] = 0
        coded_bands -= 1

    if intensity_rsv > 0:
        intensity = start + rd.dec_uint(coded_bands + 1 - start)
    else:
        intensity = 0
    if intensity <= start:
        total += dual_stereo_rsv
        dual_stereo_rsv = 0
    if dual_stereo_rsv > 0:
        dual_stereo = rd.dec_bit_logp(1)
    else:
        dual_stereo = 0

    left = total - psum
    percoeff = left // (EBANDS[coded_bands] - EBANDS[start])
    left -= (EBANDS[coded_bands] - EBANDS[start]) * percoeff
    for j in range(start, coded_bands):
        bits[j] += percoeff * (EBANDS[j + 1] - EBANDS[j])
    for j in range(start, coded_bands):
        tmp = min(left, EBANDS[j + 1] - EBANDS[j])
        bits[j] += tmp
        left -= tmp

    balance = 0
    for j in range(start, coded_bands):
        n0 = EBANDS[j + 1] - EBANDS[j]
        n = n0 << lm
        bit = bits[j] + balance
        if n > 1:
            excess = max(bit - cap[j], 0)
            bits[j] = bit - excess
            den = C * n + (1 if (C == 2 and n > 2 and not dual_stereo
                                 and j < intensity) else 0)
            nclogn = den * (_LOGN[j] + logM)
            offset = (nclogn >> 1) - den * FINE_OFFSET
            if n == 2:
                offset += (den << BITRES) >> 2
            if bits[j] + offset < (den * 2) << BITRES:
                offset += nclogn >> 2
            elif bits[j] + offset < (den * 3) << BITRES:
                offset += nclogn >> 3
            eb = max(0, bits[j] + offset + (den << (BITRES - 1)))
            eb = (eb // den) >> BITRES
            if C * eb > (bits[j] >> BITRES):
                eb = bits[j] >> stereo >> BITRES
            eb = min(eb, MAX_FINE_BITS)
            fine_priority[j] = int(
                eb * (den << BITRES) >= bits[j] + offset)
            bits[j] -= (C * eb) << BITRES
            ebits[j] = eb
        else:
            excess = max(0, bit - (C << BITRES))
            bits[j] = bit - excess
            ebits[j] = 0
            fine_priority[j] = 1
        if excess > 0:
            extra_fine = min(excess >> (stereo + BITRES),
                             MAX_FINE_BITS - ebits[j])
            ebits[j] += extra_fine
            extra_bits = (extra_fine * C) << BITRES
            fine_priority[j] = int(extra_bits >= excess - balance)
            excess -= extra_bits
        balance = excess

    for j in range(coded_bands, end):
        ebits[j] = bits[j] >> stereo >> BITRES
        bits[j] = 0
        fine_priority[j] = int(ebits[j] < 1)

    return (coded_bands, bits, ebits, fine_priority, intensity,
            dual_stereo, balance)


def compute_allocation(start: int, end: int, offsets: List[int],
                       cap: List[int], alloc_trim: int, total: int,
                       C: int, lm: int, rd: RangeDecoder
                       ) -> Tuple[int, List[int], List[int],
                                  List[int], int, int, int]:
    """clt_compute_allocation (decode side) ->
    (coded_bands, pulses, ebits, fine_priority, intensity,
     dual_stereo, balance)."""
    total = max(total, 0)
    skip_start = start
    skip_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
    total -= skip_rsv
    intensity_rsv = dual_stereo_rsv = 0
    if C == 2:
        intensity_rsv = _LOG2_FRAC[end - start]
        if intensity_rsv > total:
            intensity_rsv = 0
        else:
            total -= intensity_rsv
            dual_stereo_rsv = (1 << BITRES) \
                if total >= (1 << BITRES) else 0
            total -= dual_stereo_rsv

    thresh = [0] * NB_BANDS
    trim_offset = [0] * NB_BANDS
    for j in range(start, end):
        thresh[j] = max(C << BITRES,
                        (3 * (EBANDS[j + 1] - EBANDS[j])
                         << lm << BITRES) >> 4)
        trim_offset[j] = (C * (EBANDS[j + 1] - EBANDS[j])
                          * (alloc_trim - 5 - lm) * (end - j - 1)
                          * (1 << (lm + BITRES))) >> 6
        if (EBANDS[j + 1] - EBANDS[j]) << lm == 1:
            trim_offset[j] -= C << BITRES

    lo, hi = 1, _N_ALLOC_VECTORS - 1
    while lo <= hi:
        done = False
        psum = 0
        mid = (lo + hi) >> 1
        for j in range(end - 1, start - 1, -1):
            n = EBANDS[j + 1] - EBANDS[j]
            bitsj = (C * n * int(_ALLOC_VECTORS[mid, j]) << lm) >> 2
            if bitsj > 0:
                bitsj = max(0, bitsj + trim_offset[j])
            bitsj += offsets[j]
            if bitsj >= thresh[j] or done:
                done = True
                psum += min(bitsj, cap[j])
            elif bitsj >= C << BITRES:
                psum += C << BITRES
        if psum > total:
            hi = mid - 1
        else:
            lo = mid + 1
    hi = lo
    lo -= 1

    bits1 = [0] * NB_BANDS
    bits2 = [0] * NB_BANDS
    for j in range(start, end):
        n = EBANDS[j + 1] - EBANDS[j]
        bits1j = (C * n * int(_ALLOC_VECTORS[lo, j]) << lm) >> 2
        bits2j = cap[j] if hi >= _N_ALLOC_VECTORS else \
            (C * n * int(_ALLOC_VECTORS[hi, j]) << lm) >> 2
        if bits1j > 0:
            bits1j = max(0, bits1j + trim_offset[j])
        if bits2j > 0:
            bits2j = max(0, bits2j + trim_offset[j])
        if lo > 0:
            bits1j += offsets[j]
        bits2j += offsets[j]
        if offsets[j] > 0:
            skip_start = j
        bits2j = max(0, bits2j - bits1j)
        bits1[j] = bits1j
        bits2[j] = bits2j

    return _interp_bits2pulses(
        start, end, skip_start, bits1, bits2, thresh, cap, total,
        skip_rsv, intensity_rsv, dual_stereo_rsv, C, lm, rd)
