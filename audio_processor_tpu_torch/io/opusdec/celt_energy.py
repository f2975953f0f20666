"""CELT energy envelope decoding (RFC 6716 §4.3.2): Laplace-coded
coarse energy with 2-D prediction, fine quantization, and the
final-bits refinement pass.  Entropy layer is integer-exact with the
reference decoder; the envelope itself is float (the reference's
float build).
"""

from __future__ import annotations

from typing import List

import numpy as np

from audio_processor_tpu_torch.io.opusdec import _tables as T
from audio_processor_tpu_torch.io.opusdec.rangedec import RangeDecoder

NB_BANDS = 21
MAX_FINE_BITS = 8

_SMALL_ENERGY_ICDF = bytes((2, 1, 0))

_PRED_COEF = [float(v) for v in T.CELT_PRED_COEF]
_BETA_COEF = [float(v) for v in T.CELT_BETA_COEF]
_BETA_INTRA = float(T.CELT_BETA_INTRA[0])
_E_PROB = T.CELT_E_PROB_MODEL  # [LM][intra][42]


def _laplace_get_freq1(fs0: int, decay: int) -> int:
    ft = 32768 - 1 * (2 * 16) - fs0
    return (ft * (16384 - decay)) >> 15


def laplace_decode(rd: RangeDecoder, fs: int, decay: int) -> int:
    """ec_laplace_decode (laplace.c)."""
    val = 0
    fm = rd.decode_bin(15)
    fl = 0
    if fm >= fs:
        val += 1
        fl = fs
        fs = _laplace_get_freq1(fs, decay) + 1
        while fs > 1 and fm >= fl + 2 * fs:
            fs *= 2
            fl += fs
            fs = ((fs - 2) * decay) >> 15
            fs += 1
            val += 1
        if fs <= 1:
            di = (fm - fl) >> 1
            val += di
            fl += 2 * di
        if fm < fl + fs:
            val = -val
        else:
            fl += fs
    rd.update(fl, min(fl + fs, 32768), 32768)
    return val


def unquant_coarse_energy(rd: RangeDecoder, start: int, end: int,
                          old_e: np.ndarray, intra: bool, C: int,
                          lm: int) -> None:
    """quant_bands.c unquant_coarse_energy; old_e is [2, 21] float."""
    prob = _E_PROB[lm][1 if intra else 0]
    if intra:
        coef = 0.0
        beta = _BETA_INTRA
    else:
        coef = _PRED_COEF[lm]
        beta = _BETA_COEF[lm]
    budget = rd.storage * 8
    prev = [0.0, 0.0]
    for i in range(start, end):
        for c in range(C):
            tell = rd.tell()
            if budget - tell >= 15:
                pi = 2 * min(i, 20)
                qi = laplace_decode(rd, int(prob[pi]) << 7,
                                    int(prob[pi + 1]) << 6)
            elif budget - tell >= 2:
                qi = rd.dec_icdf(_SMALL_ENERGY_ICDF, 2)
                qi = (qi >> 1) ^ -(qi & 1)
            elif budget - tell >= 1:
                qi = -rd.dec_bit_logp(1)
            else:
                qi = -1
            q = float(qi)
            old_e[c, i] = max(-9.0, old_e[c, i])
            tmp = coef * old_e[c, i] + prev[c] + q
            tmp = max(-28.0, tmp)
            old_e[c, i] = tmp
            prev[c] = prev[c] + q - beta * q


def unquant_fine_energy(rd: RangeDecoder, start: int, end: int,
                        old_e: np.ndarray, fine_quant: List[int],
                        C: int) -> None:
    for i in range(start, end):
        if fine_quant[i] <= 0:
            continue
        for c in range(C):
            q2 = rd.dec_bits(fine_quant[i])
            offset = (q2 + 0.5) * (1 << (14 - fine_quant[i])) \
                / 16384.0 - 0.5
            old_e[c, i] += offset


def unquant_energy_finalise(rd: RangeDecoder, start: int, end: int,
                            old_e: np.ndarray, fine_quant: List[int],
                            fine_priority: List[int], bits_left: int,
                            C: int) -> None:
    for prio in range(2):
        i = start
        while i < end and bits_left >= C:
            if fine_quant[i] >= MAX_FINE_BITS \
                    or fine_priority[i] != prio:
                i += 1
                continue
            for c in range(C):
                q2 = rd.dec_bits(1)
                offset = (q2 - 0.5) \
                    * (1 << (14 - fine_quant[i] - 1)) / 16384.0
                old_e[c, i] += offset
                bits_left -= 1
            i += 1
