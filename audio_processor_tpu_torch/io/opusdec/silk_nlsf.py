"""SILK NLSF decode chain (RFC 6716 §4.2.7.5): codebook dequant,
stabilization, NLSF->LPC conversion (NLSF2A) and the fixed-point LPC
stability check.  Bit-exact with the reference decoder."""

from __future__ import annotations

from typing import List

from audio_processor_tpu_torch.io.opusdec import _tables as T
from audio_processor_tpu_torch.io.opusdec.fixp import (
    bwexpander_32, clz32, div32_16, inverse32_varQ, rshift_round,
    rshift_round64, sat16, silk_abs, smlawb, smmul, smulbb, smulwb,
    sub_sat32, I32_MAX, I32_MIN)

NLSF_QUANT_MAX_AMPLITUDE = 4
NLSF_QUANT_LEVEL_ADJ_Q10 = 102   # SILK_FIX_CONST(0.1, 10)
MAX_LOOPS = 20
QA16 = 16
QA24 = 24
A_LIMIT_Q24 = 16773022           # SILK_FIX_CONST(0.99975, 24)
INV_GAIN_MIN_Q30 = 107374        # SILK_FIX_CONST(1/1e4, 30)
MAX_LPC_STABILIZE_ITERATIONS = 16


class NlsfCodebook:
    def __init__(self, name: str, order: int):
        p = f"SILK_NLSF_{name}_"
        self.order = order
        self.n_vectors = 32
        self.quant_step_q16 = int(getattr(T, p + "QSTEP_Q16")[0])
        self.cb1_q8 = getattr(T, p + "CB1_Q8")
        self.cb1_wght_q9 = getattr(T, p + "CB1_WGHT_Q9")
        self.cb1_icdf = getattr(T, p + "CB1_ICDF")
        self.pred_q8 = getattr(T, p + "PRED_Q8")
        self.ec_sel = getattr(T, p + "EC_SEL")
        self.ec_icdf = getattr(T, p + "EC_ICDF").reshape(-1)
        self.delta_min_q15 = getattr(T, p + "DELTA_MIN_Q15")


CB_NB_MB = NlsfCodebook("NB_MB", 10)
CB_WB = NlsfCodebook("WB", 16)


def nlsf_unpack(cb: NlsfCodebook, cb1_index: int):
    """silk_NLSF_unpack: entropy-table index and predictor per coef."""
    ec_ix: List[int] = [0] * cb.order
    pred_q8: List[int] = [0] * cb.order
    sel = cb.ec_sel[cb1_index]
    for i in range(0, cb.order, 2):
        entry = int(sel[i // 2])
        ec_ix[i] = ((entry >> 1) & 7) * (2 * NLSF_QUANT_MAX_AMPLITUDE + 1)
        pred_q8[i] = int(cb.pred_q8[i + (entry & 1) * (cb.order - 1)])
        ec_ix[i + 1] = ((entry >> 5) & 7) * \
            (2 * NLSF_QUANT_MAX_AMPLITUDE + 1)
        pred_q8[i + 1] = int(
            cb.pred_q8[i + ((entry >> 4) & 1) * (cb.order - 1) + 1])
    return ec_ix, pred_q8


def nlsf_residual_dequant(indices: List[int], pred_q8: List[int],
                          quant_step_q16: int, order: int) -> List[int]:
    out_q10 = 0
    x_q10 = [0] * order
    for i in range(order - 1, -1, -1):
        pred_q10 = smulbb(out_q10, pred_q8[i]) >> 8
        out_q10 = indices[i] << 10
        if out_q10 > 0:
            out_q10 -= NLSF_QUANT_LEVEL_ADJ_Q10
        elif out_q10 < 0:
            out_q10 += NLSF_QUANT_LEVEL_ADJ_Q10
        out_q10 = smlawb(pred_q10, out_q10, quant_step_q16)
        x_q10[i] = out_q10
    return x_q10


def nlsf_stabilize(nlsf_q15: List[int], delta_min_q15, L: int) -> None:
    dmin = [int(v) for v in delta_min_q15]
    for _ in range(MAX_LOOPS):
        min_diff = nlsf_q15[0] - dmin[0]
        I = 0
        for i in range(1, L):
            diff = nlsf_q15[i] - (nlsf_q15[i - 1] + dmin[i])
            if diff < min_diff:
                min_diff = diff
                I = i
        diff = (1 << 15) - (nlsf_q15[L - 1] + dmin[L])
        if diff < min_diff:
            min_diff = diff
            I = L
        if min_diff >= 0:
            return
        if I == 0:
            nlsf_q15[0] = dmin[0]
        elif I == L:
            nlsf_q15[L - 1] = (1 << 15) - dmin[L]
        else:
            min_center = sum(dmin[:I]) + (dmin[I] >> 1)
            max_center = (1 << 15) - sum(dmin[I + 1:L + 1]) \
                - (dmin[I] >> 1)
            center = rshift_round(nlsf_q15[I - 1] + nlsf_q15[I], 1)
            center = max(min_center, min(max_center, center))
            nlsf_q15[I - 1] = center - (dmin[I] >> 1)
            nlsf_q15[I] = nlsf_q15[I - 1] + dmin[I]
    # fallback after MAX_LOOPS
    nlsf_q15.sort()
    nlsf_q15[0] = max(nlsf_q15[0], dmin[0])
    for i in range(1, L):
        nlsf_q15[i] = max(nlsf_q15[i],
                          sat16(nlsf_q15[i - 1] + dmin[i]))
    nlsf_q15[L - 1] = min(nlsf_q15[L - 1], (1 << 15) - dmin[L])
    for i in range(L - 2, -1, -1):
        nlsf_q15[i] = min(nlsf_q15[i], nlsf_q15[i + 1] - dmin[i + 1])


def nlsf_decode(nlsf_indices: List[int], cb: NlsfCodebook) -> List[int]:
    """silk_NLSF_decode -> NLSF_Q15[order]."""
    _, pred_q8 = nlsf_unpack(cb, nlsf_indices[0])
    res_q10 = nlsf_residual_dequant(nlsf_indices[1:], pred_q8,
                                    cb.quant_step_q16, cb.order)
    row = cb.cb1_q8[nlsf_indices[0]]
    wght = cb.cb1_wght_q9[nlsf_indices[0]]
    out = [0] * cb.order
    for i in range(cb.order):
        v = (int(row[i]) << 7) + div32_16(res_q10[i] << 14, int(wght[i]))
        out[i] = max(0, min(32767, v))
    nlsf_stabilize(out, cb.delta_min_q15, cb.order)
    return out


def _find_poly(c_lsf: List[int], off: int, dd: int) -> List[int]:
    """silk_NLSF2A_find_poly over c_lsf[off], c_lsf[off+2], ..."""
    out = [0] * (dd + 1)
    out[0] = 1 << QA16
    out[1] = -c_lsf[off]
    for k in range(1, dd):
        ftmp = c_lsf[off + 2 * k]
        out[k + 1] = (out[k - 1] << 1) \
            - rshift_round64(ftmp * out[k], QA16)
        for n in range(k, 1, -1):
            out[n] += out[n - 2] - rshift_round64(ftmp * out[n - 1],
                                                  QA16)
        out[1] -= ftmp
    return out


def lpc_inverse_pred_gain(a_q12: List[int], order: int) -> int:
    """silk_LPC_inverse_pred_gain -> invGain_Q30 (0 if unstable)."""
    A = [a << (QA24 - 12) for a in a_q12]
    inv_gain_q30 = 1 << 30
    for k in range(order - 1, 0, -1):
        if A[k] > A_LIMIT_Q24 or A[k] < -A_LIMIT_Q24:
            return 0
        rc_q31 = -(A[k] << (31 - QA24))
        rc_mult1_q30 = (1 << 30) - smmul(rc_q31, rc_q31)
        inv_gain_q30 = smmul(inv_gain_q30, rc_mult1_q30) << 2
        if inv_gain_q30 < INV_GAIN_MIN_Q30:
            return 0
        mult2q = 32 - clz32(silk_abs(rc_mult1_q30))
        rc_mult2 = inverse32_varQ(rc_mult1_q30, mult2q + 30)
        for n in range((k + 1) >> 1):
            tmp1 = A[n]
            tmp2 = A[k - n - 1]
            t = rshift_round64(
                sub_sat32(tmp1, rshift_round64(tmp2 * rc_q31, 31))
                * rc_mult2, mult2q)
            if t > I32_MAX or t < I32_MIN:
                return 0
            A[n] = t
            t = rshift_round64(
                sub_sat32(tmp2, rshift_round64(tmp1 * rc_q31, 31))
                * rc_mult2, mult2q)
            if t > I32_MAX or t < I32_MIN:
                return 0
            A[k - n - 1] = t
    if A[0] > A_LIMIT_Q24 or A[0] < -A_LIMIT_Q24:
        return 0
    rc_q31 = -(A[0] << (31 - QA24))
    rc_mult1_q30 = (1 << 30) - smmul(rc_q31, rc_q31)
    inv_gain_q30 = smmul(inv_gain_q30, rc_mult1_q30) << 2
    if inv_gain_q30 < INV_GAIN_MIN_Q30:
        return 0
    return inv_gain_q30


def nlsf2a(nlsf_q15: List[int], order: int) -> List[int]:
    """silk_NLSF2A -> a_Q12[order] (int16 range)."""
    ordering = T.SILK_NLSF_ORDERING16 if order == 16 \
        else T.SILK_NLSF_ORDERING10
    cos_tab = T.SILK_LSF_COS_Q12
    c_lsf = [0] * order
    for k in range(order):
        f_int = nlsf_q15[k] >> 8
        f_frac = nlsf_q15[k] - (f_int << 8)
        cos_val = int(cos_tab[f_int])
        delta = int(cos_tab[f_int + 1]) - cos_val
        c_lsf[int(ordering[k])] = rshift_round(
            (cos_val << 8) + delta * f_frac, 20 - QA16)
    dd = order >> 1
    P = _find_poly(c_lsf, 0, dd)
    Q = _find_poly(c_lsf, 1, dd)
    a32_qa1 = [0] * order
    for k in range(dd):
        ptmp = P[k + 1] + P[k]
        qtmp = Q[k + 1] - Q[k]
        a32_qa1[k] = -qtmp - ptmp
        a32_qa1[order - k - 1] = qtmp - ptmp
    # magnitude limiting so coefs fit int16 in Q12
    for i in range(10):
        maxabs = 0
        idx = 0
        for k in range(order):
            absval = silk_abs(a32_qa1[k])
            if absval > maxabs:
                maxabs = absval
                idx = k
        maxabs = rshift_round(maxabs, QA16 + 1 - 12)
        if maxabs > 32767:
            maxabs = min(maxabs, 163838)
            sc_q16 = 65470 - div32_16((maxabs - 32767) << 14,
                                      (maxabs * (idx + 1)) >> 2)
            bwexpander_32(a32_qa1, order, sc_q16)
        else:
            break
    else:
        i = 10
    if i == 10:
        a_q12 = [sat16(rshift_round(v, QA16 + 1 - 12)) for v in a32_qa1]
        a32_qa1 = [a << (QA16 + 1 - 12) for a in a_q12]
    else:
        a_q12 = [rshift_round(v, QA16 + 1 - 12) for v in a32_qa1]
    for it in range(MAX_LPC_STABILIZE_ITERATIONS):
        if lpc_inverse_pred_gain(a_q12, order) < INV_GAIN_MIN_Q30:
            bwexpander_32(a32_qa1, order, 65536 - (2 << it))
            a_q12 = [rshift_round(v, QA16 + 1 - 12) for v in a32_qa1]
        else:
            break
    return a_q12
