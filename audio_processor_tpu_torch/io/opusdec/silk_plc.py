"""SILK packet-loss concealment and comfort-noise generation
(libopus 1.3.1 silk/PLC.c + silk/CNG.c, fixed point): LPC/LTP
extrapolation of lost frames with attenuating gains, comfort-noise
estimation on inactive frames and injection during loss/DTX, and the
energy-matched glue applied to the first good frame after a loss.

Runs on every frame (good frames update the PLC/CNG estimators), so
DTX streams decode bit-exactly vs libopus through the gaps.
"""

from __future__ import annotations

from typing import List

from audio_processor_tpu_torch.io.opusdec.fixp import (
    add_sat16, add_sat32, bwexpander, clz32, div32_16, inverse32_varQ,
    lshift_sat32, rshift_round, sat16, silk_rand, smlawb, smulbb,
    smulwb, smultt, smulww, sqrt_approx, sum_sqr_shift, wrap32)
from audio_processor_tpu_torch.io.opusdec.silk_nlsf import (
    lpc_inverse_pred_gain, nlsf2a)

MAX_LPC_ORDER = 16
LTP_ORDER = 5
MAX_NB_SUBFR = 4
TYPE_VOICED = 2
TYPE_NO_VOICE_ACTIVITY = 0

NB_ATT = 2
HARM_ATT_Q15 = (32440, 31130)               # 0.99, 0.95
PLC_RAND_ATTENUATE_V_Q15 = (31130, 26214)   # 0.95, 0.8
PLC_RAND_ATTENUATE_UV_Q15 = (32440, 29491)  # 0.99, 0.9
RAND_BUF_SIZE = 128
RAND_BUF_MASK = RAND_BUF_SIZE - 1
BWE_COEF_Q16 = 64881                        # SILK_FIX_CONST(0.99, 16)
V_PITCH_GAIN_START_MIN_Q14 = 11469          # 0.7
V_PITCH_GAIN_START_MAX_Q14 = 15565          # 0.95
MAX_PITCH_LAG_MS = 18
PITCH_DRIFT_FAC_Q16 = 655                   # 0.01
LOG2_INV_LPC_GAIN_HIGH_THRES = 3
LOG2_INV_LPC_GAIN_LOW_THRES = 8

CNG_BUF_MASK_MAX = 255
CNG_GAIN_SMTH_Q16 = 4634                    # 0.0707
CNG_NLSF_SMTH_Q16 = 16348                   # 0.25


class PLCState:
    """silk_PLC_struct."""

    def __init__(self) -> None:
        self.pitch_l_q8 = 0
        self.ltp_coef_q14 = [0] * LTP_ORDER
        self.prev_lpc_q12 = [0] * MAX_LPC_ORDER
        self.last_frame_lost = 0
        self.rand_seed = 0
        self.rand_scale_q14 = 0
        self.conc_energy = 0
        self.conc_energy_shift = 0
        self.prev_ltp_scale_q14 = 0
        self.prev_gain_q16 = [1 << 16, 1 << 16]
        self.fs_khz = 0
        self.nb_subfr = 2
        self.subfr_length = 20


class CNGState:
    """silk_CNG_struct."""

    def __init__(self) -> None:
        self.exc_buf_q14 = [0] * 320
        self.smth_nlsf_q15 = [0] * MAX_LPC_ORDER
        self.synth_state = [0] * MAX_LPC_ORDER
        self.smth_gain_q16 = 0
        self.rand_seed = 3176576
        self.fs_khz = 0


def _plc_reset(ch) -> None:
    """silk_PLC_Reset."""
    plc = ch.plc
    plc.pitch_l_q8 = ch.frame_length << 7
    plc.prev_gain_q16 = [1 << 16, 1 << 16]
    plc.subfr_length = 20
    plc.nb_subfr = 2


def _cng_reset(ch) -> None:
    """silk_CNG_Reset."""
    cng = ch.cng
    step_q15 = div32_16(0x7FFF, ch.lpc_order + 1)
    acc_q15 = 0
    for i in range(ch.lpc_order):
        acc_q15 += step_q15
        cng.smth_nlsf_q15[i] = acc_q15
    cng.smth_gain_q16 = 0
    cng.rand_seed = 3176576


def plc(ch, ctrl: dict, frame: List[int], lost: bool) -> None:
    """silk_PLC: conceal (lost) or update estimators (good frame)."""
    if ch.fs_khz != ch.plc.fs_khz:
        _plc_reset(ch)
        ch.plc.fs_khz = ch.fs_khz
    if lost:
        _plc_conceal(ch, ctrl, frame)
        ch.loss_cnt += 1
    else:
        _plc_update(ch, ctrl)


def _plc_update(ch, ctrl: dict) -> None:
    """silk_PLC_update (every good frame)."""
    plc = ch.plc
    ch.prev_signal_type = ch.ind["signal_type"]
    ltp_gain_q14 = 0
    if ch.ind["signal_type"] == TYPE_VOICED:
        j = 0
        while j * ch.subfr_length < ctrl["pitch_l"][ch.nb_subfr - 1]:
            if j == ch.nb_subfr:
                break
            temp = 0
            for i in range(LTP_ORDER):
                temp += ctrl["ltp_coef_q14"][
                    (ch.nb_subfr - 1 - j) * LTP_ORDER + i]
            if temp > ltp_gain_q14:
                ltp_gain_q14 = temp
                base = (ch.nb_subfr - 1 - j) * LTP_ORDER
                plc.ltp_coef_q14 = list(
                    ctrl["ltp_coef_q14"][base:base + LTP_ORDER])
                plc.pitch_l_q8 = ctrl["pitch_l"][ch.nb_subfr - 1 - j] << 8
            j += 1
        plc.ltp_coef_q14 = [0] * LTP_ORDER
        plc.ltp_coef_q14[LTP_ORDER // 2] = ltp_gain_q14
        if ltp_gain_q14 < V_PITCH_GAIN_START_MIN_Q14:
            scale_q10 = div32_16(V_PITCH_GAIN_START_MIN_Q14 << 10,
                                 max(ltp_gain_q14, 1))
            for i in range(LTP_ORDER):
                plc.ltp_coef_q14[i] = \
                    smulbb(plc.ltp_coef_q14[i], scale_q10) >> 10
        elif ltp_gain_q14 > V_PITCH_GAIN_START_MAX_Q14:
            scale_q14 = div32_16(V_PITCH_GAIN_START_MAX_Q14 << 14,
                                 max(ltp_gain_q14, 1))
            for i in range(LTP_ORDER):
                plc.ltp_coef_q14[i] = \
                    smulbb(plc.ltp_coef_q14[i], scale_q14) >> 14
    else:
        plc.pitch_l_q8 = smulbb(ch.fs_khz, 18) << 8
        plc.ltp_coef_q14 = [0] * LTP_ORDER
    plc.prev_lpc_q12 = list(ctrl["pred_coef_q12"][1][:ch.lpc_order]) \
        + [0] * (MAX_LPC_ORDER - ch.lpc_order)
    plc.prev_ltp_scale_q14 = ctrl["ltp_scale_q14"]
    plc.prev_gain_q16 = [ctrl["gains_q16"][ch.nb_subfr - 2],
                         ctrl["gains_q16"][ch.nb_subfr - 1]]
    plc.subfr_length = ch.subfr_length
    plc.nb_subfr = ch.nb_subfr


def _plc_energy(exc_q14: List[int], prev_gain_q10: List[int],
                subfr_length: int, nb_subfr: int):
    """silk_PLC_energy -> (energy1, shift1, energy2, shift2)."""
    bufs = []
    for k in range(2):
        buf = []
        for i in range(subfr_length):
            buf.append(sat16(smulww(
                exc_q14[i + (k + nb_subfr - 2) * subfr_length],
                prev_gain_q10[k]) >> 8))
        bufs.append(buf)
    e1, s1 = sum_sqr_shift(bufs[0])
    e2, s2 = sum_sqr_shift(bufs[1])
    return e1, s1, e2, s2


def _plc_conceal(ch, ctrl: dict, frame: List[int]) -> None:
    """silk_PLC_conceal."""
    plc = ch.plc
    prev_gain_q10 = [plc.prev_gain_q16[0] >> 6,
                     plc.prev_gain_q16[1] >> 6]
    if ch.first_frame_after_reset:
        plc.prev_lpc_q12 = [0] * MAX_LPC_ORDER

    e1, s1, e2, s2 = _plc_energy(ch.exc_q14, prev_gain_q10,
                                 ch.subfr_length, ch.nb_subfr)
    if (e1 >> s2) < (e2 >> s1):
        # first of the last two subframes has the lowest energy
        rand_base = max(0, (plc.nb_subfr - 1) * plc.subfr_length
                        - RAND_BUF_SIZE)
    else:
        rand_base = max(0, plc.nb_subfr * plc.subfr_length
                        - RAND_BUF_SIZE)
    rand_buf = ch.exc_q14

    b_q14 = plc.ltp_coef_q14
    rand_scale_q14 = plc.rand_scale_q14

    harm_gain_q15 = HARM_ATT_Q15[min(NB_ATT - 1, ch.loss_cnt)]
    if ch.prev_signal_type == TYPE_VOICED:
        rand_gain_q15 = PLC_RAND_ATTENUATE_V_Q15[
            min(NB_ATT - 1, ch.loss_cnt)]
    else:
        rand_gain_q15 = PLC_RAND_ATTENUATE_UV_Q15[
            min(NB_ATT - 1, ch.loss_cnt)]

    bwexpander(plc.prev_lpc_q12, ch.lpc_order, BWE_COEF_Q16)
    a_q12 = plc.prev_lpc_q12[:ch.lpc_order]

    if ch.loss_cnt == 0:
        rand_scale_q14 = 1 << 14
        if ch.prev_signal_type == TYPE_VOICED:
            for i in range(LTP_ORDER):
                rand_scale_q14 -= b_q14[i]
            rand_scale_q14 = max(3277, rand_scale_q14)
            rand_scale_q14 = smulbb(rand_scale_q14,
                                    plc.prev_ltp_scale_q14) >> 14
        else:
            inv_gain_q30 = lpc_inverse_pred_gain(a_q12, ch.lpc_order)
            down_scale_q30 = min(
                (1 << 30) >> LOG2_INV_LPC_GAIN_HIGH_THRES, inv_gain_q30)
            down_scale_q30 = max(
                (1 << 30) >> LOG2_INV_LPC_GAIN_LOW_THRES, down_scale_q30)
            down_scale_q30 <<= LOG2_INV_LPC_GAIN_HIGH_THRES
            rand_gain_q15 = smulwb(down_scale_q30, rand_gain_q15) >> 14

    rand_seed = plc.rand_seed
    lag = rshift_round(plc.pitch_l_q8, 8)
    sltp_buf_idx = ch.ltp_mem_length

    # rewhiten the LTP state
    idx = ch.ltp_mem_length - lag - ch.lpc_order - LTP_ORDER // 2
    sltp = [0] * ch.ltp_mem_length
    ch._lpc_analysis_filter(sltp, idx, a_q12,
                            ch.ltp_mem_length - idx, 0)
    sltp_q14 = [0] * (ch.ltp_mem_length + ch.frame_length)
    inv_gain_q30 = inverse32_varQ(plc.prev_gain_q16[1], 46)
    inv_gain_q30 = min(inv_gain_q30, 0x7FFFFFFF >> 1)
    for i in range(idx + ch.lpc_order, ch.ltp_mem_length):
        sltp_q14[i] = smulwb(inv_gain_q30, sltp[i])

    # LTP synthesis
    for k in range(ch.nb_subfr):
        pred_lag = sltp_buf_idx - lag + LTP_ORDER // 2
        b0, b1, b2, b3, b4 = b_q14
        for i in range(ch.subfr_length):
            p = 2
            p = smlawb(p, sltp_q14[pred_lag + i], b0)
            p = smlawb(p, sltp_q14[pred_lag + i - 1], b1)
            p = smlawb(p, sltp_q14[pred_lag + i - 2], b2)
            p = smlawb(p, sltp_q14[pred_lag + i - 3], b3)
            p = smlawb(p, sltp_q14[pred_lag + i - 4], b4)
            rand_seed = silk_rand(rand_seed)
            ridx = (rand_seed >> 25) & RAND_BUF_MASK
            sltp_q14[sltp_buf_idx] = wrap32(
                smlawb(p, rand_buf[rand_base + ridx],
                       rand_scale_q14) << 2)
            sltp_buf_idx += 1
        # gradually reduce LTP gain
        for j in range(LTP_ORDER):
            b_q14[j] = smulbb(harm_gain_q15, b_q14[j]) >> 15
        if ch.ind["signal_type"] != TYPE_NO_VOICE_ACTIVITY:
            rand_scale_q14 = smulbb(rand_scale_q14, rand_gain_q15) >> 15
        # slowly increase pitch lag
        plc.pitch_l_q8 = smlawb(plc.pitch_l_q8, plc.pitch_l_q8,
                                PITCH_DRIFT_FAC_Q16)
        plc.pitch_l_q8 = min(plc.pitch_l_q8,
                             smulbb(MAX_PITCH_LAG_MS, ch.fs_khz) << 8)
        lag = rshift_round(plc.pitch_l_q8, 8)

    # LPC synthesis on top (state prefix occupies the tail of the LTP
    # memory region, exactly as libopus reuses the buffer)
    base = ch.ltp_mem_length - MAX_LPC_ORDER
    sltp_q14[base:base + MAX_LPC_ORDER] = ch.slpc_q14
    for i in range(ch.frame_length):
        pred = ch.lpc_order >> 1
        st = base + MAX_LPC_ORDER + i
        for j in range(ch.lpc_order):
            pred = smlawb(pred, sltp_q14[st - 1 - j], a_q12[j])
        v = add_sat32(sltp_q14[st], lshift_sat32(pred, 4))
        sltp_q14[st] = v
        frame[i] = sat16(rshift_round(
            smulww(v, prev_gain_q10[1]), 8))
    ch.slpc_q14 = sltp_q14[base + ch.frame_length:
                           base + ch.frame_length + MAX_LPC_ORDER]

    plc.rand_seed = rand_seed
    plc.rand_scale_q14 = rand_scale_q14
    ctrl["pitch_l"] = [lag] * MAX_NB_SUBFR
    # libopus resets the gain-index predictor during concealment
    # (observed directly in a live 1.3.1 decoder's state: LastGainIndex
    # == 10 after every concealed frame); the next good frame's
    # absolute gain decode floors at prev_ind - 16.
    ch.last_gain_index = 10


def cng(ch, ctrl: dict, frame: List[int]) -> None:
    """silk_CNG: estimate on good inactive frames, inject during
    loss/DTX."""
    c = ch.cng
    if ch.fs_khz != c.fs_khz:
        _cng_reset(ch)
        c.fs_khz = ch.fs_khz
    if ch.loss_cnt == 0 and \
            ch.prev_signal_type == TYPE_NO_VOICE_ACTIVITY:
        for i in range(ch.lpc_order):
            c.smth_nlsf_q15[i] += smulwb(
                ch.prev_nlsf_q15[i] - c.smth_nlsf_q15[i],
                CNG_NLSF_SMTH_Q16)
        max_gain_q16 = 0
        subfr = 0
        for i in range(ch.nb_subfr):
            if ctrl["gains_q16"][i] > max_gain_q16:
                max_gain_q16 = ctrl["gains_q16"][i]
                subfr = i
        # shift excitation history, insert the loudest subframe
        n = ch.subfr_length
        c.exc_buf_q14[n:ch.nb_subfr * n] = \
            c.exc_buf_q14[:(ch.nb_subfr - 1) * n]
        c.exc_buf_q14[:n] = ch.exc_q14[subfr * n:(subfr + 1) * n]
        for i in range(ch.nb_subfr):
            c.smth_gain_q16 += smulwb(
                ctrl["gains_q16"][i] - c.smth_gain_q16,
                CNG_GAIN_SMTH_Q16)

    if ch.loss_cnt:
        gain_q16 = smulww(ch.plc.rand_scale_q14,
                          ch.plc.prev_gain_q16[1])
        if gain_q16 >= (1 << 21) or c.smth_gain_q16 > (1 << 23):
            gain_q16 = smultt(gain_q16, gain_q16)
            gain_q16 = wrap32(
                smultt(c.smth_gain_q16, c.smth_gain_q16)
                - (gain_q16 << 5))
            gain_q16 = wrap32(sqrt_approx(gain_q16) << 16)
        else:
            gain_q16 = smulww(gain_q16, gain_q16)
            gain_q16 = wrap32(
                smulww(c.smth_gain_q16, c.smth_gain_q16)
                - (gain_q16 << 5))
            gain_q16 = wrap32(sqrt_approx(gain_q16) << 8)
        gain_q10 = gain_q16 >> 6

        length = ch.frame_length
        exc_mask = CNG_BUF_MASK_MAX
        while exc_mask > length:
            exc_mask >>= 1
        seed = c.rand_seed
        sig_q14 = list(c.synth_state) + [0] * length
        for i in range(length):
            seed = silk_rand(seed)
            sig_q14[MAX_LPC_ORDER + i] = \
                c.exc_buf_q14[(seed >> 24) & exc_mask]
        c.rand_seed = seed

        a_q12 = nlsf2a(c.smth_nlsf_q15[:ch.lpc_order], ch.lpc_order)
        for i in range(length):
            pred = ch.lpc_order >> 1
            st = MAX_LPC_ORDER + i
            for j in range(ch.lpc_order):
                pred = smlawb(pred, sig_q14[st - 1 - j], a_q12[j])
            v = add_sat32(sig_q14[st], lshift_sat32(pred, 4))
            sig_q14[st] = v
            frame[i] = add_sat16(frame[i], sat16(rshift_round(
                smulww(v, gain_q10), 8)))
        c.synth_state = sig_q14[length:length + MAX_LPC_ORDER]
    else:
        # libopus zeroes only LPC_order entries (CNG.c: silk_memset
        # over psDec->LPC_order ints) — for order-10 (NB/MB) streams
        # synth_state[10..15] keeps the TAIL of the previous CNG
        # burst, and the next burst's first taps read those stale
        # values (prefix[15..6] window). Found by live-state diff:
        # after good frames libopus held [0]*10 + [32]*6 where we
        # held zeros, seeding every stereo NB post-loss divergence.
        c.synth_state[:ch.lpc_order] = [0] * ch.lpc_order


def glue_frames(ch, frame: List[int]) -> None:
    """silk_PLC_glue_frames: energy-matched fade on the first good
    frame after a loss."""
    plc = ch.plc
    if ch.loss_cnt:
        plc.conc_energy, plc.conc_energy_shift = sum_sqr_shift(frame)
        plc.last_frame_lost = 1
        return
    if plc.last_frame_lost:
        energy, energy_shift = sum_sqr_shift(frame)
        if energy_shift > plc.conc_energy_shift:
            plc.conc_energy >>= energy_shift - plc.conc_energy_shift
        elif energy_shift < plc.conc_energy_shift:
            energy >>= plc.conc_energy_shift - energy_shift
        if energy > plc.conc_energy:
            lz = clz32(plc.conc_energy) - 1
            plc.conc_energy = wrap32(plc.conc_energy << lz)
            energy >>= max(24 - lz, 0)
            frac_q24 = plc.conc_energy // max(energy, 1)
            gain_q16 = sqrt_approx(frac_q24) << 4
            slope_q16 = div32_16((1 << 16) - gain_q16, len(frame))
            slope_q16 <<= 2
            for i in range(len(frame)):
                frame[i] = smulwb(gain_q16, frame[i])
                gain_q16 += slope_q16
                if gain_q16 > (1 << 16):
                    break
    plc.last_frame_lost = 0
