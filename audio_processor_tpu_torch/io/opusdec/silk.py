"""SILK decoder (RFC 6716 §4.2): indices, excitation, LTP/LPC
synthesis, stereo unmixing and packet-level framing.  Fixed-point,
bit-exact with the reference decoder's normal (no-loss) path.  Packet
loss concealment and comfort-noise generation live in silk_plc.py
(ported from libopus 1.3.1 semantics) and are invoked from
decode_frame below for lost/DTX frames — concealed frames AND the
first good frames after a gap are bit-exact vs libopus
(test_opusdec: DTX/PLC/CNG cases; the round-3 post-loss residual was
closed in r4 via BWE_AFTER_LOSS_Q16 LPC expansion + the concealment's
LastGainIndex reset — see PARITY.md).

Layout mirrors the spec's decoder stages, not any particular source:
ChannelState == one silk_decoder_state, SilkDecoder == dec_API level.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from audio_processor_tpu_torch.io.opusdec import _tables as T
from audio_processor_tpu_torch.io.opusdec.fixp import (
    bwexpander, div32_16, div32_varQ, inverse32_varQ, log2lin,
    rshift_round, smlabb, smlawb,
    smulbb, smulwb, smulww, to_i16, wrap32)
from audio_processor_tpu_torch.io.opusdec.rangedec import RangeDecoder
from audio_processor_tpu_torch.io.opusdec.silk_plc import (CNGState, PLCState,
                                                     cng, glue_frames,
                                                     plc)
from audio_processor_tpu_torch.io.opusdec.silk_nlsf import (CB_NB_MB, CB_WB,
                                                      nlsf_decode,
                                                      nlsf_unpack,
                                                      nlsf2a)
from audio_processor_tpu_torch.io.opusdec.silk_resampler import SilkResampler

# frame type
TYPE_NO_VOICE_ACTIVITY = 0
TYPE_UNVOICED = 1
TYPE_VOICED = 2
# conditional coding
CODE_INDEPENDENTLY = 0
CODE_INDEPENDENTLY_NO_LTP_SCALING = 1
CODE_CONDITIONALLY = 2

MAX_LPC_ORDER = 16
LTP_ORDER = 5
MAX_NB_SUBFR = 4
QUANT_LEVEL_ADJUST_Q10 = 80
N_LEVELS_QGAIN = 64
MAX_DELTA_GAIN_QUANT = 36
MIN_DELTA_GAIN_QUANT = -4
SHELL_FRAME = 16
SILK_MAX_PULSES = 16
N_RATE_LEVELS = 10
NLSF_QUANT_MAX_AMPLITUDE = 4
PE_MIN_LAG_MS = 2
PE_MAX_LAG_MS = 18
STEREO_INTERP_LEN_MS = 8

# silk_gains_dequant scaling constants (silk_gains derivation)
_OFFSET = ((2 * 128) // 6) + 16 * 128                      # 2090
_INV_SCALE_Q16 = (65536 * (((88 - 2) * 128) // 6)) // (N_LEVELS_QGAIN - 1)

_LTP_ICDF = [T.SILK_LTP_GAIN_ICDF_0, T.SILK_LTP_GAIN_ICDF_1,
             T.SILK_LTP_GAIN_ICDF_2]
_LTP_VQ = [T.SILK_LTP_GAIN_VQ_0, T.SILK_LTP_GAIN_VQ_1,
           T.SILK_LTP_GAIN_VQ_2]
# level -> iCDF table, indexed by partition size log2 - 1: table3 is
# the 2-sample leaf split, table0 the top 16->8+8 split
_SHELL = [T.SILK_SHELL_CODE_TABLE3, T.SILK_SHELL_CODE_TABLE2,
          T.SILK_SHELL_CODE_TABLE1, T.SILK_SHELL_CODE_TABLE0]
# offset of the (p+1)-entry iCDF for splitting p pulses
_SHELL_OFF = [0] + [(p - 1) * (p + 2) // 2 for p in range(1, 17)]


def gains_dequant(gains_ind: List[int], prev_ind: int,
                  conditional: bool, nb_subfr: int):
    """silk_gains_dequant -> (Gains_Q16[nb_subfr], new prev_ind)."""
    gains = [0] * nb_subfr
    for k in range(nb_subfr):
        if k == 0 and not conditional:
            prev_ind = max(gains_ind[k], prev_ind - 16)
        else:
            ind_tmp = gains_ind[k] + MIN_DELTA_GAIN_QUANT
            double_step = 2 * MAX_DELTA_GAIN_QUANT \
                - N_LEVELS_QGAIN + prev_ind
            if ind_tmp > double_step:
                prev_ind += (ind_tmp << 1) - double_step
            else:
                prev_ind += ind_tmp
            prev_ind = max(0, min(N_LEVELS_QGAIN - 1, prev_ind))
        gains[k] = log2lin(min(smulwb(_INV_SCALE_Q16, prev_ind)
                               + _OFFSET, 3967))
    return gains, prev_ind


def decode_pitch(lag_index: int, contour_index: int, fs_khz: int,
                 nb_subfr: int) -> List[int]:
    """silk_decode_pitch -> pitch lag per subframe."""
    if nb_subfr == MAX_NB_SUBFR:
        cb = T.SILK_CB_LAGS_STAGE2 if fs_khz == 8 \
            else T.SILK_CB_LAGS_STAGE3
    else:
        cb = T.SILK_CB_LAGS_STAGE2_10MS if fs_khz == 8 \
            else T.SILK_CB_LAGS_STAGE3_10MS
    min_lag = PE_MIN_LAG_MS * fs_khz
    max_lag = PE_MAX_LAG_MS * fs_khz
    lag = min_lag + lag_index
    return [max(min_lag, min(max_lag, lag + int(cb[k][contour_index])))
            for k in range(nb_subfr)]


def _shell_decoder(rd: RangeDecoder, pulses4: int) -> List[int]:
    def split(p: int, table) -> tuple:
        if p > 0:
            low = rd.dec_icdf(table[_SHELL_OFF[p]:], 8)
            return low, p - low
        return 0, 0

    p3 = split(pulses4, _SHELL[3])
    out = [0] * 16
    for half in range(2):
        p2 = split(p3[half], _SHELL[2])
        for q in range(2):
            p1 = split(p2[q], _SHELL[1])
            for r in range(2):
                lo, hi = split(p1[r], _SHELL[0])
                base = half * 8 + q * 4 + r * 2
                out[base] = lo
                out[base + 1] = hi
    return out


def decode_pulses(rd: RangeDecoder, signal_type: int,
                  quant_offset_type: int, frame_length: int) -> List[int]:
    """silk_decode_pulses -> pulses[frame_length] (signed)."""
    rate_level = rd.dec_icdf(
        T.SILK_RATE_LEVELS_ICDF[signal_type >> 1], 8)
    n_iter = frame_length >> 4
    if n_iter * SHELL_FRAME < frame_length:
        n_iter += 1  # 12 kHz, 10 ms: 120 samples
    sum_pulses = [0] * n_iter
    n_lshifts = [0] * n_iter
    for i in range(n_iter):
        n_lshifts[i] = 0
        sum_pulses[i] = rd.dec_icdf(
            T.SILK_PULSES_PER_BLOCK_ICDF[rate_level], 8)
        while sum_pulses[i] == SILK_MAX_PULSES + 1:
            n_lshifts[i] += 1
            off = 1 if n_lshifts[i] == 10 else 0
            sum_pulses[i] = rd.dec_icdf(
                T.SILK_PULSES_PER_BLOCK_ICDF[N_RATE_LEVELS - 1][off:],
                8)
    pulses = [0] * (n_iter * SHELL_FRAME)
    for i in range(n_iter):
        if sum_pulses[i] > 0:
            pulses[i * 16:(i + 1) * 16] = _shell_decoder(
                rd, sum_pulses[i])
    for i in range(n_iter):
        if n_lshifts[i] > 0:
            n_ls = n_lshifts[i]
            for k in range(SHELL_FRAME):
                q = pulses[i * 16 + k]
                for _ in range(n_ls):
                    q = (q << 1) + rd.dec_icdf(T.SILK_LSB_ICDF, 8)
                pulses[i * 16 + k] = q
            sum_pulses[i] |= n_ls << 5
    # signs
    base = 7 * (quant_offset_type + (signal_type << 1))
    icdf_group = T.SILK_SIGN_ICDF[base:base + 7]
    for i in range(n_iter):
        p = sum_pulses[i]
        if p > 0:
            icdf = [int(icdf_group[min(p & 0x1F, 6)]), 0]
            for k in range(SHELL_FRAME):
                if pulses[i * 16 + k] > 0:
                    if rd.dec_icdf(icdf, 8) == 0:
                        pulses[i * 16 + k] = -pulses[i * 16 + k]
    return pulses[:frame_length] if frame_length < len(pulses) \
        else pulses


class ChannelState:
    """One silk_decoder_state (mid or side channel)."""

    def __init__(self) -> None:
        self.fs_khz = 0
        self.nb_subfr = 0
        self.frame_length = 0
        self.subfr_length = 0
        self.ltp_mem_length = 0
        self.lpc_order = 0
        self.nlsf_cb = CB_NB_MB
        self.prev_nlsf_q15 = [0] * MAX_LPC_ORDER
        self.first_frame_after_reset = True
        self.lag_prev = 100
        self.last_gain_index = 10
        self.prev_gain_q16 = 65536
        self.prev_signal_type = TYPE_NO_VOICE_ACTIVITY
        self.ec_prev_signal_type = 0
        self.ec_prev_lag_index = 0
        self.out_buf = [0] * (20 * 16 + 2 * 5 * 16)
        self.slpc_q14 = [0] * MAX_LPC_ORDER
        self.n_frames_decoded = 0
        self.vad_flags = [0, 0, 0]
        self.lbrr_flag = 0
        self.lbrr_flags = [0, 0, 0]
        self.resampler: Optional[SilkResampler] = None
        self.plc = PLCState()
        self.cng = CNGState()
        self.loss_cnt = 0
        self.exc_q14 = [0] * 320
        # last decoded indices (shared between decode stages)
        self.ind = {}

    def set_fs(self, fs_khz: int, nb_subfr: int) -> None:
        self.nb_subfr = nb_subfr
        self.subfr_length = 5 * fs_khz
        self.frame_length = nb_subfr * self.subfr_length
        if fs_khz != self.fs_khz:
            self.fs_khz = fs_khz
            self.ltp_mem_length = 20 * fs_khz
            if fs_khz in (8, 12):
                self.lpc_order = 10
                self.nlsf_cb = CB_NB_MB
            else:
                self.lpc_order = 16
                self.nlsf_cb = CB_WB
            self.prev_nlsf_q15 = [0] * MAX_LPC_ORDER
            self.slpc_q14 = [0] * MAX_LPC_ORDER
            self.out_buf = [0] * (self.ltp_mem_length
                                  + 2 * self.subfr_length * 2)
            self.lag_prev = 100
            self.last_gain_index = 10
            self.prev_signal_type = TYPE_NO_VOICE_ACTIVITY
            self.first_frame_after_reset = True
            self.resampler = SilkResampler(fs_khz)

    # ----------------------------------------------------------------
    def decode_indices(self, rd: RangeDecoder, frame_index: int,
                       decode_lbrr: bool, cond: int) -> None:
        ind = self.ind = {}
        if decode_lbrr or self.vad_flags[frame_index]:
            ix = rd.dec_icdf(T.SILK_TYPE_OFFSET_VAD_ICDF, 8) + 2
        else:
            ix = rd.dec_icdf(T.SILK_TYPE_OFFSET_NO_VAD_ICDF, 8)
        ind["signal_type"] = ix >> 1
        ind["quant_offset_type"] = ix & 1
        gains_ind = []
        if cond == CODE_CONDITIONALLY:
            gains_ind.append(rd.dec_icdf(T.SILK_DELTA_GAIN_ICDF, 8))
        else:
            g = rd.dec_icdf(T.SILK_GAIN_ICDF[ind["signal_type"]],
                            8) << 3
            gains_ind.append(g + rd.dec_icdf(T.SILK_UNIFORM8_ICDF, 8))
        for _ in range(1, self.nb_subfr):
            gains_ind.append(rd.dec_icdf(T.SILK_DELTA_GAIN_ICDF, 8))
        ind["gains"] = gains_ind
        cb = self.nlsf_cb
        nlsf_ind = [rd.dec_icdf(
            cb.cb1_icdf[ind["signal_type"] >> 1], 8)]
        ec_ix, _ = nlsf_unpack(cb, nlsf_ind[0])
        for i in range(cb.order):
            ix = rd.dec_icdf(cb.ec_icdf[ec_ix[i]:], 8)
            if ix == 0:
                ix -= rd.dec_icdf(T.SILK_NLSF_EXT_ICDF, 8)
            elif ix == 2 * NLSF_QUANT_MAX_AMPLITUDE:
                ix += rd.dec_icdf(T.SILK_NLSF_EXT_ICDF, 8)
            nlsf_ind.append(ix - NLSF_QUANT_MAX_AMPLITUDE)
        ind["nlsf"] = nlsf_ind
        if self.nb_subfr == MAX_NB_SUBFR:
            ind["interp_q2"] = rd.dec_icdf(T.SILK_NLSF_INTERP_ICDF, 8)
        else:
            ind["interp_q2"] = 4
        if ind["signal_type"] == TYPE_VOICED:
            decode_absolute = True
            if cond == CODE_CONDITIONALLY and \
                    self.ec_prev_signal_type == TYPE_VOICED:
                delta = rd.dec_icdf(T.SILK_PITCH_DELTA_ICDF, 8)
                if delta > 0:
                    ind["lag_index"] = self.ec_prev_lag_index \
                        + (delta - 9)
                    decode_absolute = False
            if decode_absolute:
                low_bits = {8: T.SILK_UNIFORM4_ICDF,
                            12: T.SILK_UNIFORM6_ICDF,
                            16: T.SILK_UNIFORM8_ICDF}[self.fs_khz]
                ind["lag_index"] = rd.dec_icdf(
                    T.SILK_PITCH_LAG_ICDF, 8) * (self.fs_khz >> 1) \
                    + rd.dec_icdf(low_bits, 8)
            self.ec_prev_lag_index = ind["lag_index"]
            if self.nb_subfr == MAX_NB_SUBFR:
                contour = T.SILK_PITCH_CONTOUR_NB_ICDF \
                    if self.fs_khz == 8 else T.SILK_PITCH_CONTOUR_ICDF
            else:
                contour = T.SILK_PITCH_CONTOUR_10MS_NB_ICDF \
                    if self.fs_khz == 8 \
                    else T.SILK_PITCH_CONTOUR_10MS_ICDF
            ind["contour_index"] = rd.dec_icdf(contour, 8)
            ind["per_index"] = rd.dec_icdf(
                T.SILK_LTP_PER_INDEX_ICDF, 8)
            ind["ltp_index"] = [
                rd.dec_icdf(_LTP_ICDF[ind["per_index"]], 8)
                for _ in range(self.nb_subfr)]
            if cond == CODE_INDEPENDENTLY:
                ind["ltp_scale_index"] = rd.dec_icdf(
                    T.SILK_LTPSCALE_ICDF, 8)
            else:
                ind["ltp_scale_index"] = 0
        self.ec_prev_signal_type = ind["signal_type"]
        ind["seed"] = rd.dec_icdf(T.SILK_UNIFORM4_ICDF, 8)

    # ----------------------------------------------------------------
    def decode_parameters(self, cond: int) -> dict:
        ind = self.ind
        ctrl: dict = {}
        gains, self.last_gain_index = gains_dequant(
            ind["gains"], self.last_gain_index,
            cond == CODE_CONDITIONALLY, self.nb_subfr)
        ctrl["gains_q16"] = gains
        nlsf_q15 = nlsf_decode(ind["nlsf"], self.nlsf_cb)
        pred1 = nlsf2a(nlsf_q15, self.lpc_order)
        if self.first_frame_after_reset:
            ind["interp_q2"] = 4
        if ind["interp_q2"] < 4:
            nlsf0 = [self.prev_nlsf_q15[i]
                     + ((ind["interp_q2"]
                         * (nlsf_q15[i] - self.prev_nlsf_q15[i])) >> 2)
                     for i in range(self.lpc_order)]
            pred0 = nlsf2a(nlsf0, self.lpc_order)
        else:
            pred0 = list(pred1)
        ctrl["pred_coef_q12"] = [pred0, pred1]
        self.prev_nlsf_q15[:self.lpc_order] = nlsf_q15
        if self.loss_cnt:
            # "After a packet loss do BWE of LPC coefs"
            # (decode_parameters.c): both coefficient halves are
            # bandwidth-expanded by BWE_AFTER_LOSS_Q16 = 63570 (0.97)
            # on the FIRST good frame after any loss, flattening the
            # LPC spectrum against post-loss resonance. This was the
            # round-3 "unidentified post-loss state nuance": found by
            # poking a live libopus decoder's state (lossCnt=0 before
            # the first good frame reproduced our output exactly) and
            # reading the 0xf852 bwexpander call in the disassembly.
            bwexpander(pred0, self.lpc_order, 63570)
            bwexpander(pred1, self.lpc_order, 63570)
        if ind["signal_type"] == TYPE_VOICED:
            ctrl["pitch_l"] = decode_pitch(
                ind["lag_index"], ind["contour_index"], self.fs_khz,
                self.nb_subfr)
            cbk = _LTP_VQ[ind["per_index"]]
            ctrl["ltp_coef_q14"] = [
                int(cbk[ind["ltp_index"][k]][i]) << 7
                for k in range(self.nb_subfr)
                for i in range(LTP_ORDER)]
            ctrl["ltp_scale_q14"] = int(
                T.SILK_LTP_SCALES_Q14[ind["ltp_scale_index"]])
        else:
            ctrl["pitch_l"] = [0] * self.nb_subfr
            ctrl["ltp_coef_q14"] = [0] * (LTP_ORDER * self.nb_subfr)
            ctrl["ltp_scale_q14"] = 0
        return ctrl

    # ----------------------------------------------------------------
    def decode_core(self, ctrl: dict, pulses: List[int]) -> List[int]:
        ind = self.ind
        L = self.frame_length
        signal_type = ind["signal_type"]
        offset_q10 = int(T.SILK_QUANT_OFFSETS_Q10[signal_type >> 1]
                         [ind["quant_offset_type"]])
        nlsf_interp_flag = ind["interp_q2"] < 4
        rand_seed = ind["seed"]
        exc_q14 = [0] * L
        adj = QUANT_LEVEL_ADJUST_Q10 << 4
        off = offset_q10 << 4
        # silk_rand + wrap32 inlined (RAND(seed) = 907633515 +
        # seed*196314165 mod 2^32, sign read from the wrapped value).
        for i in range(L):
            p = pulses[i]
            rand_seed = (907633515
                         + rand_seed * 196314165) & 0xFFFFFFFF
            v = p << 14
            if v > 0:
                v -= adj
            elif v < 0:
                v += adj
            v += off
            if rand_seed >= 0x80000000:
                v = -v
            exc_q14[i] = v
            # mod-2^32 arithmetic is representation-independent: the
            # next wrap re-masks, so no signed conversion is needed.
            rand_seed = (rand_seed + p) & 0xFFFFFFFF
        # exc_Q14 is a FIXED MAX_FRAME_LENGTH (320) buffer in libopus:
        # a shorter frame leaves the tail from previous frames, and
        # the PLC's rand_buf window indexes into that fixed buffer.
        self.exc_q14[:L] = exc_q14

        xq = [0] * L
        sltp = [0] * self.ltp_mem_length
        sltp_q15 = [0] * (self.ltp_mem_length + L)
        sltp_buf_idx = self.ltp_mem_length
        slpc = list(self.slpc_q14) + [0] * self.subfr_length
        pexc_base = 0
        for k in range(self.nb_subfr):
            st_k = signal_type      # per-subframe local (see below)
            a_q12 = ctrl["pred_coef_q12"][k >> 1]
            b_q14 = ctrl["ltp_coef_q14"][k * LTP_ORDER:
                                         (k + 1) * LTP_ORDER]
            gain_q10 = ctrl["gains_q16"][k] >> 6
            inv_gain_q31 = inverse32_varQ(ctrl["gains_q16"][k], 47)
            if ctrl["gains_q16"][k] != self.prev_gain_q16:
                gain_adj_q16 = div32_varQ(self.prev_gain_q16,
                                          ctrl["gains_q16"][k], 16)
                for i in range(MAX_LPC_ORDER):
                    slpc[i] = smulww(gain_adj_q16, slpc[i])
            else:
                gain_adj_q16 = 1 << 16
            self.prev_gain_q16 = ctrl["gains_q16"][k]

            # "Avoid abrupt transition from voiced PLC to unvoiced
            # normal decoding" (decode_core.c): on the first good
            # frame after a loss whose concealment was voiced, the
            # first half of the subframes keep a weak (0.1) LTP tap
            # at the concealment's pitch lag so the extrapolated
            # waveform fades instead of cutting off. loss_cnt is
            # still nonzero here — decode_frame resets it after
            # decode_core, like libopus.
            if self.loss_cnt and \
                    self.prev_signal_type == TYPE_VOICED and \
                    self.ind["signal_type"] != TYPE_VOICED and \
                    k < MAX_NB_SUBFR // 2:
                b_q14 = [0] * LTP_ORDER
                b_q14[LTP_ORDER // 2] = 4096  # 0.25 in Q14 (libopus
                # 1.3.1 disassembly: movw $0x1000 into B[2])
                st_k = TYPE_VOICED
                ctrl["pitch_l"][k] = self.lag_prev

            if st_k == TYPE_VOICED:
                lag = ctrl["pitch_l"][k]
                if k == 0 or (k == 2 and nlsf_interp_flag):
                    start_idx = self.ltp_mem_length - lag \
                        - self.lpc_order - LTP_ORDER // 2
                    if start_idx <= 0:
                        raise ValueError("SILK: invalid pitch lag")
                    if k == 2:
                        self.out_buf[self.ltp_mem_length:
                                     self.ltp_mem_length
                                     + 2 * self.subfr_length] = \
                            xq[:2 * self.subfr_length]
                    self._lpc_analysis_filter(
                        sltp, start_idx, a_q12,
                        self.ltp_mem_length - start_idx,
                        k * self.subfr_length)
                    if k == 0:
                        inv_gain_q31 = smulwb(
                            inv_gain_q31, ctrl["ltp_scale_q14"]) << 2
                    for i in range(lag + self.lpc_order
                                   + LTP_ORDER // 2):
                        sltp_q15[sltp_buf_idx - i - 1] = smulwb(
                            inv_gain_q31,
                            sltp[self.ltp_mem_length - i - 1])
                elif gain_adj_q16 != 1 << 16:
                    for i in range(lag + LTP_ORDER // 2):
                        sltp_q15[sltp_buf_idx - i - 1] = smulww(
                            gain_adj_q16,
                            sltp_q15[sltp_buf_idx - i - 1])

            # The LTP/LPC synthesis loops below inline smlawb as
            # pred += (s*b16)>>16, exactly equal to the reference's
            # (s>>16)*b16 + ((s&0xFFFF)*b16)>>16 for every int s and
            # int16 b16 ((h*2^16+l)*b >> 16 splits exactly because
            # h*b*2^16 is a multiple of the divisor). Saturation /
            # wrapping epilogues are inlined too: these two
            # sample-serial recurrences are the fallback decoder's
            # hottest loops and helper-call overhead dominated them.
            if st_k == TYPE_VOICED:
                pres_q14 = [0] * self.subfr_length
                pred_lag = sltp_buf_idx - lag + LTP_ORDER // 2
                b0, b1, b2, b3, b4 = [to_i16(b) for b in b_q14]
                for i in range(self.subfr_length):
                    pl = pred_lag + i
                    p = (2
                         + ((sltp_q15[pl] * b0) >> 16)
                         + ((sltp_q15[pl - 1] * b1) >> 16)
                         + ((sltp_q15[pl - 2] * b2) >> 16)
                         + ((sltp_q15[pl - 3] * b3) >> 16)
                         + ((sltp_q15[pl - 4] * b4) >> 16))
                    # silk_ADD_LSHIFT32 / silk_LSHIFT: wrapping int32
                    w = (exc_q14[pexc_base + i]
                         + (p << 1)) & 0xFFFFFFFF
                    w = w - 0x100000000 if w >= 0x80000000 else w
                    pres_q14[i] = w
                    w = (w << 1) & 0xFFFFFFFF
                    sltp_q15[sltp_buf_idx] = \
                        w - 0x100000000 if w >= 0x80000000 else w
                    sltp_buf_idx += 1
            else:
                pres_q14 = exc_q14[pexc_base:
                                   pexc_base + self.subfr_length]

            order = self.lpc_order
            a16 = [to_i16(a) for a in a_q12[:order]]
            rng_j = range(order)
            # smulww(v, gain_q10) = ((v*g16)>>16) + v*gh with both
            # gain parts constant per subframe.
            g16 = to_i16(gain_q10)
            gh = rshift_round(gain_q10, 16)
            xq_base = k * self.subfr_length
            for i in range(self.subfr_length):
                pred = order >> 1
                st = MAX_LPC_ORDER + i
                for j in rng_j:
                    pred += (slpc[st - 1 - j] * a16[j]) >> 16
                # add_sat32(pres, lshift_sat32(pred, 4)), inline
                if pred > 0x07FFFFFF:
                    pred = 0x07FFFFFF
                elif pred < -0x08000000:
                    pred = -0x08000000
                v = pres_q14[i] + (pred << 4)
                if v > 0x7FFFFFFF:
                    v = 0x7FFFFFFF
                elif v < -0x80000000:
                    v = -0x80000000
                slpc[st] = v
                # sat16(rshift_round(smulww(v, gain_q10), 8))
                o = (((((v * g16) >> 16) + v * gh) >> 7) + 1) >> 1
                xq[xq_base + i] = 32767 if o > 32767 else \
                    (-32768 if o < -32768 else o)
            slpc[:MAX_LPC_ORDER] = slpc[self.subfr_length:
                                        self.subfr_length
                                        + MAX_LPC_ORDER]
            pexc_base += self.subfr_length
        self.slpc_q14 = slpc[:MAX_LPC_ORDER]
        return xq

    def _lpc_analysis_filter(self, out: List[int], start_idx: int,
                             a_q12: List[int], length: int,
                             in_offset: int) -> None:
        """silk_LPC_analysis_filter over outBuf[start_idx+in_offset:]
        writing whitened residual into out[start_idx:start_idx+length].
        """
        d = self.lpc_order
        src = self.out_buf
        base = start_idx + in_offset
        # Pure FIR over int16 history: acc (<= 16 int16xint16 terms)
        # is exact in int64, the single wrap32 lands only on the final
        # (src<<12) - acc, and rshift_round(v, 12) is
        # ((v>>11)+1)>>1 with arithmetic shifts — identical op for op
        # to the scalar helpers it replaces.
        if length > d:
            s = np.asarray(src[base:base + length], np.int64)
            a = np.array([to_i16(c) for c in a_q12[:d]], np.int64)
            win = np.lib.stride_tricks.sliding_window_view(
                s[:length - 1], d)
            acc = win @ a[::-1]
            v = (s[d:] << 12) - acc
            v = (v & 0xFFFFFFFF)
            v -= (v >> 31) << 32          # wrap32, vectorized
            vals = np.clip(((v >> 11) + 1) >> 1, -32768, 32767)
            out[start_idx + d:start_idx + length] = vals.tolist()
        for ix in range(d):
            out[start_idx + ix] = 0

    # ----------------------------------------------------------------
    def decode_frame(self, rd: RangeDecoder, frame_index: int,
                     cond: int) -> List[int]:
        self.decode_indices(rd, frame_index, False, cond)
        pulses = decode_pulses(rd, self.ind["signal_type"],
                               self.ind["quant_offset_type"],
                               self.frame_length)
        ctrl = self.decode_parameters(cond)
        xq = self.decode_core(ctrl, pulses)
        plc(self, ctrl, xq, lost=False)   # update PLC estimators
        self.loss_cnt = 0
        self.prev_signal_type = self.ind["signal_type"]
        self.first_frame_after_reset = False
        self._finish_frame(ctrl, xq)
        return xq

    def conceal_frame(self) -> List[int]:
        """silk_decode_frame with FLAG_PACKET_LOST: LPC/LTP
        extrapolation + comfort noise (silk_plc.py)."""
        self.ind["signal_type"] = self.prev_signal_type
        ctrl = {"pitch_l": [0] * MAX_NB_SUBFR}
        xq = [0] * self.frame_length
        plc(self, ctrl, xq, lost=True)    # conceal; increments loss_cnt
        self._finish_frame(ctrl, xq)
        return xq

    def _finish_frame(self, ctrl: dict, xq: List[int]) -> None:
        """Shared tail of silk_decode_frame: CNG estimation/
        injection, PLC frame gluing, THEN the output-buffer update —
        outBuf holds the frame as heard (incl. comfort noise and the
        post-loss fade), which the next voiced frame's LTP
        rewhitening reads."""
        mv_len = self.ltp_mem_length - self.frame_length
        self.out_buf[:mv_len] = self.out_buf[self.frame_length:
                                             self.ltp_mem_length]
        self.out_buf[mv_len:self.ltp_mem_length] = xq
        cng(self, ctrl, xq)
        glue_frames(self, xq)
        self.lag_prev = ctrl["pitch_l"][self.nb_subfr - 1]


# --------------------------------------------------------------------
# stereo
# --------------------------------------------------------------------

def stereo_decode_pred(rd: RangeDecoder) -> List[int]:
    """silk_stereo_decode_pred -> pred_Q13[2]."""
    n = rd.dec_icdf(T.SILK_STEREO_PRED_JOINT_ICDF, 8)
    ix = [[0, 0, 0], [0, 0, 0]]
    ix[0][2] = div32_16(n, 5)
    ix[1][2] = n - 5 * ix[0][2]
    for c in range(2):
        ix[c][0] = rd.dec_icdf(T.SILK_UNIFORM3_ICDF, 8)
        ix[c][1] = rd.dec_icdf(T.SILK_UNIFORM5_ICDF, 8)
    pred = [0, 0]
    for c in range(2):
        base = ix[c][2] * 3 + ix[c][0]
        low = int(T.SILK_STEREO_PRED_QUANT_Q13[base])
        step = smulwb(int(T.SILK_STEREO_PRED_QUANT_Q13[base + 1])
                      - low, 6554)  # 0.5/5 in Q16
        pred[c] = smlabb(low, step, 2 * ix[c][1] + 1)
    pred[0] -= pred[1]
    return pred


class StereoState:
    def __init__(self) -> None:
        self.pred_prev_q13 = [0, 0]
        self.s_mid = [0, 0]
        self.s_side = [0, 0]

    def ms_to_lr(self, x1: List[int], x2: List[int],
                 pred_q13: List[int], fs_khz: int,
                 frame_length: int) -> None:
        """silk_stereo_MS_to_LR in place on 2-prefixed buffers."""
        x1[0:2] = self.s_mid
        x2[0:2] = self.s_side
        self.s_mid = list(x1[frame_length:frame_length + 2])
        self.s_side = list(x2[frame_length:frame_length + 2])
        pred0 = self.pred_prev_q13[0]
        pred1 = self.pred_prev_q13[1]
        denom = div32_16(1 << 16, STEREO_INTERP_LEN_MS * fs_khz)
        delta0 = rshift_round(
            smulbb(pred_q13[0] - self.pred_prev_q13[0], denom), 16)
        delta1 = rshift_round(
            smulbb(pred_q13[1] - self.pred_prev_q13[1], denom), 16)
        interp_len = STEREO_INTERP_LEN_MS * fs_khz
        # No feedback anywhere (x2[n+1] is read only at its own n,
        # x1 only after both prediction loops), so the whole unmix
        # vectorizes: per-sample predictors are pred_prev + (n+1)*
        # delta during the interp phase and the target weights after;
        # smlawb(a, b, c) = a + (b*to_i16(c))>>16 exactly, sums fit
        # int64, and the rounding/saturation epilogues apply
        # elementwise.
        x1a = np.asarray(x1[:frame_length + 2], np.int64)
        mid = x1a[1:-1]
        mid3 = (x1a[:-2] + x1a[2:] + (mid << 1)) << 9
        x2a = np.asarray(x2[1:frame_length + 1], np.int64)
        p0 = np.full(frame_length, pred_q13[0], np.int64)
        p1 = np.full(frame_length, pred_q13[1], np.int64)
        if interp_len:
            steps = np.arange(1, interp_len + 1, dtype=np.int64)
            p0[:interp_len] = pred0 + steps * delta0
            p1[:interp_len] = pred1 + steps * delta1
        p0 = ((p0 & 0xFFFF) ^ 0x8000) - 0x8000   # to_i16
        p1 = ((p1 & 0xFFFF) ^ 0x8000) - 0x8000
        s = (x2a << 8) + ((mid3 * p0) >> 16) \
            + (((mid << 11) * p1) >> 16)
        side = np.clip(((s >> 7) + 1) >> 1, -32768, 32767)
        self.pred_prev_q13 = list(pred_q13)
        x1[1:frame_length + 1] = np.clip(
            mid + side, -32768, 32767).tolist()
        x2[1:frame_length + 1] = np.clip(
            mid - side, -32768, 32767).tolist()


# --------------------------------------------------------------------
# packet level (dec_API equivalent)
# --------------------------------------------------------------------

class SilkDecoder:
    """Packet-level SILK decoder producing 48 kHz int16 channels."""

    def __init__(self) -> None:
        self.channels = [ChannelState(), ChannelState()]
        self.stereo = StereoState()
        self.n_channels_internal = 0
        self.prev_decode_only_middle = 0
        self.capture_xq = None  # debug: list to collect 16 kHz frames

    def conceal(self, n_samples_48k: int, api_channels: int,
                payload_ms: int = 0) -> List[List[int]]:
        """silk_Decode with FLAG_PACKET_LOST: extrapolate enough
        internal frames to cover ``n_samples_48k`` output samples;
        same channel-count adaptation as decode().

        ``payload_ms`` (10 or 20) reconfigures the concealed frame
        duration like dec_API.c's payloadSize_ms: a 10 ms PLC request
        on a 20 ms-configured state conceals ONE 2-subframe frame, not
        half of a 4-subframe frame (opus_decode_frame passes
        max(10, audiosize_ms), so 5 ms transition PLC runs at 10 ms).
        0 keeps the last-configured duration."""
        n_channels = max(1, self.n_channels_internal)
        ch0 = self.channels[0]
        if ch0.fs_khz == 0:
            # never decoded anything: true silence
            return [[0] * n_samples_48k
                    for _ in range(min(api_channels, 2))]
        if payload_ms in (10, 20):
            for ch in self.channels[:n_channels]:
                if ch.fs_khz:
                    ch.set_fs(ch.fs_khz, payload_ms // 5)
        frame_length = ch0.frame_length
        fs_khz = ch0.fs_khz
        api_mono = api_channels == 1 and n_channels == 2
        n_out = 1 if api_mono else n_channels
        out: List[List[int]] = [[] for _ in range(n_out)]
        if n_channels == 2 and self.prev_decode_only_middle:
            # dec_API.c runs its "reset side channel decoder
            # prediction memory" block on EVERY frame with the local
            # decode_only_middle defaulting to 0 — so a LOST frame
            # while in mid-only mode resets the side state (outBuf,
            # sLPC, lagPrev, LastGainIndex, signal type), even though
            # the side is not concealed (has_side stays false because
            # prev_decode_only_middle is NOT updated on loss).
            side = self.channels[1]
            side.out_buf = [0] * len(side.out_buf)
            side.slpc_q14 = [0] * MAX_LPC_ORDER
            side.lag_prev = 100
            side.last_gain_index = 10
            side.prev_signal_type = TYPE_NO_VOICE_ACTIVITY
            side.first_frame_after_reset = True
        produced = 0
        while produced < n_samples_48k:
            xqs = []
            for n in range(n_channels):
                ch = self.channels[n]
                if n == 0 or not self.prev_decode_only_middle:
                    xqs.append(ch.conceal_frame())
                else:
                    xqs.append([0] * frame_length)
            if n_channels == 2:
                x1 = [0, 0] + xqs[0]
                x2 = [0, 0] + xqs[1]
                self.stereo.ms_to_lr(x1, x2, self.stereo.pred_prev_q13,
                                     fs_khz, frame_length)
                if api_mono:
                    mixed = [(x1[i] + x2[i]) >> 1
                             for i in range(1, 1 + frame_length)]
                    out[0] += self.channels[0].resampler.process(mixed)
                else:
                    for n, x in enumerate((x1, x2)):
                        out[n] += self.channels[n].resampler.process(
                            x[1:1 + frame_length])
            else:
                x1 = list(self.stereo.s_mid) + xqs[0]
                self.stereo.s_mid = x1[frame_length:frame_length + 2]
                out[0] += self.channels[0].resampler.process(
                    x1[1:1 + frame_length])
            produced += frame_length * 48 // fs_khz
        # prev_decode_only_middle is NOT updated on loss (dec_API.c
        # assigns it only under lostFlag == FLAG_DECODE_NORMAL): a
        # mid-only stream keeps skipping side concealment across an
        # entire loss burst, and the next good frame still sees the
        # mid-only history for its conditional-coding choice.
        return [o[:n_samples_48k] for o in out]

    def decode(self, rd: RangeDecoder, n_channels: int, fs_khz: int,
               frame_ms: int, api_channels: int = 0
               ) -> List[List[int]]:
        """Decode all SILK frames of one Opus frame; returns the
        output channels of 48 kHz samples (api_channels of them when
        channel adaptation applies, else n_channels).

        Channel-count adaptation follows dec_API.c exactly:
        - stereo frame, mono API: mix L/R at the internal rate and
          resample once through channel 0's resampler (NOT the same
          as mixing the two resampled outputs — per-sample rounding
          inside the resampler).
        - mono -> stereo transition (stereo API): reset the stereo
          prediction/side history and copy channel 0's resampler
          state into channel 1.
        - stereo -> mono transition at the same internal rate
          (stereo API): the first mono frame's right channel is the
          mono signal resampled through channel 1's (right-history)
          resampler; afterwards plain duplication (handled by the
          caller)."""
        api_channels = api_channels or n_channels
        api_mono = api_channels == 1 and n_channels == 2
        n_frames = 1 if frame_ms <= 20 else frame_ms // 20
        nb_subfr = 2 if frame_ms == 10 else 4
        prev_internal = self.n_channels_internal
        stereo_to_mono = (n_channels == 1 and prev_internal == 2
                          and fs_khz == self.channels[0].fs_khz)
        if n_channels == 2 and prev_internal < 2:
            self.channels[1] = ChannelState()  # fresh side state
        self.n_channels_internal = n_channels
        for n in range(n_channels):
            ch = self.channels[n]
            ch.set_fs(fs_khz, nb_subfr)
            ch.n_frames_decoded = 0
        if api_channels == 2 and n_channels == 2 and prev_internal == 1:
            # dec_API.c mono -> stereo: reset stereo prediction/side
            # history, continue the right channel from the left's
            # resampler state
            import copy as _copy

            self.stereo.pred_prev_q13 = [0, 0]
            self.stereo.s_side = [0, 0]
            self.channels[1].resampler = _copy.deepcopy(
                self.channels[0].resampler)
        # VAD + LBRR flags
        for n in range(n_channels):
            ch = self.channels[n]
            ch.vad_flags = [rd.dec_bit_logp(1) for _ in range(n_frames)]
            ch.lbrr_flag = rd.dec_bit_logp(1)
            ch.lbrr_flags = [0] * n_frames
        for n in range(n_channels):
            ch = self.channels[n]
            if ch.lbrr_flag:
                if n_frames == 1:
                    ch.lbrr_flags[0] = 1
                else:
                    tab = T.SILK_LBRR_FLAGS_2_ICDF if n_frames == 2 \
                        else T.SILK_LBRR_FLAGS_3_ICDF
                    sym = rd.dec_icdf(tab, 8) + 1
                    for i in range(n_frames):
                        ch.lbrr_flags[i] = (sym >> i) & 1
        # parse (and discard) LBRR frames to keep the coder in sync
        for i in range(n_frames):
            for n in range(n_channels):
                ch = self.channels[n]
                if not ch.lbrr_flags[i]:
                    continue
                if n_channels == 2 and n == 0:
                    stereo_decode_pred(rd)
                    if not self.channels[1].lbrr_flags[i]:
                        rd.dec_icdf(T.SILK_STEREO_ONLY_MID_ICDF, 8)
                cond = CODE_CONDITIONALLY \
                    if i > 0 and ch.lbrr_flags[i - 1] \
                    else CODE_INDEPENDENTLY
                ch.decode_indices(rd, i, True, cond)
                decode_pulses(rd, ch.ind["signal_type"],
                              ch.ind["quant_offset_type"],
                              ch.frame_length)
        # regular frames
        out: List[List[int]] = [[] for _ in range(n_channels)]
        frame_length = self.channels[0].frame_length
        for i in range(n_frames):
            decode_only_middle = 0
            ms_pred = [0, 0]
            if n_channels == 2:
                ms_pred = stereo_decode_pred(rd)
                if self.channels[1].vad_flags[i] == 0:
                    decode_only_middle = rd.dec_icdf(
                        T.SILK_STEREO_ONLY_MID_ICDF, 8)
                if decode_only_middle == 0 and \
                        self.prev_decode_only_middle == 1:
                    side = self.channels[1]
                    side.out_buf = [0] * len(side.out_buf)
                    side.slpc_q14 = [0] * MAX_LPC_ORDER
                    side.lag_prev = 100
                    side.last_gain_index = 10
                    side.prev_signal_type = TYPE_NO_VOICE_ACTIVITY
                    side.first_frame_after_reset = True
            xqs = []
            for n in range(n_channels):
                ch = self.channels[n]
                if n == 0 or not decode_only_middle:
                    frame_idx = self.channels[0].n_frames_decoded - n
                    if frame_idx <= 0:
                        cond = CODE_INDEPENDENTLY
                    elif n == 1 and self.prev_decode_only_middle:
                        cond = CODE_INDEPENDENTLY_NO_LTP_SCALING
                    else:
                        cond = CODE_CONDITIONALLY
                    xqs.append(ch.decode_frame(rd, i, cond))
                    ch.n_frames_decoded = i + 1
                else:
                    xqs.append([0] * frame_length)
            if self.capture_xq is not None:
                self.capture_xq.append([list(x) for x in xqs])
            # buffering (2-sample prefix), unmix, resample
            if n_channels == 2:
                x1 = [0, 0] + xqs[0]
                x2 = [0, 0] + xqs[1]
                self.stereo.ms_to_lr(x1, x2, ms_pred, fs_khz,
                                     frame_length)
                if api_mono:
                    mixed = [(x1[i] + x2[i]) >> 1
                             for i in range(1, 1 + frame_length)]
                    out[0] += self.channels[0].resampler.process(mixed)
                else:
                    for n, x in enumerate((x1, x2)):
                        out[n] += self.channels[n].resampler.process(
                            x[1:1 + frame_length])
            else:
                x1 = list(self.stereo.s_mid) + xqs[0]
                self.stereo.s_mid = x1[frame_length:frame_length + 2]
                left = self.channels[0].resampler.process(
                    x1[1:1 + frame_length])
                out[0] += left
                if stereo_to_mono:
                    # first mono frame after internal stereo: right
                    # channel continues through channel 1's resampler
                    if i == 0:
                        out.append(self.channels[1].resampler.process(
                            x1[1:1 + frame_length]))
                    else:
                        out[1] += left
            self.prev_decode_only_middle = decode_only_middle
        return out
