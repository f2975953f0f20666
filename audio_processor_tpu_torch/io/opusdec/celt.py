"""CELT frame decoder (RFC 6716 §4.3, reference celt_decoder.c):
flag/energy/allocation/PVQ entropy decode, inverse MDCT synthesis
with TDAC overlap, anti-collapse, pitch postfilter and deemphasis.

State layout mirrors one CELTDecoder: energy memories, decode buffer
(IMDCT overlap history), postfilter parameters and the shared noise
seed.  The entropy layer is integer-exact with libopus; waveform math
is float64 against the reference's float32 (end-to-end tolerance is
enforced by tests/test_opusdec.py).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from audio_processor_tpu_torch.io.opusdec import _tables as T
from audio_processor_tpu_torch.io.opusdec.celt_bands import (anti_collapse,
                                                       celt_exp2,
                                                       quant_all_bands)
from audio_processor_tpu_torch.io.opusdec.celt_energy import (
    unquant_coarse_energy, unquant_energy_finalise, unquant_fine_energy)
from audio_processor_tpu_torch.io.opusdec.celt_rate import (BITRES, EBANDS,
                                                      compute_allocation,
                                                      init_caps)
from audio_processor_tpu_torch.io.opusdec.rangedec import RangeDecoder

try:                                  # vectorized de-emphasis IIR
    from scipy.signal import lfilter as _lfilter
except Exception:                     # pragma: no cover
    _lfilter = None

NB_BANDS = 21
SHORT_MDCT_SIZE = 120
MAX_LM = 3
OVERLAP = 120
DECODE_BUFFER_SIZE = 2048
COMBFILTER_MINPERIOD = 15
SPREAD_NORMAL = 2

_WINDOW = np.asarray(T.CELT_WINDOW, np.float64)
_E_MEANS = [float(v) for v in T.CELT_E_MEANS]
_PF_GAINS = np.asarray(T.CELT_POSTFILTER_GAINS, np.float64)  # [3,3]
_PREEMPH_COEF = float(T.CELT_PREEMPH[0])
_SPREAD_ICDF = bytes(int(v) for v in T.CELT_SPREAD_ICDF)
_TAPSET_ICDF = bytes(int(v) for v in T.CELT_TAPSET_ICDF)
_TRIM_ICDF = bytes(int(v) for v in T.CELT_TRIM_ICDF)
_TF_SELECT = T.CELT_TF_SELECT  # [4][8] int8

# end band per audio bandwidth (opus_decoder.c)
END_BAND = {"NB": 13, "MB": 17, "WB": 17, "SWB": 19, "FB": 21}

_imdct_cache = {}


def _imdct_matrix(n2: int) -> np.ndarray:
    """Raw backward-MDCT matrix: r[j] = sum_k X[k] *
    cos(pi/N2 * (j + 0.5 + N2/2 + N2/2... )) — the middle N2 samples
    of the length-2*N2 inverse MDCT, matching kiss mdct_backward's
    pre/post-rotate output (scale 1/2, caller folds the edges)."""
    mat = _imdct_cache.get(n2)
    if mat is None:
        j = np.arange(n2, dtype=np.float64)[:, None]
        k = np.arange(n2, dtype=np.float64)[None, :]
        # middle section of the 2*N2 IMDCT: time index N2/2 + j with
        # the standard n + 0.5 + N2/2 phase -> j + 0.5 + N2
        ang = (math.pi / n2) * (j + 0.5 + n2) * (k + 0.5)
        mat = np.cos(ang)
        _imdct_cache[n2] = mat
    return mat


def _tf_decode(rd: RangeDecoder, start: int, end: int,
               is_transient: bool, lm: int) -> List[int]:
    budget = rd.storage * 8
    tell = rd.tell()
    logp = 2 if is_transient else 4
    tf_select_rsv = int(lm > 0 and tell + logp + 1 <= budget)
    budget -= tf_select_rsv
    tf_changed = curr = 0
    tf_res = [0] * NB_BANDS
    for i in range(start, end):
        if tell + logp <= budget:
            curr ^= rd.dec_bit_logp(logp)
            tell = rd.tell()
            tf_changed |= curr
        tf_res[i] = curr
        logp = 4 if is_transient else 5
    tf_select = 0
    ti = 1 if is_transient else 0
    if tf_select_rsv and \
            _TF_SELECT[lm][4 * ti + 0 + tf_changed] != \
            _TF_SELECT[lm][4 * ti + 2 + tf_changed]:
        tf_select = rd.dec_bit_logp(1)
    for i in range(start, end):
        tf_res[i] = int(_TF_SELECT[lm][4 * ti + 2 * tf_select
                                       + tf_res[i]])
    return tf_res


class CeltDecoder:
    """One CELTDecoder (decode-only, 48 kHz mode, downsample=1)."""

    def __init__(self, channels: int):
        self.cc = channels
        self.disable_inv = channels == 1
        self.start = 0
        self.end = NB_BANDS
        self.reset()

    def reset(self) -> None:
        cc = self.cc
        self.rng = 0
        self.old_e = np.zeros((2, NB_BANDS))
        self.old_log_e = np.full((2, NB_BANDS), -28.0)
        self.old_log_e2 = np.full((2, NB_BANDS), -28.0)
        self.decode_mem = np.zeros((cc, DECODE_BUFFER_SIZE + OVERLAP))
        self.preemph_mem = np.zeros(cc)
        self.postfilter_period = 0
        self.postfilter_gain = 0.0
        self.postfilter_tapset = 0
        self.postfilter_period_old = 0
        self.postfilter_gain_old = 0.0
        self.postfilter_tapset_old = 0
        # PLC state (celt_decoder.c DECODER_RESET_START region +
        # backgroundLogE, which lives in the zero-cleared _decode_mem
        # blob): loss counters, last pitch, per-channel PLC LPC, and
        # the tracked background noise floor.
        self.loss_count = 0
        self.skip_plc = False
        self.last_pitch_index = 0
        self.plc_lpc = np.zeros((cc, 24))
        self.background_log_e = np.zeros((2, NB_BANDS))

    # ----------------------------------------------------------------
    def decode(self, data_len: int, rd: RangeDecoder, frame_size: int,
               C: int) -> np.ndarray:
        """celt_decode_with_ec -> [CC, frame_size] float in [-1, 1].

        data_len is the byte length backing ``rd`` (bit budget); C is
        the stream channel count (CC is the decoder's)."""
        cc = self.cc
        n = frame_size
        lm = {SHORT_MDCT_SIZE: 0, 2 * SHORT_MDCT_SIZE: 1,
              4 * SHORT_MDCT_SIZE: 2, 8 * SHORT_MDCT_SIZE: 3}[n]
        m = 1 << lm
        # Pitch-based PLC needs two consecutive good frames first
        # (celt_decoder.c: skip_plc = loss_count != 0).
        self.skip_plc = self.loss_count != 0
        start, end = self.start, self.end
        eff_end = end
        if C == 1:
            # celt_decode_with_ec: mono frames predict coarse energy
            # from the max of both channels' history
            self.old_e[0] = np.maximum(self.old_e[0], self.old_e[1])

        total_bits = data_len * 8
        tell = rd.tell()
        if tell >= total_bits:
            silence = 1
        elif tell == 1:
            silence = rd.dec_bit_logp(15)
        else:
            silence = 0
        if silence:
            # pretend we've read all the remaining bits
            rd.nbits_total += total_bits - rd.tell()
            tell = total_bits

        postfilter_gain = 0.0
        postfilter_pitch = 0
        postfilter_tapset = 0
        if start == 0 and tell + 16 <= total_bits:
            if rd.dec_bit_logp(1):
                octave = rd.dec_uint(6)
                postfilter_pitch = (16 << octave) \
                    + rd.dec_bits(4 + octave) - 1
                qg = rd.dec_bits(3)
                if rd.tell() + 2 <= total_bits:
                    postfilter_tapset = rd.dec_icdf(_TAPSET_ICDF, 2)
                postfilter_gain = 0.09375 * (qg + 1)
            tell = rd.tell()

        if lm > 0 and tell + 3 <= total_bits:
            is_transient = rd.dec_bit_logp(3)
            tell = rd.tell()
        else:
            is_transient = 0
        short_blocks = bool(is_transient)

        intra_ener = rd.dec_bit_logp(3) \
            if tell + 3 <= total_bits else 0
        unquant_coarse_energy(rd, start, end, self.old_e,
                              bool(intra_ener), C, lm)

        tf_res = _tf_decode(rd, start, end, bool(is_transient), lm)

        tell = rd.tell()
        spread = SPREAD_NORMAL
        if tell + 4 <= total_bits:
            spread = rd.dec_icdf(_SPREAD_ICDF, 5)

        cap = init_caps(lm, C)

        offsets = [0] * NB_BANDS
        dynalloc_logp = 6
        total_bits8 = total_bits << BITRES
        total_boost = 0
        tell_f = rd.tell_frac()
        for i in range(start, end):
            width = C * (EBANDS[i + 1] - EBANDS[i]) << lm
            quanta = min(width << BITRES, max(6 << BITRES, width))
            dynalloc_loop_logp = dynalloc_logp
            boost = 0
            while tell_f + (dynalloc_loop_logp << BITRES) \
                    < total_bits8 - total_boost and boost < cap[i]:
                flag = rd.dec_bit_logp(dynalloc_loop_logp)
                tell_f = rd.tell_frac()
                if not flag:
                    break
                boost += quanta
                total_boost += quanta
                dynalloc_loop_logp = 1
            offsets[i] = boost
            if boost > 0:
                dynalloc_logp = max(2, dynalloc_logp - 1)

        alloc_trim = 5
        if tell_f + (6 << BITRES) <= total_bits8 - total_boost:
            alloc_trim = rd.dec_icdf(_TRIM_ICDF, 7)
            tell_f = rd.tell_frac()

        bits = (data_len * 8 << BITRES) - rd.tell_frac() - 1
        anti_collapse_rsv = (1 << BITRES) if (
            is_transient and lm >= 2
            and bits >= ((lm + 2) << BITRES)) else 0
        bits -= anti_collapse_rsv

        (coded_bands, pulses, fine_quant, fine_priority, intensity,
         dual_stereo, balance) = compute_allocation(
            start, end, offsets, cap, alloc_trim, bits, C, lm, rd)

        unquant_fine_energy(rd, start, end, self.old_e, fine_quant, C)

        # shift the decode buffer to make room for this frame
        for ch in range(cc):
            self.decode_mem[ch, :DECODE_BUFFER_SIZE - n + OVERLAP // 2] = \
                self.decode_mem[ch, n:DECODE_BUFFER_SIZE + OVERLAP // 2]

        # decode band shapes
        nfrm = m * EBANDS[NB_BANDS]
        x_full = np.zeros((C, nfrm))
        collapse_masks = bytearray(NB_BANDS * C)
        self.rng = quant_all_bands(
            start, end, x_full[0], x_full[1] if C == 2 else None,
            collapse_masks, pulses, short_blocks, spread, dual_stereo,
            intensity, tf_res,
            data_len * (8 << BITRES) - anti_collapse_rsv, balance, rd,
            lm, coded_bands, self.rng, self.disable_inv)

        anti_collapse_on = rd.dec_bits(1) if anti_collapse_rsv > 0 \
            else 0
        unquant_energy_finalise(rd, start, end, self.old_e, fine_quant,
                                fine_priority,
                                data_len * 8 - rd.tell(), C)
        if anti_collapse_on:
            anti_collapse(x_full, collapse_masks, lm, C, nfrm, start,
                          end, self.old_e, self.old_log_e,
                          self.old_log_e2, pulses, self.rng)

        if silence:
            self.old_e[:, :] = -28.0

        out_syn = self._synthesis(x_full, n, C, bool(is_transient),
                                  lm, start, eff_end, bool(silence))

        self._apply_postfilter(out_syn, n, lm, postfilter_pitch,
                               postfilter_gain, postfilter_tapset)

        pcm = self._deemphasis(out_syn, n)

        # energy history bookkeeping
        if C == 1:
            self.old_e[1] = self.old_e[0]
        if not is_transient:
            self.old_log_e2[:] = self.old_log_e
            self.old_log_e[:] = self.old_e
            # Background noise floor: rises <= 2.4 dB/s normally, up
            # to 6 dB per update when recovering from a long loss run
            # (celt_decode_with_ec's backgroundLogE tracker; the
            # loss_count here is the pre-reset value).
            inc = m * 0.001 if self.loss_count < 10 else 1.0
            self.background_log_e = np.minimum(
                self.background_log_e + inc, self.old_log_e)
        else:
            self.old_log_e = np.minimum(self.old_log_e, self.old_e)
        for ch in range(2):
            self.old_e[ch, :start] = 0.0
            self.old_log_e[ch, :start] = -28.0
            self.old_log_e2[ch, :start] = -28.0
            self.old_e[ch, end:] = 0.0
            self.old_log_e[ch, end:] = -28.0
            self.old_log_e2[ch, end:] = -28.0
        self.rng = rd.rng & 0xFFFFFFFF
        self.loss_count = 0
        return pcm

    def decode_lost(self, frame_size: int) -> np.ndarray:
        """celt_decode_with_ec's data==NULL branch: conceal one lost
        frame (celt_plc.celt_decode_lost) then deemphasize.
        -> [CC, frame_size] float in [-1, 1]."""
        from audio_processor_tpu_torch.io.opusdec.celt_plc import \
            celt_decode_lost

        n = frame_size
        lm = {SHORT_MDCT_SIZE: 0, 2 * SHORT_MDCT_SIZE: 1,
              4 * SHORT_MDCT_SIZE: 2, 8 * SHORT_MDCT_SIZE: 3}[n]
        celt_decode_lost(self, n, lm)
        out_syn = [self.decode_mem[ch, DECODE_BUFFER_SIZE - n:]
                   for ch in range(self.cc)]
        return self._deemphasis(out_syn, n)

    # ----------------------------------------------------------------
    def _synthesis(self, x_full: np.ndarray, n: int, C: int,
                   is_transient: bool, lm: int, start: int,
                   eff_end: int, silence: bool) -> List[np.ndarray]:
        cc = self.cc
        m = 1 << lm
        if is_transient:
            b = m
            nb = SHORT_MDCT_SIZE
        else:
            b = 1
            nb = SHORT_MDCT_SIZE << lm
        out_syn = [self.decode_mem[ch, DECODE_BUFFER_SIZE - n:]
                   for ch in range(cc)]
        if cc == 2 and C == 1:
            freq = self._denormalise(x_full[0], start, eff_end, m,
                                     silence, 0)
            freqs = [freq, freq.copy()]
        elif cc == 1 and C == 2:
            f0 = self._denormalise(x_full[0], start, eff_end, m,
                                   silence, 0)
            f1 = self._denormalise(x_full[1], start, eff_end, m,
                                   silence, 1)
            freqs = [0.5 * (f0 + f1)]
        else:
            freqs = [self._denormalise(x_full[ch], start, eff_end, m,
                                       silence, ch)
                     for ch in range(cc)]
        for ch in range(cc):
            for blk in range(b):
                self._imdct_block(freqs[ch][blk::b],
                                  out_syn[ch][nb * blk:])
        sat = 300000000.0
        for ch in range(cc):
            np.clip(out_syn[ch][:n], -sat, sat, out=out_syn[ch][:n])
        return out_syn

    def _denormalise(self, x: np.ndarray, start: int, end: int,
                     m: int, silence: bool, ch: int) -> np.ndarray:
        n = m * SHORT_MDCT_SIZE
        freq = np.zeros(n)
        if silence:
            return freq
        for i in range(start, end):
            j0 = m * EBANDS[i]
            j1 = m * EBANDS[i + 1]
            lg = self.old_e[ch, i] + _E_MEANS[i]
            g = celt_exp2(min(32.0, lg))
            freq[j0:j1] = g * x[j0:j1]
        return freq

    def _imdct_block(self, bins: np.ndarray, out: np.ndarray) -> None:
        """clt_mdct_backward: raw IMDCT middle section + TDAC fold of
        the first `overlap` samples against the existing content."""
        n2 = len(bins)
        raw = _imdct_matrix(n2) @ bins
        half = OVERLAP // 2
        out[half:half + n2] = raw
        w = _WINDOW
        # TDAC fold, vectorized with the scalar loop's exact op order:
        # element i pairs with OVERLAP-1-i.
        wf = w[half:OVERLAP][::-1]            # w[OVERLAP-1-i]
        x1 = out[half:OVERLAP][::-1].copy()   # out[OVERLAP-1-i]
        x2 = out[:half].copy()
        out[:half] = wf * x2 - w[:half] * x1
        out[half:OVERLAP] = (w[:half] * x2 + wf * x1)[::-1]

    # ----------------------------------------------------------------
    def _apply_postfilter(self, out_syn: List[np.ndarray], n: int,
                          lm: int, pitch: int, gain: float,
                          tapset: int) -> None:
        self.postfilter_period = max(self.postfilter_period,
                                     COMBFILTER_MINPERIOD)
        self.postfilter_period_old = max(self.postfilter_period_old,
                                         COMBFILTER_MINPERIOD)
        base = DECODE_BUFFER_SIZE - n
        for ch in range(self.cc):
            # pass the full row: the filter reads up to 1026 samples of
            # history before `off` (negative view indices would wrap)
            _comb_filter(self.decode_mem[ch], base,
                         self.postfilter_period_old,
                         self.postfilter_period, SHORT_MDCT_SIZE,
                         self.postfilter_gain_old,
                         self.postfilter_gain,
                         self.postfilter_tapset_old,
                         self.postfilter_tapset)
            if lm != 0:
                _comb_filter(self.decode_mem[ch],
                             base + SHORT_MDCT_SIZE,
                             self.postfilter_period, pitch,
                             n - SHORT_MDCT_SIZE,
                             self.postfilter_gain, gain,
                             self.postfilter_tapset, tapset)
        self.postfilter_period_old = self.postfilter_period
        self.postfilter_gain_old = self.postfilter_gain
        self.postfilter_tapset_old = self.postfilter_tapset
        self.postfilter_period = pitch
        self.postfilter_gain = gain
        self.postfilter_tapset = tapset
        if lm != 0:
            self.postfilter_period_old = self.postfilter_period
            self.postfilter_gain_old = self.postfilter_gain
            self.postfilter_tapset_old = self.postfilter_tapset

    def _deemphasis(self, out_syn: List[np.ndarray],
                    n: int) -> np.ndarray:
        """1-pole de-emphasis: tmp[j] = x[j] + 1e-30 + c*tmp[j-1].
        scipy's direct-form lfilter runs the identical recurrence
        (b=[1], a=[1, -c]) in float64, so outputs are bit-identical to
        the scalar loop; the python loop is the no-scipy fallback."""
        pcm = np.empty((self.cc, n))
        coef0 = _PREEMPH_COEF
        for ch in range(self.cc):
            mem = self.preemph_mem[ch]
            x = out_syn[ch]
            if _lfilter is not None:
                tmp, _ = _lfilter([1.0], [1.0, -coef0], x[:n] + 1e-30,
                                  zi=np.array([mem]))
                pcm[ch] = tmp * (1.0 / 32768.0)
                mem = coef0 * tmp[-1] if n else mem
            else:
                y = pcm[ch]
                for j in range(n):
                    tmp = x[j] + 1e-30 + mem
                    mem = coef0 * tmp
                    y[j] = tmp * (1.0 / 32768.0)
            self.preemph_mem[ch] = mem
        return pcm


def _comb_filter(x: np.ndarray, off: int, t0: int, t1: int, n: int,
                 g0: float, g1: float, tapset0: int,
                 tapset1: int) -> None:
    """celt.c comb_filter, in place on x[off:off+n] (x has >= 1024+2
    samples of history before off).

    Vectorized in chunks of (lag - 2) samples: the filter feeds back
    on its own output, but the nearest tap is lag-2 >= 13 samples
    behind the write, so every read inside a chunk is already final.
    The per-element arithmetic keeps the scalar loop's exact operation
    order, so outputs are bit-identical to the original loop."""
    if g0 == 0.0 and g1 == 0.0:
        return
    t0 = max(t0, COMBFILTER_MINPERIOD)
    t1 = max(t1, COMBFILTER_MINPERIOD)
    g00 = g0 * _PF_GAINS[tapset0, 0]
    g01 = g0 * _PF_GAINS[tapset0, 1]
    g02 = g0 * _PF_GAINS[tapset0, 2]
    g10 = g1 * _PF_GAINS[tapset1, 0]
    g11 = g1 * _PF_GAINS[tapset1, 1]
    g12 = g1 * _PF_GAINS[tapset1, 2]
    overlap = OVERLAP
    if g0 == g1 and t0 == t1 and tapset0 == tapset1:
        overlap = 0

    def taps(base: int, t: int, m: int):
        lo = base - t
        return (x[lo:lo + m], x[lo + 1:lo + 1 + m], x[lo - 1:lo - 1 + m],
                x[lo + 2:lo + 2 + m], x[lo - 2:lo - 2 + m])

    # Blended region: old (t1) and new (t0) combs cross-faded by the
    # squared MDCT window.
    step = max(1, min(t0, t1) - 2)
    i = 0
    while i < overlap:
        m = min(step, overlap - i)
        base = off + i
        f = _WINDOW[i:i + m] * _WINDOW[i:i + m]
        a0, ap1, am1, ap2, am2 = taps(base, t0, m)
        b0, bp1, bm1, bp2, bm2 = taps(base, t1, m)
        x[base:base + m] = (x[base:base + m]
                            + (1 - f) * g00 * a0
                            + (1 - f) * g01 * (ap1 + am1)
                            + (1 - f) * g02 * (ap2 + am2)
                            + f * g10 * b0
                            + f * g11 * (bp1 + bm1)
                            + f * g12 * (bp2 + bm2))
        i += m
    if g1 == 0.0:
        return
    step = t1 - 2
    j = overlap
    while j < n:
        m = min(step, n - j)
        base = off + j
        b0, bp1, bm1, bp2, bm2 = taps(base, t1, m)
        x[base:base + m] = (x[base:base + m]
                            + g10 * b0
                            + g11 * (bp1 + bm1)
                            + g12 * (bp2 + bm2))
        j += m
