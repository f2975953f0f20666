"""CELT packet-loss concealment (libopus 1.3.1 celt_decoder.c
celt_decode_lost + celt/pitch.c helpers, float-build semantics).

Two regimes, selected exactly like libopus:

- **Pitch-based PLC** (full-band CELT, fewer than 5 consecutive
  losses, at least two good frames since the last loss): find the
  pitch period over the decode history, extrapolate the LPC
  excitation period-by-period with energy decay, re-synthesize with
  the LPC filter, guard against energy explosions, and simulate TDAC
  on the overlap so the next real frame's MDCT blends in.
- **Noise-based PLC** (hybrid mode's start!=0, long loss runs, or
  skip_plc): fill each band with renormalised LCG noise at the last
  energies decayed toward the tracked background noise floor, then
  run the normal MDCT synthesis.

The reference pipeline inherits this concealment via ffmpeg/libopus
(the original service's services/audio_processor.py:76-86).  Differential
validation: tools/fuzz_opus_plc_vs_libopus.py (random drop masks over
CELT/hybrid/SILK streams) and tests/test_opusdec.py.

All math is float64 against libopus' float32; concealment output is
held to a fuzz-measured tolerance, not bit-exactness (the entropy
layer is unaffected: concealment consumes no bits).

``_PITCH_DTYPE`` selects the precision of the pitch search only
(tools/probe_celt_plc_drift.py flips it to float32 to quantify how
much of the dense-loss drift budget is near-tied-lag selection noise
vs genuine accumulation — see PARITY.md §2.3).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

LPC_ORDER = 24
# Pitch-search precision knob (float64 default; see module docstring).
_PITCH_DTYPE = np.float64
MAX_PERIOD = 1024
PLC_PITCH_LAG_MAX = 720
PLC_PITCH_LAG_MIN = 100
DECODE_BUFFER_SIZE = 2048
OVERLAP = 120
NB_BANDS = 21

try:
    from scipy.signal import lfilter as _lfilter
    from scipy.signal import lfiltic as _lfiltic
except Exception:                      # pragma: no cover
    _lfilter = _lfiltic = None


def _fir(b: np.ndarray, x: np.ndarray) -> np.ndarray:
    """y[i] = sum_j b[j] x[i-j], zero history before x[0]."""
    if _lfilter is not None:
        return _lfilter(b, [1.0], x)
    y = np.zeros_like(x)
    for j, bj in enumerate(b):
        if bj != 0.0:
            y[j:] += bj * x[:x.shape[0] - j]
    return y


def _iir(lpc: np.ndarray, x: np.ndarray,
         y_hist: np.ndarray) -> np.ndarray:
    """celt_iir: y[i] = x[i] - sum_j lpc[j] y[i-1-j]; y_hist =
    [y[-1], y[-2], ...]."""
    a = np.concatenate(([1.0], lpc))
    if _lfilter is not None and _lfiltic is not None:
        zi = _lfiltic([1.0], a, y_hist)
        out, _ = _lfilter([1.0], a, x, zi=zi)
        return out
    ord_ = lpc.shape[0]
    hist = list(y_hist[:ord_])
    out = np.empty_like(x)
    for i in range(x.shape[0]):
        s = x[i]
        for j in range(ord_):
            s -= lpc[j] * hist[j]
        out[i] = s
        hist = [s] + hist[:-1]
    return out


# ----------------------------------------------------------------------
# celt/pitch.c (float build)
# ----------------------------------------------------------------------

def _celt_autocorr(x: np.ndarray, lag: int, window: np.ndarray = None,
                   overlap: int = 0) -> np.ndarray:
    """_celt_autocorr (celt_lpc.c): ac[k] = sum_i x[i] x[i+k], with an
    optional MDCT half-window applied to both ends first."""
    if overlap:
        x = x.copy()
        x[:overlap] *= window[:overlap]
        x[-overlap:] *= window[:overlap][::-1]
    n = x.shape[0]
    ac = np.empty(lag + 1)
    for k in range(lag + 1):
        ac[k] = np.dot(x[:n - k], x[k:])
    return ac


def _celt_lpc(ac: np.ndarray, p: int) -> np.ndarray:
    """_celt_lpc (celt_lpc.c): Levinson-Durbin, float semantics
    (early exit once prediction error falls below .001*ac[0])."""
    lpc = np.zeros(p)
    error = ac[0]
    if ac[0] == 0.0:
        return lpc
    for i in range(p):
        rr = 0.0
        for j in range(i):
            rr += lpc[j] * ac[i - j]
        rr += ac[i + 1]
        r = -rr / error
        lpc[i] = r
        for j in range((i + 1) >> 1):
            tmp1, tmp2 = lpc[j], lpc[i - 1 - j]
            lpc[j] = tmp1 + r * tmp2
            lpc[i - 1 - j] = tmp2 + r * tmp1
        error = error - r * r * error
        if error < 0.001 * ac[0]:
            break
    return lpc


def _celt_fir5(x: np.ndarray, num: np.ndarray) -> np.ndarray:
    """celt_fir5: 5-tap FIR on the pre-filter input (zero history)."""
    return _fir(np.concatenate(([1.0], num)), x)


def _pitch_downsample(decode_mem: List[np.ndarray]) -> np.ndarray:
    """pitch_downsample (pitch.c): 2x decimate + LPC-whiten-ish
    filtering of the decode history; channels are summed."""
    n = DECODE_BUFFER_SIZE
    half = n >> 1
    x_lp = np.zeros(half)
    for x in decode_mem:
        x = x[:n]
        lp = np.empty(half)
        lp[1:] = 0.5 * (0.5 * (x[1:n - 2:2] + x[3:n:2]) + x[2:n - 1:2])
        lp[0] = 0.5 * (0.5 * x[1] + x[0])
        x_lp += lp

    ac = _celt_autocorr(x_lp, 4)
    ac[0] *= 1.0001
    for i in range(1, 5):
        ac[i] -= ac[i] * (0.008 * i) * (0.008 * i)
    lpc = _celt_lpc(ac, 4)
    tmp = 1.0
    for i in range(4):
        tmp = 0.9 * tmp
        lpc[i] = lpc[i] * tmp
    c1 = 0.8
    lpc2 = np.array([lpc[0] + c1,
                     lpc[1] + c1 * lpc[0],
                     lpc[2] + c1 * lpc[1],
                     lpc[3] + c1 * lpc[2],
                     c1 * lpc[3]])
    return _celt_fir5(x_lp, lpc2)


def _find_best_pitch(xcorr: np.ndarray, y: np.ndarray, length: int,
                     max_pitch: int) -> List[int]:
    """find_best_pitch (pitch.c, float): normalized-correlation argmax
    with a running Syy update; returns the two best lags."""
    Syy = 1.0 + np.dot(y[:length], y[:length])
    best_num = [-1.0, -1.0]
    best_den = [0.0, 0.0]
    best_pitch = [0, 1]
    for i in range(max_pitch):
        if xcorr[i] > 0:
            xcorr16 = xcorr[i] * 1e-12  # avoid overflow when squaring
            num = xcorr16 * xcorr16
            if num * best_den[1] > best_num[1] * Syy:
                if num * best_den[0] > best_num[0] * Syy:
                    best_num[1] = best_num[0]
                    best_den[1] = best_den[0]
                    best_pitch[1] = best_pitch[0]
                    best_num[0] = num
                    best_den[0] = Syy
                    best_pitch[0] = i
                else:
                    best_num[1] = num
                    best_den[1] = Syy
                    best_pitch[1] = i
        Syy += y[i + length] * y[i + length] - y[i] * y[i]
        Syy = max(1.0, Syy)
    return best_pitch


def _pitch_search(x_lp: np.ndarray, y: np.ndarray, length: int,
                  max_pitch: int) -> int:
    """pitch_search (pitch.c): coarse 4x-decimated search, fine
    2x-decimated re-scoring around the two candidates, then
    pseudo-interpolation.  Returns the lag in full-rate samples."""
    len4 = length >> 2
    lag4 = (length + max_pitch) >> 2
    x_lp4 = x_lp[0:2 * len4:2]
    y_lp4 = y[0:2 * lag4:2]

    # Coarse: xcorr[i] = <x_lp4, y_lp4[i:]> for i < max_pitch>>2
    max4 = max_pitch >> 2
    xcorr4 = np.array([np.dot(x_lp4, y_lp4[i:i + len4])
                       for i in range(max4)])
    best4 = _find_best_pitch(xcorr4, y_lp4, len4, max4)

    # Fine: re-score at 2x decimation near the coarse candidates.
    max2 = max_pitch >> 1
    xcorr = np.zeros(max2)
    for i in range(max2):
        if abs(i - 2 * best4[0]) > 2 and abs(i - 2 * best4[1]) > 2:
            continue
        xcorr[i] = max(-1.0, np.dot(x_lp[:length >> 1],
                                    y[i:i + (length >> 1)]))
    best = _find_best_pitch(xcorr, y, length >> 1, max2)

    # Pseudo-interpolation.
    offset = 0
    if 0 < best[0] < max2 - 1:
        a, b, c = xcorr[best[0] - 1], xcorr[best[0]], xcorr[best[0] + 1]
        if (c - a) > 0.7 * (b - a):
            offset = 1
        elif (a - c) > 0.7 * (b - c):
            offset = -1
    return 2 * best[0] - offset


def plc_pitch_search(decode_mem: List[np.ndarray]) -> int:
    """celt_plc_pitch_search: pitch period (in samples) of the decode
    history, in [PLC_PITCH_LAG_MIN, PLC_PITCH_LAG_MAX]."""
    lp = _pitch_downsample(decode_mem).astype(_PITCH_DTYPE)
    pitch = _pitch_search(lp[PLC_PITCH_LAG_MAX >> 1:], lp,
                          DECODE_BUFFER_SIZE - PLC_PITCH_LAG_MAX,
                          PLC_PITCH_LAG_MAX - PLC_PITCH_LAG_MIN)
    return PLC_PITCH_LAG_MAX - pitch


# ----------------------------------------------------------------------
# celt_decode_lost
# ----------------------------------------------------------------------

def _lcg(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def celt_decode_lost(st, n: int, lm: int) -> None:
    """celt_decode_lost (celt_decoder.c): conceal one lost frame of
    ``n`` samples into st.decode_mem (signal domain, pre-deemphasis).
    The caller runs deemphasis afterwards, exactly like
    celt_decode_with_ec's data==NULL branch."""
    from audio_processor_tpu_torch.io.opusdec.celt import _WINDOW
    from audio_processor_tpu_torch.io.opusdec.celt_rate import EBANDS

    cc = st.cc
    loss_count = st.loss_count
    start = st.start
    noise_based = loss_count >= 5 or start != 0 or st.skip_plc

    if noise_based:
        end = st.end
        eff_end = max(start, min(end, NB_BANDS))
        decay = 1.5 if loss_count == 0 else 0.5
        for c in range(cc):
            st.old_e[c, start:end] = np.maximum(
                st.background_log_e[c, start:end],
                st.old_e[c, start:end] - decay)
        seed = st.rng
        x_full = np.zeros((cc, n))
        for c in range(cc):
            for i in range(start, eff_end):
                j0 = EBANDS[i] << lm
                blen = (EBANDS[i + 1] - EBANDS[i]) << lm
                band = np.empty(blen)
                for j in range(blen):
                    seed = _lcg(seed)
                    # (opus_int32)seed >> 20: arithmetic shift
                    band[j] = float(np.int32(np.uint32(seed)) >> 20)
                # renormalise_vector to unit norm
                e = 1e-15 + np.dot(band, band)
                x_full[c, j0:j0 + blen] = band / math.sqrt(e)
        st.rng = seed

        for c in range(cc):
            st.decode_mem[c, :DECODE_BUFFER_SIZE - n + OVERLAP // 2] = \
                st.decode_mem[c, n:DECODE_BUFFER_SIZE + OVERLAP // 2]
        st._synthesis(x_full, n, cc, False, lm, start, eff_end, False)
    else:
        if loss_count == 0:
            st.last_pitch_index = pitch_index = plc_pitch_search(
                [st.decode_mem[c] for c in range(cc)])
            fade = 1.0
        else:
            pitch_index = st.last_pitch_index
            fade = 0.8

        exc_length = min(2 * pitch_index, MAX_PERIOD)
        extrapolation_offset = MAX_PERIOD - pitch_index
        extrapolation_len = n + OVERLAP

        for c in range(cc):
            buf = st.decode_mem[c]
            # exc with LPC_ORDER samples of history in front
            exc_full = buf[DECODE_BUFFER_SIZE - MAX_PERIOD - LPC_ORDER:
                           DECODE_BUFFER_SIZE].copy()
            exc = exc_full[LPC_ORDER:]

            if loss_count == 0:
                ac = _celt_autocorr(exc, LPC_ORDER, _WINDOW, OVERLAP)
                ac[0] *= 1.0001  # -40 dB noise floor
                for i in range(1, LPC_ORDER + 1):  # lag windowing
                    ac[i] -= ac[i] * (0.008 * 0.008) * i * i
                st.plc_lpc[c] = _celt_lpc(ac, LPC_ORDER)
            lpc = st.plc_lpc[c]

            # celt_fir: excitation of the last exc_length samples
            # (exc_full[lo:] carries the LPC_ORDER history in front)
            b = np.concatenate(([1.0], lpc))
            lo = MAX_PERIOD - exc_length
            exc[lo:] = _fir(b, exc_full[lo:])[LPC_ORDER:]

            # Decay estimate from the two halves of the excitation.
            decay_length = exc_length >> 1
            e1 = 1.0 + np.dot(exc[MAX_PERIOD - decay_length:],
                              exc[MAX_PERIOD - decay_length:])
            e2 = 1.0 + np.dot(
                exc[MAX_PERIOD - 2 * decay_length:
                    MAX_PERIOD - decay_length],
                exc[MAX_PERIOD - 2 * decay_length:
                    MAX_PERIOD - decay_length])
            e1 = min(e1, e2)
            decay = math.sqrt(e1 / e2)

            # Shift left by n (WITHOUT the overlap tail — decode_lost
            # overwrites it below).
            buf[:DECODE_BUFFER_SIZE - n] = buf[n:DECODE_BUFFER_SIZE]

            # Extrapolate excitation period by period with decay.
            i_idx = np.arange(extrapolation_len)
            j_idx = i_idx % pitch_index
            att = fade * decay ** (1.0 + i_idx // pitch_index)
            region = slice(DECODE_BUFFER_SIZE - n,
                           DECODE_BUFFER_SIZE - n + extrapolation_len)
            buf[region] = att * exc[extrapolation_offset + j_idx]
            # Energy of the signal whose excitation we're copying.
            src = buf[DECODE_BUFFER_SIZE - MAX_PERIOD - n
                      + extrapolation_offset + j_idx]
            s1 = float(np.dot(src, src))

            # LPC synthesis back to the signal domain.
            lpc_mem = buf[DECODE_BUFFER_SIZE - n - LPC_ORDER:
                          DECODE_BUFFER_SIZE - n][::-1].copy()
            buf[region] = _iir(lpc, buf[region], lpc_mem)

            syn = buf[region]
            s2 = float(np.dot(syn, syn))
            # Explosion check (also catches NaNs, like the C test).
            if not (s1 > 0.2 * s2):
                buf[region] = 0.0
            elif s1 < s2:
                ratio = math.sqrt((s1 + 1.0) / (s2 + 1.0))
                g = 1.0 - _WINDOW * (1.0 - ratio)
                buf[region.start:region.start + OVERLAP] *= g
                buf[region.start + OVERLAP:region.stop] *= ratio

            # Pre-filter the overlap with the NEGATED postfilter so the
            # next frame's postfilter pass doesn't double-apply, then
            # simulate TDAC on the first half of the overlap.
            etmp = buf[DECODE_BUFFER_SIZE:
                       DECODE_BUFFER_SIZE + OVERLAP].copy()
            if st.postfilter_gain != 0.0:
                _comb_filter_const_out(
                    etmp, buf, DECODE_BUFFER_SIZE,
                    max(st.postfilter_period, 15),
                    -st.postfilter_gain, st.postfilter_tapset)
            half = OVERLAP // 2
            w = _WINDOW
            buf[DECODE_BUFFER_SIZE:DECODE_BUFFER_SIZE + half] = (
                w[:half] * etmp[OVERLAP - 1:half - 1:-1]
                + w[OVERLAP - 1:half - 1:-1] * etmp[:half])

    st.loss_count = loss_count + 1


def _comb_filter_const_out(y: np.ndarray, x: np.ndarray, off: int,
                           t: int, g: float, tapset: int) -> None:
    """comb_filter with x != y, t0==t1, g0==g1 (the celt_decode_lost
    call): y[i] = x[off+i] + g*(taps at lag t), reading UNfiltered x
    (no feedback because the output buffer is separate)."""
    from audio_processor_tpu_torch.io.opusdec.celt import _PF_GAINS

    n = y.shape[0]
    g0 = g * _PF_GAINS[tapset, 0]
    g1 = g * _PF_GAINS[tapset, 1]
    g2 = g * _PF_GAINS[tapset, 2]
    lo = off - t
    y[:] = (x[off:off + n]
            + g0 * x[lo:lo + n]
            + g1 * (x[lo + 1:lo + 1 + n] + x[lo - 1:lo - 1 + n])
            + g2 * (x[lo + 2:lo + 2 + n] + x[lo - 2:lo - 2 + n]))
