"""SILK fixed-point resampler, decoder direction only (8/12/16 kHz
internal -> 48 kHz API): 2x all-pass upsampler + fractional
interpolation FIR (reference resampler ROM coefficients in _tables).
Bit-exact with silk_resampler() for the upsampling path."""

from __future__ import annotations

from typing import List

import numpy as np

from audio_processor_tpu_torch.io.opusdec import _tables as T
from audio_processor_tpu_torch.io.opusdec.fixp import smulww, to_i16

ORDER_FIR_12 = 8
# delay_matrix_dec rows NB/MB/WB -> column for 48 kHz output
_INPUT_DELAY_48 = {8: 0, 12: 4, 16: 7}

# to_i16 at load so the inlined (Y*c)>>16 sees the same int16
# coefficient smulwb would have truncated to.
_HQ0 = [to_i16(int(v)) for v in T.SILK_UP2_HQ_0]
_HQ1 = [to_i16(int(v)) for v in T.SILK_UP2_HQ_1]
_FIR = [[int(v) for v in row] for row in T.SILK_RESAMPLER_FRAC_FIR_12]
# Row t of the full 8-tap kernel: FIR[t][0..3] ++ reversed(FIR[11-t]).
# Precomputed so the interpolation loop is one [n, 8] x [8] product.
_FIR_FULL = np.array(
    [_FIR[t] + _FIR[11 - t][::-1] for t in range(12)], np.int64)


def _up2_hq(S: List[int], x_in: List[int]) -> List[int]:
    """silk_resampler_private_up2_HQ: 2x upsample, Q10 state S[6].

    smlawb is inlined as (Y*c)>>16, which equals
    (Y>>16)*c + ((Y&0xFFFF)*c)>>16 for every int Y and int16 c
    ((h*2^16 + l)*c >> 16 splits exactly because h*c*2^16 is an
    exact multiple of the divisor) — this sample-serial allpass
    chain is the decoder's remaining scalar hot loop.
    """
    out = [0] * (2 * len(x_in))
    s0, s1, s2, s3, s4, s5 = S
    c00, c01, c02 = _HQ0
    c10, c11, c12 = _HQ1
    for k, v in enumerate(x_in):
        in32 = v << 10
        # even sample: three all-pass sections
        X = ((in32 - s0) * c00) >> 16
        out1 = s0 + X
        s0 = in32 + X
        X = ((out1 - s1) * c01) >> 16
        out2 = s1 + X
        s1 = out1 + X
        Y = out2 - s2
        X = Y + ((Y * c02) >> 16)
        out1 = s2 + X
        s2 = out2 + X
        o = (out1 >> 9) + 1 >> 1
        out[2 * k] = 32767 if o > 32767 else (-32768 if o < -32768
                                              else o)
        # odd sample
        X = ((in32 - s3) * c10) >> 16
        out1 = s3 + X
        s3 = in32 + X
        X = ((out1 - s4) * c11) >> 16
        out2 = s4 + X
        s4 = out1 + X
        Y = out2 - s5
        X = Y + ((Y * c12) >> 16)
        out1 = s5 + X
        s5 = out2 + X
        o = (out1 >> 9) + 1 >> 1
        out[2 * k + 1] = 32767 if o > 32767 else (-32768 if o < -32768
                                                  else o)
    S[:] = [s0, s1, s2, s3, s4, s5]
    return out


class SilkResampler:
    """State-carrying upsampler: process() consumes one SILK frame of
    int16 at fs_in kHz and emits 48 kHz int16."""

    def __init__(self, fs_in_khz: int):
        assert fs_in_khz in (8, 12, 16)
        self.fs_in_khz = fs_in_khz
        self.fs_out_khz = 48
        self.batch_size = fs_in_khz * 10
        self.input_delay = _INPUT_DELAY_48[fs_in_khz]
        self.delay_buf = [0] * 48   # >= Fs_in_kHz samples
        self.s_iir = [0] * 6
        self.s_fir = [0] * ORDER_FIR_12
        fs_in_hz = fs_in_khz * 1000
        inv = (((fs_in_hz << 15) // 48000) << 2)
        while smulww(inv, 48000) < (fs_in_hz << 1):
            inv += 1
        self.inv_ratio_q16 = inv

    def _iir_fir(self, x_in: List[int]) -> List[int]:
        out: List[int] = []
        buf = list(self.s_fir)
        pos = 0
        remaining = len(x_in)
        while True:
            n = min(remaining, self.batch_size)
            up = _up2_hq(self.s_iir, x_in[pos:pos + n])
            buf = buf[:ORDER_FIR_12] + up
            max_index_q16 = n << 17
            # Vectorized interpolation: for sample j, index_q16 =
            # j*inv_ratio_q16, table_index = smulwb(frac, 12) =
            # (frac*12)>>16, and the 8-tap dot is exact in int64
            # (int16 history x int16 taps, 8 terms). rshift_round for
            # shift 15 is ((res>>14)+1)>>1 with arithmetic shifts —
            # identical op for op to the scalar helpers.
            count = (max_index_q16 + self.inv_ratio_q16
                     - 1) // self.inv_ratio_q16
            if count:
                idx = np.arange(count, dtype=np.int64) \
                    * self.inv_ratio_q16
                ti = ((idx & 0xFFFF) * 12) >> 16
                base = (idx >> 16).astype(np.intp)
                buf_np = np.asarray(buf, np.int64)
                win = np.lib.stride_tricks.sliding_window_view(
                    buf_np, ORDER_FIR_12)[base]
                res = (win * _FIR_FULL[ti]).sum(axis=1)
                vals = np.clip(((res >> 14) + 1) >> 1, -32768, 32767)
                out.extend(vals.tolist())
            pos += n
            remaining -= n
            tail = buf[n << 1:(n << 1) + ORDER_FIR_12]
            if remaining > 0:
                buf = tail  # becomes the head of the next batch
            else:
                break
        self.s_fir = tail
        return out

    def process(self, x_in: List[int]) -> List[int]:
        """silk_resampler(): delay-compensated streaming resample."""
        n_first = self.fs_in_khz - self.input_delay
        head = self.delay_buf[:self.input_delay] + x_in[:n_first]
        out = self._iir_fir(head)
        out += self._iir_fir(x_in[n_first:len(x_in) - self.input_delay])
        self.delay_buf[:self.input_delay] = \
            x_in[len(x_in) - self.input_delay:] if self.input_delay \
            else []
        return out
