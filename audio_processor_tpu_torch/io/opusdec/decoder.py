"""Packet-level Opus decoder glue (RFC 6716 §4): TOC dispatch into
the SILK and CELT codec bodies, channel-count adaptation, and
mode-transition state resets.

The reference stack never decodes Opus itself (it shells audio out to
ffmpeg, services/audio_processor.py:76-86); io/opus.py prefers the
system libopus and falls back to this pure-Python decoder.  SILK-mode
output is bit-exact with libopus' int16 API (the SILK decoder is
fixed-point in every libopus build); CELT/hybrid output is held to a
small float tolerance by tests/test_opusdec.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from audio_processor_tpu_torch.io.opusdec.celt import END_BAND, CeltDecoder
from audio_processor_tpu_torch.io.opusdec.packet import (OpusPacketError,
                                                   PacketInfo,
                                                   SILK_KHZ,
                                                   parse_packet)
from audio_processor_tpu_torch.io.opusdec.rangedec import RangeDecoder
from audio_processor_tpu_torch.io.opusdec.silk import SilkDecoder


class OpusDecodeError(ValueError):
    pass


def pcm_soft_clip(x: np.ndarray, declip_mem: np.ndarray) -> None:
    """opus_pcm_soft_clip (opus.c): the waveshaper the int16 API
    applies in float builds when the decoded float exceeds +-1.
    In-place on [N, C]; declip_mem is the per-channel `a` state."""
    n, channels = x.shape
    if n < 1:
        return
    np.clip(x, -2.0, 2.0, out=x)
    for c in range(channels):
        xc = x[:, c]
        a = declip_mem[c]
        # continue the previous frame's non-linearity (no discontinuity)
        for i in range(n):
            if xc[i] * a >= 0:
                break
            xc[i] = xc[i] + a * xc[i] * xc[i]
        curr = 0
        x0 = xc[0]
        while True:
            i = curr
            while i < n and -1.0 <= xc[i] <= 1.0:
                i += 1
            if i == n:
                a = 0.0
                break
            peak_pos = i
            start = end = i
            maxval = abs(xc[i])
            while start > 0 and xc[i] * xc[start - 1] >= 0:
                start -= 1
            while end < n and xc[i] * xc[end] >= 0:
                if abs(xc[end]) > maxval:
                    maxval = abs(xc[end])
                    peak_pos = end
                end += 1
            special = start == 0 and xc[i] * xc[0] >= 0
            a = (maxval - 1) / (maxval * maxval)
            a += a * 2.4e-7
            if xc[i] > 0:
                a = -a
            for j in range(start, end):
                xc[j] = xc[j] + a * xc[j] * xc[j]
            if special and peak_pos >= 2:
                offset = x0 - xc[0]
                delta = offset / peak_pos
                for j in range(curr, peak_pos):
                    offset -= delta
                    xc[j] = max(-1.0, min(1.0, xc[j] + offset))
            curr = end
            if curr == n:
                break
        declip_mem[c] = a


class OpusDecoder:
    """Stateful decoder for one Opus stream at 48 kHz API rate.

    decode(packet) -> float32 [N, channels] in [-1, 1];
    decode_int16(packet) -> int16 [N, channels] (SILK-only streams are
    bit-exact with libopus' opus_decode()).
    """

    def __init__(self, channels: int):
        if channels not in (1, 2):
            raise OpusDecodeError(f"unsupported channel count {channels}")
        self.channels = channels
        self.silk = SilkDecoder()
        self.celt = CeltDecoder(channels)
        self.prev_mode: Optional[str] = None
        self.prev_bandwidth: Optional[str] = None
        self.prev_redundancy = False
        self.prev_frame_size = 960
        self._softclip_mem = np.zeros(channels)

    # ----------------------------------------------------------------
    def _decode_silk_frame(self, rd: RangeDecoder,
                           info: PacketInfo) -> np.ndarray:
        fs_khz = SILK_KHZ[info.bandwidth]
        n_internal = 2 if info.stereo else 1
        chans = self.silk.decode(rd, n_internal, fs_khz,
                                 int(info.frame_ms), self.channels)
        n = len(chans[0])
        out = np.zeros((n, self.channels), np.int16)
        if self.channels == 2 and n_internal == 1:
            out[:, 0] = np.asarray(chans[0], np.int16)
            # stereo_to_mono transitions return a right channel
            # continued through channel 1's resampler; otherwise
            # duplicate (dec_API.c)
            out[:, 1] = np.asarray(
                chans[1] if len(chans) > 1 else chans[0], np.int16)
        else:
            # mono API from stereo frames is mixed inside
            # SilkDecoder.decode; matched counts map 1:1
            for c in range(self.channels):
                out[:, c] = np.asarray(chans[c], np.int16)
        return out

    def _decode_celt_frame(self, rd: RangeDecoder, frame: bytes,
                           info: PacketInfo) -> np.ndarray:
        self.celt.start = 0
        self.celt.end = END_BAND[info.bandwidth]
        C = 2 if info.stereo else 1
        pcm = self.celt.decode(len(frame), rd, info.frame_size, C)
        return pcm.T  # [N, CC] float

    def _decode_redundant(self, tail: bytes, info: PacketInfo
                          ) -> np.ndarray:
        """Decode a 5 ms redundant CELT frame from the packet tail
        (own range decoder, start band 0)."""
        self.celt.start = 0
        self.celt.end = END_BAND[info.bandwidth]
        rrd = RangeDecoder(tail)
        C = 2 if info.stereo else 1
        return self.celt.decode(len(tail), rrd, 240, C).T

    @staticmethod
    def _smooth_fade(in1: np.ndarray, in2: np.ndarray) -> np.ndarray:
        """opus_decoder.c smooth_fade over 2.5 ms ([120, C])."""
        from audio_processor_tpu_torch.io.opusdec.celt import _WINDOW
        w = (_WINDOW * _WINDOW)[:, None]
        return w * in2 + (1.0 - w) * in1

    # ----------------------------------------------------------------
    def _decode_frame_float(self, frame: bytes,
                            info: PacketInfo) -> np.ndarray:
        """One frame, following opus_decode_frame's mode dispatch,
        redundancy splicing and CELT state rules
        (the original service has no decoder; this mirrors RFC 6716 §4.5).

        Not implemented: PLC/DTX (lost frames raise instead) and the
        PLC-based smoothing for redundancy-free mode transitions (the
        libopus encoder sends redundancy on transitions whenever the
        rate allows)."""
        rd = RangeDecoder(frame)
        mode = info.mode
        C = 2 if info.stereo else 1
        F2_5, F5 = 120, 240

        # Redundancy-free mode transitions are smoothed with 5 ms of
        # the OLD mode's PLC, crossfaded into the new frame
        # (opus_decode_frame's `transition` machinery). The silk->celt
        # direction must conceal BEFORE the new frame decodes (the
        # celt decode resets state); celt->silk/hybrid conceals after
        # the redundancy flags are known and is cancelled by them.
        transition = self.prev_mode is not None and (
            (mode == "celt" and self.prev_mode != "celt"
             and not self.prev_redundancy)
            or (mode != "celt" and self.prev_mode == "celt"))
        pcm_transition = None
        if transition and mode == "celt":
            pcm_transition = self._plc_samples(min(F5, info.frame_size))

        silk_out = None
        redundancy = 0
        celt_to_silk = 0
        red_bytes = 0
        data_len = len(frame)
        if mode != "celt":
            if self.prev_mode == "celt":
                self.silk = SilkDecoder()  # silk_InitDecoder on
                # CELT-only -> SILK/hybrid transitions
            silk_out = self._decode_silk_frame(rd, info) \
                .astype(np.float64) / 32768.0
            # leftover bytes carry a redundant CELT frame
            if rd.tell() + 17 + 20 * (mode == "hybrid") \
                    <= 8 * len(frame):
                redundancy = rd.dec_bit_logp(12) \
                    if mode == "hybrid" else 1
                if redundancy:
                    celt_to_silk = rd.dec_bit_logp(1)
                    if mode == "hybrid":
                        red_bytes = rd.dec_uint(256) + 2
                    else:
                        red_bytes = len(frame) \
                            - ((rd.tell() + 7) >> 3)
                    data_len -= red_bytes
                    if data_len * 8 < rd.tell():
                        data_len = 0
                        red_bytes = 0
                        redundancy = 0
                    else:
                        # keep the raw-bit reader off the tail
                        rd.storage -= red_bytes

        if redundancy:
            # the redundant CELT frame does the transition smoothing
            transition = False
        if transition and mode != "celt":
            # celt -> silk/hybrid without redundancy: conceal 5 ms of
            # the old CELT before this frame's celt ops reset/evolve it
            pcm_transition = self._plc_samples(min(F5, info.frame_size))

        red_audio = None
        if redundancy and celt_to_silk:
            # CELT -> SILK/hybrid: redundant frame continues the old
            # CELT state (no reset here — opus_decode_frame leaves the
            # post-redundant state for the hybrid->silk silence fade;
            # the main-decode rule below resets when appropriate)
            red_audio = self._decode_redundant(frame[data_len:], info)

        if mode != "silk":
            if mode != self.prev_mode and self.prev_mode is not None \
                    and not self.prev_redundancy:
                self.celt.reset()
            if mode == "celt":
                out = self._decode_celt_frame(rd, frame, info)
            else:
                self.celt.start = 17
                self.celt.end = END_BAND[info.bandwidth]
                celt_out = self.celt.decode(data_len, rd,
                                            info.frame_size, C).T
                out = silk_out + celt_out
        else:
            out = silk_out
            if self.prev_mode == "hybrid" and not (
                    redundancy and celt_to_silk
                    and self.prev_redundancy):
                # fade out the CELT MDCT tail with a silence frame
                self.celt.start = 0
                self.celt.end = END_BAND[info.bandwidth]
                srd = RangeDecoder(b"\xff\xff")
                fade = self.celt.decode(2, srd, F2_5, C).T
                out = out.copy()
                out[:F2_5] += fade

        if redundancy and not celt_to_silk:
            # SILK -> CELT: redundant frame from a reset CELT state,
            # crossfaded over the main output's last 2.5 ms
            self.celt.reset()
            red_audio = self._decode_redundant(frame[data_len:], info)
            out = out.copy()
            out[-F2_5:] = self._smooth_fade(out[-F2_5:],
                                            red_audio[F2_5:2 * F2_5])
        if redundancy and celt_to_silk:
            out = out.copy()
            out[:F2_5] = red_audio[:F2_5]
            out[F2_5:2 * F2_5] = self._smooth_fade(
                red_audio[F2_5:2 * F2_5], out[F2_5:2 * F2_5])

        if transition:
            out = out.copy()
            if info.frame_size >= F5:
                out[:F2_5] = pcm_transition[:F2_5]
                out[F2_5:2 * F2_5] = self._smooth_fade(
                    pcm_transition[F2_5:2 * F2_5], out[F2_5:2 * F2_5])
            else:
                # 2.5 ms frame: "not enough time for a clean
                # transition, but we do it anyway"
                out[:F2_5] = self._smooth_fade(pcm_transition[:F2_5],
                                               out[:F2_5])

        if rd.error:
            raise OpusDecodeError("range decoder error")
        self.prev_mode = mode
        self.prev_bandwidth = info.bandwidth
        self.prev_redundancy = bool(redundancy and not celt_to_silk)
        self.prev_frame_size = info.frame_size
        return out

    def _conceal_chunk(self, n: int) -> np.ndarray:
        """Conceal one <=20 ms chunk using the PREVIOUS frame's mode
        (opus_decode_frame's data==NULL body): SILK PLC/CNG
        (silk_plc.py, bit-exact) for silk/hybrid, CELT PLC
        (celt_plc.py: pitch-extrapolation or noise fill) for celt and
        the hybrid high bands."""
        mode = self.prev_mode
        bandwidth = self.prev_bandwidth
        out = np.zeros((n, self.channels))
        if mode in ("silk", "hybrid"):
            # "The SILK PLC cannot produce frames of less than 10 ms"
            # (opus_decoder.c): payloadSize_ms = max(10, chunk ms), so
            # a 5 ms transition chunk conceals one 10 ms SILK frame
            # and keeps the first n samples.
            payload_ms = max(10, n * 1000 // 48000)
            chans = self.silk.conceal(max(n, 480), self.channels,
                                      payload_ms=payload_ms)
            for c in range(self.channels):
                col = chans[c if c < len(chans) else 0]
                out[:, c] = np.asarray(col[:n], np.float64) / 32768.0
        if mode == "silk":
            return out
        self.celt.start = 0 if mode == "celt" else 17
        self.celt.end = END_BAND[bandwidth]
        if self.celt.end <= self.celt.start:
            # hybrid conceal with a corrupt NB/MB history: no CELT part
            return out
        out += self.celt.decode_lost(n).T
        return out

    def _plc_samples(self, n_total: int) -> np.ndarray:
        """PLC for ``n_total`` samples, chunked like opus_decode_frame
        (<=F20 pieces; sub-F20 sizes clamp to F10/F5 and iterate)."""
        out = np.zeros((n_total, self.channels))
        pos = 0
        while pos < n_total:
            size = min(n_total - pos, 960)
            if size < 960:
                if size > 480:
                    size = 480
                elif self.prev_mode != "silk" and 240 < size < 480:
                    size = 240
            out[pos:pos + size] = self._conceal_chunk(size)
            pos += size
        return out

    def _conceal_frame(self, info: PacketInfo) -> np.ndarray:
        """Lost / DTX / zero-length frame (opus_decode_native's
        data==NULL path): full PLC in the previous frame's mode.
        Before any packet has decoded, libopus returns zeros."""
        if self.prev_mode is None:
            return np.zeros((info.frame_size, self.channels))
        return self._plc_samples(info.frame_size)

    def decode_info_float(self, info: PacketInfo) -> np.ndarray:
        """Decode an already-parsed packet (multistream sub-packets
        arrive via self-delimited framing and can't be re-parsed).
        _decode_frame_float maintains prev_mode/prev_redundancy;
        concealed frames keep prev_mode and clear prev_redundancy
        (opus_decode_frame's PLC path decodes no redundancy)."""
        outs = []
        for f in info.frames:
            if f:
                outs.append(self._decode_frame_float(f, info))
            else:
                outs.append(self._conceal_frame(info))
                self.prev_redundancy = False
        return np.concatenate(outs, axis=0)

    def decode_float(self, packet: bytes) -> np.ndarray:
        """Decode one packet -> float64 [N, channels] at 48 kHz."""
        return self.decode_info_float(parse_packet(packet))

    def decode_lost_float(self, frame_size: int = None) -> np.ndarray:
        """opus_decode(dec, NULL, 0, pcm, frame_size, 0): conceal one
        LOST packet. Concealment is capped at the last real packet's
        duration ("don't conceal more than what the ToC says") and
        runs the full PLC in the previous mode; zeros before any
        packet has decoded."""
        n = self.prev_frame_size if frame_size is None \
            else min(frame_size, self.prev_frame_size)
        if self.prev_mode is None:
            return np.zeros((n, self.channels))
        out = self._plc_samples(n)
        self.prev_redundancy = False
        return out

    def decode_lost_int16(self, frame_size: int = None) -> np.ndarray:
        """Lost-packet concealment with opus_decode()'s int16-API
        semantics (soft clip + FLOAT2INT16)."""
        pcm = self.decode_lost_float(frame_size)
        pcm_soft_clip(pcm, self._softclip_mem)
        pcm = pcm * 32768.0
        return np.rint(np.clip(pcm, -32768.0, 32767.0)).astype(np.int16)

    def decode_int16(self, packet: bytes) -> np.ndarray:
        """Decode one packet -> int16 [N, channels] at 48 kHz
        (libopus opus_decode() semantics: FLOAT2INT16 with
        round-half-even; bit-exact for SILK-only streams)."""
        pcm = self.decode_float(packet)
        pcm_soft_clip(pcm, self._softclip_mem)
        pcm *= 32768.0
        return np.rint(np.clip(pcm, -32768.0, 32767.0)).astype(np.int16)

    def decode(self, packet: bytes) -> np.ndarray:
        """Decode one packet -> float32 [N, channels] in [-1, 1]."""
        return self.decode_float(packet).astype(np.float32)


class OpusMSDecoder:
    """opus_multistream_decoder equivalent: N elementary streams in
    one packet (all but the last in RFC 6716 Appendix-B self-delimited
    framing), mapped to output channels per RFC 7845 §5.1.1."""

    def __init__(self, channels: int, stream_count: int,
                 coupled_count: int, mapping) -> None:
        if stream_count < 1 or coupled_count > stream_count:
            raise OpusDecodeError("invalid stream/coupled counts")
        self.channels = channels
        self.coupled_count = coupled_count
        self.mapping = list(mapping)
        nout = 2 * coupled_count + (stream_count - coupled_count)
        if any(m != 255 and m >= nout for m in self.mapping):
            raise OpusDecodeError("channel mapping index out of range")
        self.streams = [OpusDecoder(2 if i < coupled_count else 1)
                        for i in range(stream_count)]
        self._softclip_mem = [np.zeros(d.channels)
                              for d in self.streams]

    def _decode_streams(self, packet: bytes):
        pos = 0
        outs = []
        for i, dec in enumerate(self.streams):
            last = i == len(self.streams) - 1
            info = parse_packet(packet[pos:], self_delimited=not last)
            outs.append(dec.decode_info_float(info))
            pos += info.size
        n = len(outs[0])
        if any(len(o) != n for o in outs):
            raise OpusDecodeError("stream duration mismatch")
        return outs

    def _map(self, outs) -> np.ndarray:
        n = len(outs[0])
        pcm = np.zeros((n, self.channels))
        for c, m in enumerate(self.mapping):
            if m == 255:
                continue
            if m < 2 * self.coupled_count:
                pcm[:, c] = outs[m >> 1][:, m & 1]
            else:
                pcm[:, c] = outs[self.coupled_count
                                 + (m - 2 * self.coupled_count)][:, 0]
        return pcm

    def decode_float(self, packet: bytes) -> np.ndarray:
        """-> float64 [N, channels]; no soft clip (float API)."""
        return self._map(self._decode_streams(packet))

    def decode(self, packet: bytes) -> np.ndarray:
        return self.decode_float(packet).astype(np.float32)

    def decode_int16(self, packet: bytes) -> np.ndarray:
        """int16 API semantics: soft clip applied per elementary
        stream (opus_multistream_decode passes soft_clip=1)."""
        outs = self._decode_streams(packet)
        for o, mem in zip(outs, self._softclip_mem):
            pcm_soft_clip(o, mem)
        pcm = self._map(outs) * 32768.0
        return np.rint(np.clip(pcm, -32768.0, 32767.0)).astype(np.int16)
