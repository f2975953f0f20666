"""First-party WAV reader/writer/prober (pure-Python reference path).

Replaces the reference's torchaudio.load / torchaudio.info native
dependency (services/audio_processor.py:86-91, services/pipeline.py:92).
A C++ fast path with the same API lives in io/native.py; this module is
the always-available fallback and the behavioral specification.

Supports RIFF/WAVE with PCM 8/16/24/32-bit integer and 32/64-bit float
samples, including the WAVE_FORMAT_EXTENSIBLE wrapper.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_IMA_ADPCM = 0x0011
WAVE_FORMAT_MS_ADPCM = 0x0002
WAVE_FORMAT_GSM610 = 0x0031
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

# MS ADPCM canonical tables (WAVE_FORMAT_ADPCM, MSDN mmreg spec; the
# first 7 coefficient pairs are mandated by the format and files may
# append extras in the fmt extension — we honor the file's table).
_MS_ADAPT = np.array([230, 230, 230, 230, 307, 409, 512, 614,
                      768, 614, 512, 409, 307, 230, 230, 230],
                     np.int64)
_MS_COEFS = ((256, 0), (512, -256), (0, 0), (192, 64), (240, 0),
             (460, -208), (392, -232))

# IMA/DVI ADPCM tables (IMA ADPCM reference; audioop and sox use the
# same bit-test expansion, parity-tested against audioop).
_IMA_STEPS = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34,
    37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143,
    157, 173, 190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494,
    544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552,
    1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428,
    4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487,
    12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623, 27086,
    29794, 32767], np.int32)
_IMA_INDEX_ADJ = np.array(
    [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], np.int32)


def _g711_tables() -> Tuple[np.ndarray, np.ndarray]:
    """256-entry int16 expansion LUTs for ITU-T G.711 (the telephony
    companding used by call recorders; torchaudio/sox decode these
    WAVs via the same tables — parity-tested against audioop)."""
    codes = np.arange(256, dtype=np.int32)
    # mu-law (Sun/CCITT reference decoder)
    u = (~codes) & 0xFF
    t = (((u & 0x0F) << 3) + 0x84) << ((u & 0x70) >> 4)
    ulaw = np.where(u & 0x80, 0x84 - t, t - 0x84).astype(np.int16)
    # A-law
    a = codes ^ 0x55
    seg = (a & 0x70) >> 4
    t = (a & 0x0F) << 4
    t = np.where(seg == 0, t + 8,
                 (t + 0x108) << np.maximum(seg - 1, 0))
    alaw = np.where(a & 0x80, t, -t).astype(np.int16)
    return alaw, ulaw


_ALAW_TABLE, _ULAW_TABLE = _g711_tables()


@dataclass(frozen=True)
class AudioInfo:
    sample_rate: int
    num_frames: int
    num_channels: int
    bits_per_sample: int
    encoding: str  # pcm_int|pcm_float|pcm_alaw|pcm_ulaw|adpcm_ima|adpcm_ms
    block_align: int = 0  # container block size (ADPCM framing)
    samples_per_block: int = 0   # MS ADPCM fmt-declared block frames
    coefs: Optional[tuple] = None  # MS ADPCM (coef1, coef2) pairs


class WavError(ValueError):
    pass


def _iter_chunks(data: bytes):
    """Yield (chunk_id, offset, size) for top-level RIFF chunks."""
    pos = 12
    n = len(data)
    while pos + 8 <= n:
        cid = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def _parse_header(data: bytes,
                  file_size: Optional[int] = None) -> Tuple[AudioInfo, int, int]:
    """Returns (info, data_offset, data_size).

    ``file_size`` bounds the declared data size when only a header
    prefix was read (info/probe path)."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    fmt = None
    fmt_ext = b""
    data_off = data_size = None
    fact_frames = None
    for cid, off, size in _iter_chunks(data):
        if cid == b"fmt " and size >= 16:
            (audio_format, num_channels, sample_rate, _byte_rate,
             block_align, bits) = struct.unpack_from("<HHIIHH", data, off)
            was_extensible = audio_format == WAVE_FORMAT_EXTENSIBLE
            if was_extensible and size >= 40:
                # sub-format GUID: first 2 bytes are the real format tag
                (audio_format,) = struct.unpack_from("<H", data, off + 24)
            fmt = (audio_format, num_channels, sample_rate, block_align, bits)
            # cbSize + codec extension (wSamplesPerBlock, coef pairs).
            # An EXTENSIBLE wrapper replaces that layout with
            # wValidBitsPerSample/dwChannelMask/GUID — parsing it as a
            # codec extension would misread those fields, so the
            # ADPCM/GSM branches fall back to derived defaults there.
            fmt_ext = b"" if was_extensible \
                else bytes(data[off + 16:off + size])
        elif cid == b"fact" and size >= 4:
            # dwSampleLength: per-channel frame count (compressed fmts)
            (fact_frames,) = struct.unpack_from("<I", data, off)
        elif cid == b"data":
            bound = (file_size if file_size is not None else len(data)) - off
            data_off, data_size = off, min(size, max(0, bound))
        if fmt is not None and data_off is not None:
            break
    if fmt is None:
        raise WavError("missing fmt chunk")
    if data_off is None:
        raise WavError("missing data chunk")
    audio_format, num_channels, sample_rate, block_align, bits = fmt
    if num_channels <= 0 or sample_rate <= 0:
        raise WavError("invalid fmt fields")
    if audio_format == WAVE_FORMAT_PCM:
        if bits not in (8, 16, 24, 32):
            raise WavError(f"unsupported PCM bit depth {bits}")
        enc = "pcm_int"
    elif audio_format == WAVE_FORMAT_IEEE_FLOAT:
        if bits not in (32, 64):
            raise WavError(f"unsupported float bit depth {bits}")
        enc = "pcm_float"
    elif audio_format in (WAVE_FORMAT_ALAW, WAVE_FORMAT_MULAW):
        if bits != 8:
            raise WavError(f"G.711 WAV must be 8-bit, got {bits}")
        enc = "pcm_alaw" if audio_format == WAVE_FORMAT_ALAW \
            else "pcm_ulaw"
    elif audio_format == WAVE_FORMAT_IMA_ADPCM:
        if bits != 4:
            raise WavError(f"IMA ADPCM WAV must be 4-bit, got {bits}")
        if block_align < 4 * num_channels + num_channels * 4 or \
                block_align % (4 * num_channels):
            raise WavError(f"bad IMA ADPCM block align {block_align}")
        spb = (block_align - 4 * num_channels) * 2 // num_channels + 1
        n_blocks = data_size // block_align
        num_frames = n_blocks * spb
        rem = data_size - n_blocks * block_align
        if rem >= 4 * num_channels + 4 * num_channels:
            # trailing partial block: header + whole 4-byte groups
            num_frames += ((rem - 4 * num_channels)
                           // (4 * num_channels)) * 8 + 1
        if fact_frames is not None:
            num_frames = min(num_frames, fact_frames)
        return (AudioInfo(sample_rate, num_frames, num_channels, bits,
                          "adpcm_ima", block_align),
                data_off, data_size)
    elif audio_format == WAVE_FORMAT_MS_ADPCM:
        if bits != 4:
            raise WavError(f"MS ADPCM WAV must be 4-bit, got {bits}")
        if block_align <= 7 * num_channels:
            raise WavError(f"bad MS ADPCM block align {block_align}")
        # Block capacity from the framing; the fmt extension's
        # wSamplesPerBlock (and any appended coefficient pairs beyond
        # the 7 canonical ones) override the derived defaults.
        spb = (block_align - 7 * num_channels) * 2 // num_channels + 2
        coefs = _MS_COEFS
        if len(fmt_ext) >= 6:
            (_cb, ext_spb, n_coef) = struct.unpack_from("<HHH", fmt_ext)
            if 2 <= ext_spb <= spb:
                spb = ext_spb
            if n_coef >= 7 and len(fmt_ext) >= 6 + 4 * n_coef:
                coefs = tuple(
                    struct.unpack_from("<hh", fmt_ext, 6 + 4 * i)
                    for i in range(n_coef))
        n_blocks = data_size // block_align
        num_frames = n_blocks * spb
        rem = data_size - n_blocks * block_align
        if rem >= 7 * num_channels + 1:
            # trailing partial block: header (2 frames) + whole bytes
            num_frames += 2 + ((rem - 7 * num_channels) * 2
                               // num_channels)
        if fact_frames is not None:
            num_frames = min(num_frames, fact_frames)
        return (AudioInfo(sample_rate, num_frames, num_channels, bits,
                          "adpcm_ms", block_align,
                          samples_per_block=spb, coefs=coefs),
                data_off, data_size)
    elif audio_format == WAVE_FORMAT_GSM610:
        # MS GSM 6.10 (WAV49): mono by spec, 65-byte blocks of two
        # 160-sample frames (writers emit bits=0; don't validate it).
        if num_channels != 1:
            raise WavError("GSM 6.10 WAV must be mono")
        if block_align != 65:
            raise WavError(f"bad GSM 6.10 block align {block_align}")
        spb = 320
        if len(fmt_ext) >= 4:
            (_cb, ext_spb) = struct.unpack_from("<HH", fmt_ext)
            if 0 < ext_spb <= 320:
                spb = ext_spb
        n_blocks = data_size // 65
        num_frames = n_blocks * spb
        if data_size - n_blocks * 65 >= 33:
            num_frames += spb // 2       # trailing half block
        if fact_frames is not None:
            num_frames = min(num_frames, fact_frames)
        return (AudioInfo(sample_rate, num_frames, 1, bits, "gsm_ms",
                          65, samples_per_block=spb),
                data_off, data_size)
    else:
        raise WavError(f"unsupported format tag 0x{audio_format:04x}")
    bytes_per_frame = num_channels * (bits // 8)
    num_frames = data_size // bytes_per_frame if bytes_per_frame else 0
    return (AudioInfo(sample_rate, num_frames, num_channels, bits, enc,
                      block_align),
            data_off, num_frames * bytes_per_frame)


def info(path: str | Path) -> AudioInfo:
    """Header probe (reads only the first chunks)."""
    file_size = Path(path).stat().st_size
    with open(path, "rb") as f:
        head = f.read(64 * 1024)
    return _parse_header(head, file_size=file_size)[0]


def read(path: str | Path, dtype=np.float32) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> ([channels, frames] float array in [-1, 1],
    sample_rate). Matches torchaudio.load normalization conventions."""
    with open(path, "rb") as f:
        data = f.read()
    return read_bytes(data, dtype)


def read_bytes(data: bytes, dtype=np.float32) -> Tuple[np.ndarray, int]:
    """Decode an in-memory WAV payload (serving path — no temp file)."""
    ai, off, size = _parse_header(data)
    x = _convert_frames(data[off:off + size], ai, ai.num_frames, dtype)
    return x, ai.sample_rate


def _convert_frames(raw: bytes, ai: AudioInfo, num_frames: int,
                    dtype) -> np.ndarray:
    """Raw sample bytes -> [channels, num_frames] normalized array
    (torchaudio.load conventions)."""
    if ai.encoding == "adpcm_ima":
        return _decode_ima_adpcm(raw, ai, num_frames, dtype)
    if ai.encoding == "adpcm_ms":
        return _decode_ms_adpcm(raw, ai, num_frames, dtype)
    if ai.encoding == "gsm_ms":
        from audio_processor_tpu_torch.io import gsm

        x = gsm.decode_wav49(bytes(raw), num_frames)
        return (x.astype(dtype) / 32768.0)[None, :]
    n = num_frames * ai.num_channels
    if ai.encoding in ("pcm_alaw", "pcm_ulaw"):
        table = _ALAW_TABLE if ai.encoding == "pcm_alaw" \
            else _ULAW_TABLE
        codes = np.frombuffer(raw, dtype=np.uint8, count=n)
        x = table[codes].astype(dtype) / 32768.0
    elif ai.encoding == "pcm_float":
        dt = np.float32 if ai.bits_per_sample == 32 else np.float64
        x = np.frombuffer(raw, dtype="<" + np.dtype(dt).char, count=n) \
            .astype(dtype)
        # corrupt/hostile float payloads can carry NaN/Inf bit
        # patterns; zero them so one bad file can't poison its device
        # batch (finite samples pass through untouched; matches the
        # native reader)
        if not np.isfinite(x).all():
            x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    elif ai.bits_per_sample == 16:
        x = np.frombuffer(raw, dtype="<i2", count=n).astype(dtype) / 32768.0
    elif ai.bits_per_sample == 32:
        x = np.frombuffer(raw, dtype="<i4", count=n).astype(dtype) / 2147483648.0
    elif ai.bits_per_sample == 8:
        # 8-bit WAV is unsigned
        x = (np.frombuffer(raw, dtype="<u1", count=n).astype(dtype)
             - 128.0) / 128.0
    else:  # 24-bit packed
        b = np.frombuffer(raw, dtype=np.uint8, count=n * 3).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(dtype) / 8388608.0
    x = x.reshape(num_frames, ai.num_channels).T
    return np.ascontiguousarray(x)


def _decode_ms_adpcm(raw: bytes, ai: AudioInfo, num_frames: int,
                     dtype) -> np.ndarray:
    """MS ADPCM (WAV tag 0x0002) -> [C, num_frames] normalized.

    Per-block header: per-channel predictor index, iDelta, iSamp1,
    iSamp2; then 4-bit signed residuals, high nibble first, channels
    interleaved per sample time. predictor = (s1*c1 + s2*c2)/256 with
    C truncation toward zero (sign*(abs>>8)), sample = predictor +
    nibble*iDelta clamped to int16, iDelta = max(16,
    (AdaptTable[nibble]*iDelta)>>8) — bit-exact vs SDL's WAV loader
    (pygame oracle, test_wav_ms_adpcm). Blocks are independent, so
    the per-sample recurrence runs serial in t but vectorized across
    all blocks (same regime as _decode_ima_adpcm). Reference decodes
    this format via torchaudio's sox/soundfile backends
    (audio_processor.py:76-86 routes decode through torchaudio)."""
    ch, ba = ai.num_channels, ai.block_align
    spb = ai.samples_per_block or \
        (ba - 7 * ch) * 2 // ch + 2
    coefs = np.asarray(ai.coefs or _MS_COEFS, np.int64)
    buf = np.frombuffer(raw, np.uint8)
    n_whole = len(buf) // ba
    rem = buf[n_whole * ba:]
    blk = buf[:n_whole * ba].reshape(n_whole, ba)
    if len(rem) >= 7 * ch + 1:
        pad = np.zeros(ba, np.uint8)
        pad[:len(rem)] = rem
        blk = np.concatenate([blk, pad[None]], axis=0)
    B = blk.shape[0]
    if B == 0 or num_frames == 0 or spb < 2:
        return np.zeros((ch, 0), dtype)

    def _i16(lo, hi):
        v = lo.astype(np.int64) | (hi.astype(np.int64) << 8)
        return np.where(v >= 0x8000, v - 0x10000, v)

    pred_idx = np.clip(blk[:, :ch].astype(np.int64), 0,
                       len(coefs) - 1)                     # [B, ch]
    hdr = blk[:, ch:7 * ch]
    idelta = _i16(hdr[:, 0:2 * ch:2], hdr[:, 1:2 * ch:2])  # [B, ch]
    s1 = _i16(hdr[:, 2 * ch:4 * ch:2], hdr[:, 2 * ch + 1:4 * ch:2])
    s2 = _i16(hdr[:, 4 * ch:6 * ch:2], hdr[:, 4 * ch + 1:6 * ch:2])
    c1 = coefs[pred_idx, 0]                                # [B, ch]
    c2 = coefs[pred_idx, 1]

    payload = blk[:, 7 * ch:]                              # [B, P]
    nib = np.empty((B, payload.shape[1] * 2), np.int64)
    nib[:, 0::2] = payload >> 4
    nib[:, 1::2] = payload & 0xF
    nib = nib[:, :(spb - 2) * ch].reshape(B, spb - 2, ch)
    signed = np.where(nib > 7, nib - 16, nib)
    adapt = _MS_ADAPT[nib]                                 # [B, S, ch]

    out = np.empty((B, spb, ch), np.int64)
    out[:, 0] = s2
    out[:, 1] = s1
    # header iDelta is used as-is for the first residual (SDL/ffmpeg
    # semantics); the >=16 floor applies only after adaptation.
    a, b, d = s1.copy(), s2.copy(), idelta.copy()
    for i in range(spb - 2):
        num = a * c1 + b * c2
        predictor = np.sign(num) * (np.abs(num) >> 8)
        new = np.clip(predictor + signed[:, i] * d, -32768, 32767)
        out[:, i + 2] = new
        b, a = a, new
        # Post-adaptation clamp [16, 65535]: decoders diverge once
        # delta grows past int16 (MS's reference casts to short, SDL
        # saturates a Uint16, ffmpeg/libsndfile leave it unbounded);
        # encoder-produced streams stay below the cap, and in the
        # reachable region this matches SDL bit-exactly (the oracle).
        d = np.clip((adapt[:, i] * d) >> 8, 16, 65535)
    x = out.reshape(B * spb, ch).T[:, :num_frames]
    return np.ascontiguousarray(x.astype(dtype) / 32768.0)


def _decode_ima_adpcm(raw: bytes, ai: AudioInfo, num_frames: int,
                      dtype) -> np.ndarray:
    """IMA/DVI ADPCM (WAV tag 0x0011) -> [C, num_frames] normalized.

    Blocks are independent (each carries its own predictor/index
    header), so the per-sample recurrence runs serial in t but
    vectorized across ALL blocks at once. Expansion matches audioop's
    adpcm2lin bit-test formula exactly (old step for the magnitude,
    then index update, both clamped) — parity-tested."""
    ch, ba = ai.num_channels, ai.block_align
    spb = (ba - 4 * ch) * 2 // ch + 1
    buf = np.frombuffer(raw, np.uint8)
    n_whole = len(buf) // ba
    rem = buf[n_whole * ba:]
    blk = buf[:n_whole * ba].reshape(n_whole, ba)
    if len(rem) >= 8 * ch:
        # pad the trailing partial block; num_frames trims the excess
        keep = 4 * ch + ((len(rem) - 4 * ch) // (4 * ch)) * (4 * ch)
        pad = np.zeros(ba, np.uint8)
        pad[:keep] = rem[:keep]
        blk = np.concatenate([blk, pad[None]], axis=0)
    B = blk.shape[0]
    if B == 0 or num_frames == 0:
        return np.zeros((ch, 0), dtype)

    out = np.empty((ch, B, spb), np.int16)
    hdr = blk[:, :4 * ch].reshape(B, ch, 4).astype(np.int32)
    pred = hdr[:, :, 0] | (hdr[:, :, 1] << 8)          # [B, ch]
    pred = np.where(pred >= 0x8000, pred - 0x10000, pred)
    idx = np.clip(hdr[:, :, 2], 0, 88)
    out[:, :, 0] = pred.T
    groups = blk[:, 4 * ch:].reshape(B, -1, ch, 4)     # 4-byte words
    lo = groups & 0x0F
    hi = groups >> 4
    nibs = np.stack([lo, hi], axis=-1).reshape(B, -1, ch, 8)
    # [ch, B, spb-1] nibble streams, time-major per channel
    nibs = nibs.transpose(2, 0, 1, 3).reshape(ch, B, -1)[:, :, :spb - 1]
    pred = pred.T.astype(np.int32).copy()              # [ch, B]
    idx = idx.T.astype(np.int32).copy()
    for t in range(spb - 1):
        n = nibs[:, :, t].astype(np.int32)
        step = _IMA_STEPS[idx]
        diff = ((step >> 3)
                + np.where(n & 4, step, 0)
                + np.where(n & 2, step >> 1, 0)
                + np.where(n & 1, step >> 2, 0))
        pred = np.clip(pred + np.where(n & 8, -diff, diff),
                       -32768, 32767)
        idx = np.clip(idx + _IMA_INDEX_ADJ[n & 0x0F], 0, 88)
        out[:, :, t + 1] = pred
    x = out.reshape(ch, B * spb)[:, :num_frames].astype(dtype) / 32768.0
    return np.ascontiguousarray(x)


def read_range(path: str | Path, start_frame: int,
               num_frames: Optional[int] = None,
               dtype=np.float32) -> Tuple[np.ndarray, int]:
    """Random-access read of a frame range without loading the file:
    header parse on a 64 KiB prefix, one seek, one bounded read.
    Bit-identical to ``read(path)[0][:, start:start+num]``."""
    file_size = Path(path).stat().st_size
    with open(path, "rb") as f:
        head = f.read(64 * 1024)
        ai, off, _size = _parse_header(head, file_size=file_size)
        start = max(0, min(start_frame, ai.num_frames))
        stop = ai.num_frames if num_frames is None \
            else min(ai.num_frames, start + max(0, num_frames))
        count = max(0, stop - start)
        if ai.encoding == "gsm_ms":
            # GSM carries decoder state ACROSS blocks (LTP history,
            # lattice, de-emphasis) — blocks are not independently
            # decodable, so bit-identical random access must decode
            # from the stream head and slice (files are 1,625 B per
            # audio-minute; the full read stays cheap).
            f.seek(off)
            raw = f.read((stop + ai.samples_per_block - 1)
                         // ai.samples_per_block * ai.block_align)
            x = _convert_frames(raw, ai, stop, dtype)
            return (np.ascontiguousarray(x[:, start:stop]),
                    ai.sample_rate)
        if ai.encoding in ("adpcm_ima", "adpcm_ms"):
            # Blocks are self-contained: fetch only the blocks
            # covering the range and slice locally.
            ch, ba = ai.num_channels, ai.block_align
            spb = ((ba - 4 * ch) * 2 // ch + 1
                   if ai.encoding == "adpcm_ima"
                   else ai.samples_per_block
                   or (ba - 7 * ch) * 2 // ch + 2)
            if count == 0:
                return np.zeros((ch, 0), dtype), ai.sample_rate
            b0 = start // spb
            b1 = (stop - 1) // spb
            f.seek(off + b0 * ba)
            raw = f.read((b1 - b0 + 1) * ba)
            local_total = min((b1 - b0 + 1) * spb,
                              ai.num_frames - b0 * spb)
            x = _convert_frames(raw, ai, local_total, dtype)
            lo = start - b0 * spb
            return (np.ascontiguousarray(x[:, lo:lo + count]),
                    ai.sample_rate)
        bpf = ai.num_channels * (ai.bits_per_sample // 8)
        f.seek(off + start * bpf)
        raw = f.read(count * bpf)
    return _convert_frames(raw, ai, count, dtype), ai.sample_rate


def write(path: str | Path, waveform: np.ndarray, sample_rate: int) -> None:
    """Write [channels, frames] float array as 16-bit PCM WAV."""
    w = np.asarray(waveform)
    if w.ndim == 1:
        w = w[None, :]
    c, nf = w.shape
    pcm = np.clip(np.round(w.T * 32767.0), -32768, 32767).astype("<i2")
    payload = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, WAVE_FORMAT_PCM, c,
                            sample_rate, sample_rate * c * 2, c * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
