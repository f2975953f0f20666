"""ctypes bindings for the first-party C++ audio IO library.

The library (native/audioio.cpp, vorbis.cpp, flac.cpp, built by
``audio_processor_tpu_torch._build.build_all(..., native=True)`` into
the port's own ``io/_native/``, named by a hash of the sources) provides a GIL-free WAV
probe/read and a multithreaded batch reader. Falls back transparently
(callers get None) when the shared library isn't built; io/wav.py is
the pure-Python behavioral reference.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from audio_processor_tpu_torch import _build
from audio_processor_tpu_torch.io.wav import AudioInfo

_LIB_PATH = _build.native_library()
_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not _LIB_PATH.exists():
            _lib = False
            return _lib
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.ap_probe_wav.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_int64)]
            lib.ap_probe_wav.restype = ctypes.c_int
            lib.ap_read_wav.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
            lib.ap_read_wav.restype = ctypes.c_int
            lib.ap_read_wav_batch.argtypes = [
                ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
            lib.ap_read_wav_batch.restype = ctypes.c_int
            try:
                lib.ap_prepare_fused.argtypes = [
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_int64, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int16), ctypes.c_int32]
                lib.ap_prepare_fused.restype = ctypes.c_int
            except AttributeError:
                pass
            try:
                lib.ap_vorbis_probe.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
                lib.ap_vorbis_probe.restype = ctypes.c_int
                lib.ap_vorbis_decode.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
                lib.ap_vorbis_decode.restype = ctypes.c_int
            except AttributeError:
                pass  # older lib build without the vorbis decoder
            try:
                lib.ap_flac_probe.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
                lib.ap_flac_probe.restype = ctypes.c_int
                lib.ap_flac_decode.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
                lib.ap_flac_decode.restype = ctypes.c_int
            except AttributeError:
                pass  # older lib build without the flac decoder
            _lib = lib
        except OSError:
            _lib = False
    return _lib


def has_prepare_fused() -> bool:
    lib = _load()
    return bool(lib) and hasattr(lib, "ap_prepare_fused")


def prepare_fused_int16(agents, clients, lengths, bucket_len: int,
                        pad: int, n_threads: int = 8
                        ) -> Optional[np.ndarray]:
    """GIL-free reflect-pad + int16 quantize into [N, 2, bucket+2*pad].

    agents/clients: lists of contiguous float32 arrays; lengths: valid
    sample counts (clamped to bucket_len).
    """
    lib = _load()
    if not lib or not hasattr(lib, "ap_prepare_fused"):
        return None
    n = len(agents)
    out = np.empty((n, 2, bucket_len + 2 * pad), dtype=np.int16)
    a_ptrs = (ctypes.POINTER(ctypes.c_float) * n)()
    c_ptrs = (ctypes.POINTER(ctypes.c_float) * n)()
    lens = (ctypes.c_int64 * n)()
    keepalive = []
    for i in range(n):
        a = np.ascontiguousarray(agents[i], dtype=np.float32)
        c = np.ascontiguousarray(clients[i], dtype=np.float32)
        keepalive.append((a, c))
        a_ptrs[i] = a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        c_ptrs[i] = c.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        lens[i] = min(int(lengths[i]), bucket_len)
    rc = lib.ap_prepare_fused(
        n, a_ptrs, c_ptrs, lens, bucket_len, pad,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        int(n_threads))
    if rc != 0:
        return None
    return out


def _sane_alloc(path, frames: int, channels: int) -> bool:
    """Guard the decode-buffer allocation against corrupt headers: a
    lying STREAMINFO/granule can claim billions of samples. Bound by
    the best real-world compression ratio with huge margin (a CONSTANT
    FLAC frame is ~3.3k samples/byte) and by a 2 GiB buffer cap;
    oversize requests fall back to the Python decoders, which allocate
    from actual decoded frames, not the header's claim."""
    try:
        size = Path(path).stat().st_size
    except OSError:
        return False
    if frames > max(size, 4096) * 8192:
        return False
    return frames * channels * 4 <= (1 << 31)


def has_vorbis() -> bool:
    lib = _load()
    return bool(lib) and hasattr(lib, "ap_vorbis_decode")


def decode_vorbis(path: str | Path) -> Optional[Tuple[np.ndarray, int]]:
    """First-party C++ Vorbis decode; None if unavailable/failed."""
    lib = _load()
    if not lib or not hasattr(lib, "ap_vorbis_decode"):
        return None
    meta = (ctypes.c_int64 * 3)()
    rc = lib.ap_vorbis_probe(str(path).encode(), meta)
    if rc != 0 or meta[1] <= 0 or meta[2] <= 0:
        return None
    frames, channels = int(meta[1]), int(meta[2])
    if not _sane_alloc(path, frames, channels):
        return None        # corrupt header claiming absurd totals
    buf = np.zeros((channels, frames), dtype=np.float32)
    rc = lib.ap_vorbis_decode(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(frames), meta)
    if rc != 0:
        return None
    written = min(int(meta[1]), frames)
    return buf[:, :written], int(meta[0])


def has_flac() -> bool:
    lib = _load()
    return bool(lib) and hasattr(lib, "ap_flac_decode")


def probe_flac(path: str | Path) -> Optional[AudioInfo]:
    """First-party C++ FLAC probe; None if unavailable/failed."""
    lib = _load()
    if not lib or not hasattr(lib, "ap_flac_probe"):
        return None
    meta = (ctypes.c_int64 * 4)()
    rc = lib.ap_flac_probe(str(path).encode(), meta)
    if rc != 0:
        return None
    return AudioInfo(sample_rate=int(meta[0]), num_frames=int(meta[1]),
                     num_channels=int(meta[2]),
                     bits_per_sample=int(meta[3]), encoding="flac")


def decode_flac(path: str | Path) -> Optional[Tuple[np.ndarray, int]]:
    """First-party C++ FLAC decode (raw fLaC container; CRC-8/16 and
    STREAMINFO-MD5 verified); None if unavailable/failed — callers
    fall back to the Python decoder (io/flac.py), which also handles
    Ogg-FLAC and streams with an unknown total-sample count."""
    lib = _load()
    if not lib or not hasattr(lib, "ap_flac_decode"):
        return None
    meta = (ctypes.c_int64 * 4)()
    rc = lib.ap_flac_probe(str(path).encode(), meta)
    if rc != 0 or meta[1] <= 0 or meta[2] <= 0:
        return None
    frames, channels = int(meta[1]), int(meta[2])
    if not _sane_alloc(path, frames, channels):
        return None        # corrupt header claiming absurd totals
    buf = np.zeros((channels, frames), dtype=np.float32)
    rc = lib.ap_flac_decode(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(frames), meta)
    if rc != 0:
        return None
    written = min(int(meta[1]), frames)
    return buf[:, :written], int(meta[0])


def available() -> bool:
    return bool(_load())


def _meta_to_info(meta) -> AudioInfo:
    return AudioInfo(sample_rate=int(meta[0]), num_frames=int(meta[1]),
                     num_channels=int(meta[2]), bits_per_sample=int(meta[3]),
                     encoding="pcm_int")


def probe_wav(path: str | Path) -> Optional[AudioInfo]:
    lib = _load()
    if not lib:
        return None
    meta = (ctypes.c_int64 * 4)()
    rc = lib.ap_probe_wav(str(path).encode(), meta)
    if rc != 0:
        return None
    return _meta_to_info(meta)


def read_wav(path: str | Path) -> Optional[Tuple[np.ndarray, int]]:
    lib = _load()
    if not lib:
        return None
    info = probe_wav(path)
    if info is None:
        return None
    n = info.num_frames * info.num_channels
    buf = np.empty((info.num_channels, info.num_frames), dtype=np.float32)
    meta = (ctypes.c_int64 * 4)()
    rc = lib.ap_read_wav(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), meta)
    if rc != 0:
        return None
    return buf, info.sample_rate


def read_wav_batch(paths: Sequence[str | Path], n_threads: int = 8
                   ) -> List[Optional[Tuple[np.ndarray, int]]]:
    """Read many WAVs concurrently without the GIL. Failed entries are
    None; callers fall back per-file to the Python reader."""
    lib = _load()
    if not lib:
        return [read_wav(p) for p in paths]
    n = len(paths)
    infos = [probe_wav(p) for p in paths]
    bufs: List[Optional[np.ndarray]] = []
    c_paths = (ctypes.c_char_p * n)()
    c_dsts = (ctypes.POINTER(ctypes.c_float) * n)()
    c_caps = (ctypes.c_int64 * n)()
    metas = (ctypes.c_int64 * (4 * n))()
    codes = (ctypes.c_int32 * n)()
    dummy = np.zeros(1, dtype=np.float32)
    for i, (p, info) in enumerate(zip(paths, infos)):
        c_paths[i] = str(p).encode()
        if info is None:
            bufs.append(None)
            c_dsts[i] = dummy.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            c_caps[i] = 0
        else:
            buf = np.empty((info.num_channels, info.num_frames), np.float32)
            bufs.append(buf)
            c_dsts[i] = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            c_caps[i] = buf.size
    lib.ap_read_wav_batch(n, c_paths, c_dsts, c_caps, metas, codes,
                          int(n_threads))
    out: List[Optional[Tuple[np.ndarray, int]]] = []
    for i, info in enumerate(infos):
        if info is None or codes[i] != 0 or bufs[i] is None:
            out.append(None)
        else:
            out.append((bufs[i], info.sample_rate))
    return out
