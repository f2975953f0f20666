"""MFCC with torchaudio-compatible numerics (port of dsp/mfcc.py).

torchaudio defaults reproduced: HTK mel scale with triangles in Hz
space (n_mels 128, f_min 0, f_max sr/2, no filter norm), power dB
``10*log10(max(x, 1e-10))`` and an 'ortho' DCT-II. The filter banks are
built on the host in numpy as the reference builds them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audio_processor_tpu_torch.dsp.stft import hann_window


def hertz_to_htk_mel(freq):
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def htk_mel_to_hertz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def htk_mel_filters(n_freqs: int = 257, n_mels: int = 128,
                    sample_rate: int = 16000, f_min: float = 0.0,
                    f_max: float | None = None) -> np.ndarray:
    """[n_freqs, n_mels] triangular bank (torchaudio
    ``melscale_fbanks`` semantics)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hertz_to_htk_mel(f_min), hertz_to_htk_mel(f_max),
                        n_mels + 2)
    f_pts = htk_mel_to_hertz(m_pts)
    fdiff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dct_matrix(n_mfcc: int = 13, n_mels: int = 128) -> np.ndarray:
    """[n_mels, n_mfcc] DCT-II basis, 'ortho' norm (torchaudio
    ``create_dct``)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    dct[:, 0] *= 1.0 / np.sqrt(n_mels)
    dct[:, 1:] *= np.sqrt(2.0 / n_mels)
    return dct.astype(np.float32)


@functools.lru_cache(maxsize=8)
def centered_window(win_length: int = 400, n_fft: int = 512) -> np.ndarray:
    """Periodic hann window zero-padded centered into the FFT buffer,
    as torch.stft does when win_length < n_fft."""
    w = hann_window(win_length, periodic=True)
    buf = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    buf[off:off + win_length] = w
    return buf


def mfcc_from_power_frames(power: torch.Tensor, n_mfcc: int = 13,
                           n_mels: int = 128,
                           sample_rate: int = 16000) -> torch.Tensor:
    """[..., F, n_freqs] power spectrum -> [..., F, n_mfcc] (fp32
    matmuls, kept out of TF32 like the frontend's)."""
    dev = power.device
    mel = power @ torch.from_numpy(
        htk_mel_filters(power.shape[-1], n_mels, sample_rate)).to(dev)
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    return db @ torch.from_numpy(dct_matrix(n_mfcc, n_mels)).to(dev)
