"""Framing and matmul-DFT building blocks (port of dsp/stft.py).

The windows and DFT matrices are built on the host in numpy exactly as
the reference builds them, then moved to the caller's device; framing
is ``Tensor.unfold`` (a strided view, no gather).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_window(length: int, periodic: bool = True) -> np.ndarray:
    """Hann window; ``periodic=True`` matches ``torch.hann_window``."""
    n = length + 1 if periodic else length
    if n <= 1:
        return np.ones(length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return w[:length] if periodic else w


def povey_window(length: int) -> np.ndarray:
    """Kaldi's Povey window: symmetric hann ** 0.85."""
    return hann_window(length, periodic=False) ** 0.85


@functools.lru_cache(maxsize=16)
def dft_matrices_np(frame_length: int, fft_length: int) -> tuple:
    """(cos, -sin) float32 matrices of shape [frame_length,
    fft_length//2+1]: the DFT of a frame zero-padded to fft_length."""
    n = np.arange(frame_length)[:, None]
    k = np.arange(fft_length // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / float(fft_length)
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


def dft_matrices(frame_length: int, fft_length: int,
                 device: torch.device) -> tuple:
    cos_m, msin_m = dft_matrices_np(frame_length, fft_length)
    return (torch.from_numpy(cos_m).to(device),
            torch.from_numpy(msin_m).to(device))


def frame_signal(x: torch.Tensor, frame_length: int, hop: int,
                 num_frames: int) -> torch.Tensor:
    """[..., T] -> [..., num_frames, frame_length] overlapping frames
    (a view; ``num_frames`` must fit in T)."""
    return x.unfold(-1, frame_length, hop)[..., :num_frames, :]
