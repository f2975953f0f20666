"""Polyphase sinc resampler (port of dsp/resample.py).

torchaudio ``Resample`` numerics (lowpass_filter_width=6, rolloff=0.99,
hann window). Kernels are built once per (orig, new) rate pair on the
host in float64. :func:`resample_np` is the host half, which the pipeline
runs on decoded calls (``pipeline.chunker.prepare_and_split``);
:func:`resample` is the device half, one strided convolution on the
tensor's device whose output channels are the gcd-reduced phases.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def sinc_resample_kernel(orig_freq: int, new_freq: int,
                         lowpass_filter_width: int = 6,
                         rolloff: float = 0.99,
                         resampling_method: str = "sinc_interp_hann",
                         beta: float | None = None
                         ) -> Tuple[np.ndarray, int, int, int]:
    """Polyphase kernel bank: (kernels [new_g, K], width, orig_g, new_g)
    with K = 2*width + orig_g and width = ceil(lowpass_filter_width *
    orig_g / base_freq)."""
    if orig_freq <= 0 or new_freq <= 0:
        raise ValueError("frequencies must be positive")
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_g, new_g = int(orig_freq) // g, int(new_freq) // g

    base_freq = min(orig_g, new_g) * rolloff
    width = math.ceil(lowpass_filter_width * orig_g / base_freq)

    idx = np.arange(-width, width + orig_g, dtype=np.float64) / orig_g
    t = (-np.arange(new_g, dtype=np.float64) / new_g)[:, None] + idx[None, :]
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    if resampling_method == "sinc_interp_hann":
        window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    elif resampling_method == "sinc_interp_kaiser":
        if beta is None:
            beta = 14.769656459379492
        from scipy.special import i0
        window = i0(beta * np.sqrt(
            np.clip(1.0 - (t / lowpass_filter_width) ** 2, 0.0, None))) / i0(beta)
    else:
        raise ValueError(f"unknown resampling method {resampling_method}")

    tpi = t * np.pi
    scale = base_freq / orig_g
    kernels = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1.0, tpi))
    kernels = kernels * window * scale
    return kernels.astype(np.float32), width, orig_g, new_g


def resampled_length(length: int, orig_freq: int, new_freq: int) -> int:
    g = math.gcd(int(orig_freq), int(new_freq))
    return int(math.ceil(new_freq // g * length / (orig_freq // g)))


def resample(waveform: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6,
             rolloff: float = 0.99) -> torch.Tensor:
    """Resample [..., T] -> [..., ceil(T * new/orig)] on the tensor's
    device, float32 out; identity when the rates match. True fp32 or
    better, as the reference's HIGHEST precision: on CUDA the convolution
    runs in float64 (cuDNN would run an fp32 one in TF32 by default)."""
    if orig_freq == new_freq:
        return waveform
    kernels, width, orig_g, new_g = sinc_resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff)
    shape = waveform.shape
    T = shape[-1]
    dtype = torch.float64 if waveform.is_cuda else torch.float32
    x = F.pad(waveform.reshape(-1, 1, T).to(dtype),
              (width, width + orig_g))                      # [N, 1, T+K]
    k = torch.from_numpy(kernels).to(x.device, dtype)[:, None, :]
    y = F.conv1d(x, k, stride=orig_g)                       # [N, new_g, T']
    y = y.transpose(1, 2).reshape(x.shape[0], -1)           # interleave
    tgt = resampled_length(T, orig_freq, new_freq)
    return y[:, :tgt].reshape(*shape[:-1], tgt).float()


def resample_np(waveform: np.ndarray, orig_freq: int,
                new_freq: int, **kw) -> np.ndarray:
    """Resample [..., T] -> [..., ceil(T * new/orig)] (float64
    accumulation, float32 out; identity when the rates match). A
    zero-copy sliding-window view strided by orig_g feeds one batched
    matmul."""
    if orig_freq == new_freq:
        return np.asarray(waveform)
    kernels, width, orig_g, new_g = sinc_resample_kernel(
        orig_freq, new_freq, **kw)
    kernels = kernels.astype(np.float64)
    x = np.asarray(waveform, dtype=np.float64)
    shape = x.shape
    T = shape[-1]
    x = x.reshape(-1, T)
    x = np.pad(x, ((0, 0), (width, width + orig_g)))
    K = kernels.shape[1]
    n_steps = (x.shape[1] - K) // orig_g + 1
    windows = np.lib.stride_tricks.sliding_window_view(
        x, K, axis=1)[:, ::orig_g][:, :n_steps]     # [B, n_steps, K]
    out = windows @ kernels.T                       # [B, n_steps, new_g]
    out = out.reshape(x.shape[0], n_steps * new_g)
    tgt = resampled_length(T, orig_freq, new_freq)
    return np.ascontiguousarray(out[:, :tgt]) \
        .reshape(*shape[:-1], tgt).astype(np.float32)
