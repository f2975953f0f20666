"""Kaldi-style log-mel fbank frontend for Wav2Vec2Bert (port of
dsp/fbank.py).

Same numerics as the reference (HF ``SeamlessM4TFeatureExtractor``):
25 ms Povey-windowed frames, 10 ms hop, per-frame DC removal and 0.97
pre-emphasis, 512-point power spectrum, 80 Kaldi-mel filters, natural
log with floor 2^-23, masked per-utterance per-mel-bin normalization
(ddof=1), then stride-2 stacking to 160-dim features.

The DFT and mel projection are fp32 matmuls. They must stay true fp32
(the JAX package asks for ``Precision.HIGHEST``: a reduced-precision
power spectrum costs ~1% error, which the log amplifies). PyTorch's
default keeps fp32 matmuls out of TF32
(``torch.backends.cuda.matmul.allow_tf32`` is False); the frontend
refuses to run on CUDA if a caller has turned it on.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from audio_processor_tpu_torch.dsp.stft import (
    frame_signal, povey_window, power_spectrum, require_true_fp32,
)

FRAME_LENGTH = 400   # 25 ms @ 16 kHz
HOP_LENGTH = 160     # 10 ms
FFT_LENGTH = 512
NUM_MEL_BINS = 80
MEL_FLOOR = 1.192092955078125e-07  # 2**-23
PREEMPHASIS = 0.97
STRIDE = 2


def hertz_to_kaldi_mel(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=4)
def kaldi_mel_filters(num_frequency_bins: int = 257,
                      num_mel_filters: int = NUM_MEL_BINS,
                      min_frequency: float = 20.0,
                      max_frequency: float = 8000.0,
                      sampling_rate: int = 16000) -> np.ndarray:
    """[num_frequency_bins, num_mel_filters] triangular bank, Kaldi mel
    scale, triangularized in mel space, no normalization."""
    mel_min = hertz_to_kaldi_mel(min_frequency)
    mel_max = hertz_to_kaldi_mel(max_frequency)
    mel_pts = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    fft_bin_width = sampling_rate / ((num_frequency_bins - 1) * 2)
    fft_mels = hertz_to_kaldi_mel(fft_bin_width
                                  * np.arange(num_frequency_bins))
    fdiff = np.diff(mel_pts)
    slopes = mel_pts[None, :] - fft_mels[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def full_num_frames(padded_length: int) -> int:
    return max(0, 1 + (padded_length - FRAME_LENGTH) // HOP_LENGTH)


def max_num_frames(padded_length: int) -> int:
    # HF pads the frame axis up to a multiple of `stride` before
    # stacking (pad_to_multiple_of=2), so round up, not down.
    n = full_num_frames(padded_length)
    return n + (-n) % STRIDE


def num_output_frames(padded_length: int) -> int:
    return max_num_frames(padded_length) // STRIDE


def log_mel_frontend(waveform: torch.Tensor, lengths: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fbank + normalization + stride-2 stacking.

    Args:
      waveform: [B, T] float32, zero-padded; T fixed per bucket.
      lengths: [B] integer valid sample counts.

    Returns:
      features: [B, T2, 160] float32 (T2 = max_num_frames(T) // 2),
        masked positions 0.
      mask: [B, T2] bool attention mask for the encoder.
    """
    B, T = waveform.shape
    dev = waveform.device
    require_true_fp32(dev)
    n_full = full_num_frames(T)
    n_frames = max_num_frames(T)
    if n_frames <= 0:
        raise ValueError(f"bucket length {T} shorter than one frame")

    x = waveform.float() * 32768.0  # Kaldi int16 compliance
    frames = frame_signal(x, FRAME_LENGTH, HOP_LENGTH, n_full)  # [B,F,400]

    # Per-frame DC removal then pre-emphasis (Kaldi order).
    frames = frames - frames.mean(dim=-1, keepdim=True)
    pre = frames[..., 1:] - PREEMPHASIS * frames[..., :-1]
    first = frames[..., :1] * (1.0 - PREEMPHASIS)
    frames = torch.cat([first, pre], dim=-1)
    window = torch.from_numpy(
        povey_window(FRAME_LENGTH).astype(np.float32)).to(dev)
    frames = frames * window

    power = power_spectrum(frames, FFT_LENGTH)                 # [B,F,257]
    mel = power @ torch.from_numpy(kaldi_mel_filters()).to(dev)  # [B,F,80]
    logmel = torch.log(torch.clamp(mel, min=MEL_FLOOR))

    # Masked per-utterance per-mel-bin normalization (ddof=1).
    valid = torch.clamp(
        1 + torch.div(lengths.to(dev).long() - FRAME_LENGTH, HOP_LENGTH,
                      rounding_mode="floor"), min=0)            # [B]
    frame_mask = (torch.arange(n_full, device=dev)[None, :]
                  < valid[:, None])                             # [B,F]
    fm = frame_mask[..., None].float()
    n = torch.clamp(fm.sum(dim=1), min=1.0)                     # [B,1]
    mean = (logmel * fm).sum(dim=1, keepdim=True) / n[:, None]
    centered = (logmel - mean) * fm
    var = (centered * centered).sum(dim=1, keepdim=True) / \
        torch.clamp(n[:, None] - 1.0, min=1.0)
    feats = centered / torch.sqrt(var + 1e-7)
    feats = feats * fm

    # Pad the frame axis to an even count, then stride-2 stack:
    # [B, F, 80] -> [B, F//2, 160].
    if n_frames > n_full:
        pad = n_frames - n_full
        feats = torch.nn.functional.pad(feats, (0, 0, 0, pad))
        frame_mask = torch.nn.functional.pad(frame_mask, (0, pad))
    feats = feats.reshape(B, n_frames // STRIDE, NUM_MEL_BINS * STRIDE)
    return feats, frame_mask[:, 1::STRIDE]


def log_mel_frontend_np(waveform: np.ndarray) -> np.ndarray:
    """Float64 single-utterance reference path (pre-normalization
    fbank), used by tests and host-side verification."""
    x = np.asarray(waveform, dtype=np.float64) * 32768.0
    n = 1 + (len(x) - FRAME_LENGTH) // HOP_LENGTH
    window = povey_window(FRAME_LENGTH)
    bank = kaldi_mel_filters().astype(np.float64)
    out = np.empty((n, NUM_MEL_BINS))
    for f in range(n):
        fr = x[f * HOP_LENGTH: f * HOP_LENGTH + FRAME_LENGTH].copy()
        fr -= fr.mean()
        fr[1:] -= PREEMPHASIS * fr[:-1].copy()
        fr[0] *= 1 - PREEMPHASIS
        fr *= window
        spec = np.fft.rfft(fr, FFT_LENGTH)
        power = np.abs(spec) ** 2
        out[f] = np.log(np.maximum(power @ bank, MEL_FLOOR))
    return out
