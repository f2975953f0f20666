"""Batched acoustic feature extraction for sentiment (port of
dsp/acoustic_features.py).

The reference's 38-value feature vector per speaker chunk, in order:

  rms_mean, rms_std, rms_range, zcr_mean, zcr_std,
  spectral_centroid_mean/std, spectral_bandwidth_mean/std,
  spectral_rolloff_mean/std, tempo,
  mfcc_{0..12}_mean, mfcc_{0..12}_std (interleaved mean/std)

with the reference's torch semantics: unbiased std (ddof=1, NaN for a
single frame), 25 ms/10 ms unfold framing for RMS/ZCR, center=True
reflect-pad STFT (n_fft 512, hann-400 window centered in the FFT
buffer), torchaudio MFCC defaults, and the spectral-flux
autocorrelation "tempo" with its quirk: the argmax runs over the full
correlation array, with only the reference's index 0 zeroed.

Reflect padding happens on the host (:func:`prepare_reflect_padded`),
so the device function sees one static-shaped buffer per bucket. Audio
shorter than one frame yields all-zero features.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_processor_tpu_torch.dsp.mfcc import (
    centered_window, mfcc_from_power_frames,
)
from audio_processor_tpu_torch.dsp.stft import (
    device_table, frame_signal, power_spectrum, require_true_fp32,
)

FRAME_LENGTH = 400
HOP = 160
N_FFT = 512
PAD = N_FFT // 2          # torch.stft center padding
N_MFCC = 13
NUM_FEATURES = 12 + 2 * N_MFCC  # 38
SAMPLE_RATE = 16000.0
# The feature vector's order.
FEATURE_NAMES = (
    ["rms_mean", "rms_std", "rms_range", "zcr_mean", "zcr_std",
     "spectral_centroid_mean", "spectral_centroid_std",
     "spectral_bandwidth_mean", "spectral_bandwidth_std",
     "spectral_rolloff_mean", "spectral_rolloff_std", "tempo"]
    + [x for i in range(N_MFCC) for x in (f"mfcc_{i}_mean", f"mfcc_{i}_std")]
)


def prepare_reflect_padded(waves: List[np.ndarray], bucket_len: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side prep: place each mono waveform, reflect-padded by PAD
    samples on both sides, into a static [B, bucket_len + 2*PAD]
    float32 buffer. Returns (buffer, lengths)."""
    B = len(waves)
    buf = np.zeros((B, bucket_len + 2 * PAD), dtype=np.float32)
    lengths = np.zeros((B,), dtype=np.int32)
    for i, w in enumerate(waves):
        w = np.asarray(w, dtype=np.float32).reshape(-1)[:bucket_len]
        n = w.shape[0]
        lengths[i] = n
        if n == 0:
            continue
        buf[i, PAD:PAD + n] = w
        left = min(PAD, n - 1)
        if left > 0:
            buf[i, PAD - left:PAD] = w[1:left + 1][::-1]
        right = min(PAD, n - 1)
        if right > 0:
            buf[i, PAD + n:PAD + n + right] = w[n - right - 1:n - 1][::-1]
    return buf, lengths


def _masked_mean_std(x: torch.Tensor, mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean/std over the last axis with ddof=1 (std of a single element
    is NaN, which downstream gating relies on)."""
    m = mask.float()
    n = m.sum(dim=-1)
    mean = (x * m).sum(dim=-1) / torch.clamp(n, min=1.0)
    d = (x - mean[..., None]) * m
    var = (d * d).sum(dim=-1) / (n - 1.0)   # NaN/Inf when n == 1
    return mean, torch.sqrt(var)


def _flux_autocorrelation(flux: torch.Tensor) -> torch.Tensor:
    """[B, L] -> [B, 2L-1] full autocorrelation of each row (one grouped
    conv). Computed in float64, where no backend substitutes TF32, and
    returned in float32."""
    B, L = flux.shape
    f = flux.double()
    corr = F.conv1d(f[None], f[:, None, :], padding=L - 1, groups=B)[0]
    return corr.float()


def extract_features_batch(padded: torch.Tensor, lengths: torch.Tensor
                           ) -> torch.Tensor:
    """[B, bucket+2*PAD] reflect-padded audio -> [B, 38] features.

    ``lengths`` are the unpadded sample counts; the sample rate is the
    pipeline's 16 kHz."""
    sr = SAMPLE_RATE
    dev = padded.device
    require_true_fp32(dev)
    B, Tbuf = padded.shape
    Tbuck = Tbuf - 2 * PAD
    x = padded.float()
    lengths = lengths.to(dev).long()
    core = x[:, PAD:PAD + Tbuck]

    # ---- unfold framing (no padding) for RMS / ZCR --------------------
    nf_max = max(0, 1 + (Tbuck - FRAME_LENGTH) // HOP)
    frames = frame_signal(core, FRAME_LENGTH, HOP, nf_max)     # [B,F,400]
    nf_valid = torch.clamp(
        1 + torch.div(lengths - FRAME_LENGTH, HOP, rounding_mode="floor"),
        min=0)
    fmask = torch.arange(nf_max, device=dev)[None, :] < nf_valid[:, None]

    rms = torch.sqrt((frames * frames).mean(dim=-1))           # [B,F]
    rms_mean, rms_std = _masked_mean_std(rms, fmask)
    big = 3.4e38
    rms_max = torch.where(fmask, rms, -big).amax(dim=-1)
    rms_min = torch.where(fmask, rms, big).amin(dim=-1)
    rms_rng = rms_max - rms_min

    signs = torch.sign(frames)
    zc = ((signs[..., :-1] * signs[..., 1:]) < 0).sum(dim=-1).float() \
        / FRAME_LENGTH
    zcr_mean, zcr_std = _masked_mean_std(zc, fmask)

    # ---- STFT (center=True semantics via host reflect pad) ------------
    nf2_max = Tbuck // HOP + 1
    sframes = frame_signal(x, N_FFT, HOP, nf2_max)             # [B,F2,512]
    win = device_table(centered_window, (FRAME_LENGTH, N_FFT), dev)
    sframes = sframes * win
    power = power_spectrum(sframes, N_FFT)                     # [B,F2,257]

    nf2_valid = torch.div(lengths, HOP, rounding_mode="floor") + 1
    smask = (torch.arange(nf2_max, device=dev)[None, :]
             < nf2_valid[:, None])                             # [B,F2]
    mag = torch.sqrt(torch.clamp(power, min=0.0)) * smask[..., None]

    freqs = device_table(np.linspace, (0.0, sr / 2.0, N_FFT // 2 + 1),
                         dev)                                  # [257]
    energy = mag.sum(dim=-1) + 1e-8                            # [B,F2]

    centroid = (mag * freqs).sum(dim=-1) / energy
    sc_mean, sc_std = _masked_mean_std(centroid, smask)

    diff_sq = (freqs[None, None, :] - centroid[..., None]) ** 2
    bandwidth = torch.sqrt((mag * diff_sq).sum(dim=-1) / energy)
    sb_mean, sb_std = _masked_mean_std(bandwidth, smask)

    cum = torch.cumsum(mag, dim=-1)
    thresh = 0.85 * (cum[..., -1] + 1e-8)
    roll_idx = torch.argmax((cum >= thresh[..., None]).to(torch.int32),
                            dim=-1)                            # first hit
    sr_mean, sr_std = _masked_mean_std(freqs[roll_idx], smask)

    # ---- MFCC ----------------------------------------------------------
    mfcc = mfcc_from_power_frames(power, N_MFCC)               # [B,F2,13]
    mf_mean, mf_std = _masked_mean_std(mfcc.transpose(1, 2),
                                       smask[:, None, :])      # [B,13]

    # ---- tempo via spectral-flux autocorrelation ----------------------
    flux = torch.relu(mag[:, 1:, :] - mag[:, :-1, :]).sum(dim=-1)  # [B,L]
    L = nf2_max - 1
    corr = _flux_autocorrelation(flux)                         # [B,2L-1]
    L_valid = nf2_valid - 1
    # The reference zeroes its index 0 == lag -(L_valid-1); replicate
    # at the static-array position (L-1) - (L_valid-1).
    zero_pos = (L - 1) - (L_valid - 1)
    corr = corr * (torch.arange(2 * L - 1, device=dev)[None, :]
                   != zero_pos[:, None]).float()
    max_val = corr.amax(dim=-1)
    arg = torch.argmax(corr, dim=-1)
    ref_idx = arg - (L - 1) + (L_valid - 1)   # index in reference array
    period = torch.where((max_val > 0) & (ref_idx > 0),
                         ref_idx.float() * HOP / sr,
                         torch.zeros((), device=dev))
    tempo = torch.where(period > 0, 60.0 / torch.clamp(period, min=1e-12),
                        torch.zeros((), device=dev))

    feats = torch.stack([
        rms_mean, rms_std, rms_rng, zcr_mean, zcr_std,
        sc_mean, sc_std, sb_mean, sb_std, sr_mean, sr_std, tempo,
    ], dim=-1)                                                 # [B,12]
    mf = torch.stack([mf_mean, mf_std], dim=-1).reshape(B, 2 * N_MFCC)
    feats = torch.cat([feats, mf], dim=-1)                     # [B,38]

    # Audio shorter than one frame -> all-zero features.
    ok = (lengths >= FRAME_LENGTH)[:, None]
    return torch.where(ok, feats, torch.zeros((), device=dev))
