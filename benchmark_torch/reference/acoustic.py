"""Plain PyTorch reference of the 38 acoustic sentiment features of one
speaker chunk, from the pipeline's documented definition:

  rms mean / std / range and zero-crossing rate mean / std over 25 ms
  frames every 10 ms (no padding); spectral centroid, bandwidth and 85%
  roll-off mean / std over a centred, reflect-padded STFT (n_fft 512, a
  periodic Hann window of 400, hop 160); the flux-autocorrelation tempo
  (argmax over the full correlation with its index 0 zeroed, read as a
  frame count); 13 MFCCs (HTK mel triangles in Hz, 128 bins, power in dB
  with a 1e-10 floor, orthonormal DCT-II) as mean / std pairs. Standard
  deviations take ddof 1; audio shorter than one frame gives zeros.

``dtype`` is the precision the spectra are computed in: float32 for the
reference, bfloat16 (inputs and spectra rounded to it) for the control.
Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

SR = 16000
FRAME, HOP, NFFT = 400, 160, 512
N_MFCC, N_MELS = 13, 128


def _htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _htk_inv(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def htk_bank() -> np.ndarray:
    """[257, 128] triangles in Hz between HTK-mel-spaced points."""
    freqs = np.linspace(0, SR // 2, NFFT // 2 + 1)
    pts = _htk_inv(np.linspace(_htk(0.0), _htk(SR / 2.0), N_MELS + 2))
    bank = np.zeros((freqs.size, N_MELS))
    for m in range(N_MELS):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        bank[:, m] = np.maximum(0.0, np.minimum((freqs - lo) / (c - lo),
                                                (hi - freqs) / (hi - c)))
    return bank


def dct_ortho() -> np.ndarray:
    n = np.arange(N_MELS)[:, None]
    k = np.arange(N_MFCC)[None, :]
    d = np.cos(np.pi / N_MELS * (n + 0.5) * k)
    d[:, 0] *= np.sqrt(1.0 / N_MELS)
    d[:, 1:] *= np.sqrt(2.0 / N_MELS)
    return d


def _mean_std(x: torch.Tensor):
    return x.mean(dim=-1), x.std(dim=-1, unbiased=True)


def features(wave: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[T] float audio -> [38] float64 features."""
    n = wave.shape[0]
    if n < FRAME:
        return torch.zeros(38, dtype=torch.float64)
    dev = wave.device

    def rnd(t):  # computation precision of the spectra
        return t.to(dtype).float() if dtype != torch.float32 else t.float()

    x = rnd(wave.float())
    fr = x.unfold(0, FRAME, HOP)
    rms = torch.sqrt((fr * fr).mean(dim=-1))
    s = torch.sign(fr)
    zcr = ((s[:, :-1] * s[:, 1:]) < 0).sum(dim=-1).float() / FRAME
    rms_m, rms_s = _mean_std(rms)
    zcr_m, zcr_s = _mean_std(zcr)

    win = torch.hann_window(FRAME, periodic=True, device=dev)
    spec = torch.stft(x, NFFT, hop_length=HOP, win_length=FRAME, window=win,
                      center=True, pad_mode="reflect", return_complex=True)
    power = rnd(spec.real ** 2 + spec.imag ** 2)             # [257, F]
    mag = rnd(torch.sqrt(power))
    freqs = torch.linspace(0.0, SR / 2.0, NFFT // 2 + 1, device=dev)
    energy = mag.sum(dim=0) + 1e-8
    centroid = (mag * freqs[:, None]).sum(dim=0) / energy
    bandwidth = torch.sqrt(
        (mag * (freqs[:, None] - centroid[None, :]) ** 2).sum(dim=0) / energy)
    cum = torch.cumsum(mag, dim=0)
    hit = (cum >= 0.85 * (cum[-1:] + 1e-8)).int()
    rolloff = freqs[torch.argmax(hit, dim=0)]

    bank = torch.from_numpy(htk_bank()).float().to(dev)
    dct = torch.from_numpy(dct_ortho()).float().to(dev)
    mel = rnd(bank.T @ power)                                 # [128, F]
    db = rnd(10.0 * torch.log10(torch.clamp(mel, min=1e-10)))
    mfcc = dct.T @ db                                         # [13, F]
    mf_m, mf_s = _mean_std(mfcc)

    flux = torch.relu(mag[:, 1:] - mag[:, :-1]).sum(dim=0).double()
    L = flux.shape[0]
    corr = torch.nn.functional.conv1d(flux[None, None], flux[None, None],
                                      padding=L - 1)[0, 0]    # full, [2L-1]
    corr[0] = 0.0
    idx = int(torch.argmax(corr))
    tempo = 0.0
    if float(corr.max()) > 0 and idx > 0:
        tempo = 60.0 / (idx * HOP / SR)

    head = [rms_m, rms_s, rms.max() - rms.min(), zcr_m, zcr_s,
            *_mean_std(centroid), *_mean_std(bandwidth), *_mean_std(rolloff)]
    out = torch.stack([t.double() for t in head]
                      + [torch.tensor(tempo, dtype=torch.float64,
                                      device=dev)])
    mf = torch.stack([mf_m, mf_s], dim=-1).reshape(-1).double()
    return torch.cat([out, mf]).cpu()
