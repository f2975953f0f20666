"""Plain PyTorch reference of band-limited resampling as torchaudio's
``functional.resample`` defines it (``sinc_interp_hann``, lowpass filter
width 6, roll-off 0.99), in float64. Imports nothing of the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resample(x: torch.Tensor, orig: int, new: int, width_zc: int = 6,
             rolloff: float = 0.99) -> torch.Tensor:
    """[..., T] -> [..., ceil(T * new / orig)] float64."""
    if orig == new:
        return x.double()
    g = math.gcd(int(orig), int(new))
    o, n = int(orig) // g, int(new) // g
    base = min(o, n) * rolloff
    width = math.ceil(width_zc * o / base)
    idx = torch.arange(-width, width + o, dtype=torch.float64) / o
    t = torch.arange(0, -n, -1, dtype=torch.float64)[:, None] / n + idx
    t = (t * base).clamp(-width_zc, width_zc)
    window = torch.cos(t * math.pi / width_zc / 2) ** 2
    t = t * math.pi
    kern = torch.where(t == 0, torch.ones_like(t), torch.sin(t) / t)
    kern = (kern * window * base / o).to(x.device)
    shape = x.shape
    flat = F.pad(x.double().reshape(-1, 1, shape[-1]), (width, width + o))
    y = F.conv1d(flat, kern[:, None, :], stride=o)
    y = y.transpose(1, 2).reshape(flat.shape[0], -1)
    length = math.ceil(n * shape[-1] / o)
    return y[:, :length].reshape(*shape[:-1], length)
