"""Device wire-format helpers shared by the upload paths."""

from __future__ import annotations

import numpy as np
import torch


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``. On CUDA the copy goes through
    pinned staging and is asynchronous (the caching host allocator keeps
    the block until the copy is done)."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def maybe_int16_wire(x: np.ndarray) -> np.ndarray:
    """Return ``x`` as int16 when every sample is int16-exact, else
    ``x`` unchanged.

    The int16 wire halves host->device bytes; the device dequantizes
    by an exact power-of-two scale (x * 2^-15), so for PCM16-decoded
    sources — where every sample is k/32768 with k in [-32768, 32767],
    including full-scale-negative clipping — results are BIT-IDENTICAL
    to uploading the f32 values. Anything else (resampled audio,
    synthetic floats, NaN/inf) fails the exactness predicate and keeps
    the f32 wire, so numerics never change.
    """
    if x.dtype != np.float32:
        return x
    q = x * np.float32(32768.0)
    qr = np.rint(q)
    if bool(np.all((qr == q) & (qr >= -32768.0) & (qr <= 32767.0))):
        return qr.astype(np.int16)
    return x
