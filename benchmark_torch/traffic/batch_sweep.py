"""Traffic kind ``batch_sweep``: a pool of recorded calls that a cron sweep
finds in its input folder, swept again and again for the window.

A mix file (``traffic/<mix>.json``) gives the parameters:

- ``pool_calls``: distinct calls in the pool;
- ``encoding``: ``pcm16`` or ``ulaw`` (G.711 mu-law), two channels (agent,
  client) in a RIFF/WAVE file;
- ``sample_rate``: of the files;
- ``duration_s``: ``{"dist": "fixed", "value": s}`` or
  ``{"dist": "lognormal", "median": s, "sigma": x, "min": a, "max": b}``.
  A lognormal pool takes the distribution's quantiles at (i + 0.5) / n,
  clipped, so every seed sweeps the same set of lengths in another order;
- ``noise``, ``tone``, ``turn_s``, ``tone_hz``: each channel is Gaussian
  noise of rms ``noise`` plus, while its speaker talks, a tone of amplitude
  ``tone`` at a frequency drawn from ``tone_hz``; speakers alternate every
  ``turn_s`` seconds (agent first).

The calls are drawn on the device from a generator seeded by the run's
seed, so the same seed gives the same files, and written once per run.
This is a seeded copy of the call generator of the port's profiling tools.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

DRIVER = "batch"


def durations(mix: Dict, seed: int) -> List[float]:
    """Call lengths of the pool, in pool order."""
    n = int(mix["pool_calls"])
    d = mix["duration_s"]
    if d["dist"] == "fixed":
        return [float(d["value"])] * n
    if d["dist"] != "lognormal":
        raise ValueError(f"unknown duration distribution {d['dist']!r}")
    from statistics import NormalDist

    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    lens = [min(max(d["median"] * math.exp(d["sigma"] * zi), d["min"]),
                d["max"]) for zi in z]
    order = np.random.default_rng(seed).permutation(n)
    return [round(lens[i], 3) for i in order]


def _ulaw_encode(x: torch.Tensor) -> torch.Tensor:
    """G.711 mu-law bytes of float audio (full scale 1.0)."""
    s = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int32)
    sign = (s < 0).to(torch.int32)
    mag = torch.clamp(torch.abs(s), max=32635) + 0x84
    exp = torch.clamp(torch.floor(torch.log2(mag.float())).to(torch.int32)
                      - 7, 0, 7)
    mant = (mag >> (exp + 3)) & 0x0F
    byte = ~((sign << 7) | (exp << 4) | mant) & 0xFF
    return byte.to(torch.uint8)


def _wav_bytes(data: bytes, channels: int, rate: int, fmt: int,
               bits: int) -> bytes:
    block = channels * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", fmt, channels, rate, rate * block,
                            block, bits)
    extra = b"" if fmt == 1 else struct.pack("<H", 0)
    fmt_chunk += extra
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def make_pool(mix: Dict, seed: int, root: Path, device) -> List[Dict]:
    """Write the pool under ``root``; returns one entry per call:
    {"path", "name", "duration_s", "sample_rate", "samples"}."""
    root.mkdir(parents=True, exist_ok=True)
    rate = int(mix["sample_rate"])
    lens = durations(mix, seed)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lo, hi = mix["tone_hz"]
    out = []
    for i, dur in enumerate(lens):
        n = int(round(dur * rate))
        t = torch.arange(n, device=device, dtype=torch.float64) / rate
        noise = torch.randn((2, n), generator=gen, device=device) \
            * float(mix["noise"])
        f = lo + (hi - lo) * torch.rand(2, generator=gen, device=device,
                                        dtype=torch.float64)
        on = (torch.floor(t / float(mix["turn_s"])) % 2 == 0)
        gate = torch.stack([on, ~on]).double()
        tone = float(mix["tone"]) * gate * torch.sin(
            2 * math.pi * f[:, None] * t[None, :])
        x = (noise.double() + tone).float().clamp(-1.0, 32767 / 32768)
        if mix["encoding"] == "pcm16":
            pcm = torch.round(x * 32768.0).to(torch.int16)
            data = pcm.T.contiguous().cpu().numpy().tobytes()
            blob = _wav_bytes(data, 2, rate, 1, 16)
        elif mix["encoding"] == "ulaw":
            data = _ulaw_encode(x).T.contiguous().cpu().numpy().tobytes()
            blob = _wav_bytes(data, 2, rate, 7, 8)
        else:
            raise ValueError(f"unknown encoding {mix['encoding']!r}")
        name = f"call-{i:03d}.wav"
        (root / name).write_bytes(blob)
        out.append({"path": root / name, "name": name, "duration_s": n / rate,
                    "sample_rate": rate, "samples": n})
    return out


def read_pcm(path: Path) -> tuple:
    """(int16-scale float64 samples [2, n], rate) of a pool file, decoded
    by the benchmark itself (PCM16 or mu-law)."""
    raw = Path(path).read_bytes()
    fmt, ch, rate, _, _, bits = struct.unpack("<HHIIHH", raw[20:36])
    pos = 12
    while raw[pos:pos + 4] != b"data":
        pos += 8 + struct.unpack("<I", raw[pos + 4:pos + 8])[0]
    size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
    body = raw[pos + 8:pos + 8 + size]
    if fmt == 1 and bits == 16:
        x = np.frombuffer(body, "<i2").astype(np.float64)
    elif fmt == 7:
        u = ~np.frombuffer(body, np.uint8).astype(np.int32) & 0xFF
        sign, exp, mant = u & 0x80, (u >> 4) & 0x07, u & 0x0F
        mag = (((mant << 3) + 0x84) << exp) - 0x84
        x = np.where(sign != 0, -mag, mag).astype(np.float64)
    else:
        raise ValueError(f"unsupported WAV format {fmt}/{bits}")
    return x.reshape(-1, ch).T, rate
