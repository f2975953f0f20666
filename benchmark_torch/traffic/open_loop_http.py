"""Traffic kind ``open_loop_http``: callers who post a recorded call to the
HTTP server as each call ends, on an open-loop schedule.

A mix file (``traffic/<mix>.json``) gives the parameters:

- ``rate_per_s``: the offered load; the window's requests are
  ``round(rate_per_s * seconds)`` arrivals whose gaps are the exponential
  distribution's quantiles at (i + 0.5) / n (a Poisson process's gaps),
  shuffled by the seed, so every seed offers the same work in another order;
- ``pool_calls`` and the ``batch_sweep`` keys (``encoding``,
  ``sample_rate``, ``duration_s``, ``noise``, ``tone``, ``tone_hz``,
  ``turn_s``): the distinct calls the requests carry, made by the
  ``batch_sweep`` generator; request i carries pool call
  ``order[i % pool_calls]``;
- ``sentiment_share``: the share of requests that ask for sentiment
  (``?sentiment=1``), every other one in a seeded order for 0.5;
- ``batch_window_ms``: the server's micro-batching window.

Each request's body is its call's WAV with a ``LIST``/``ICMT`` chunk that
names the request, so the benchmark can tell apart two requests that carry
the same call.
"""

from __future__ import annotations

import importlib.util
import math
import struct
from pathlib import Path
from typing import Dict, List

import numpy as np

DRIVER = "serve"

_spec = importlib.util.spec_from_file_location(
    "bench_batch_sweep", Path(__file__).with_name("batch_sweep.py"))
_sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_sweep)
make_pool = _sweep.make_pool
read_pcm = _sweep.read_pcm
durations = _sweep.durations


def schedule(mix: Dict, seed: int, seconds: float) -> List[Dict]:
    """The window's requests: due time (s from the window's start), pool
    call, whether it asks for sentiment, and its name."""
    rate = float(mix["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(seed)
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps = gaps[rng.permutation(n)]
    due = np.cumsum(gaps) - gaps[0]
    due *= seconds / max(due[-1] + gaps.mean(), 1e-9)
    calls = int(mix["pool_calls"])
    order = rng.permutation(calls)
    k = int(round(float(mix["sentiment_share"]) * n))
    senti = np.zeros(n, bool)
    senti[rng.permutation(n)[:k]] = True
    return [{"due": float(due[i]), "call": int(order[i % calls]),
             "sentiment": bool(senti[i]), "name": f"q{i:05d}"}
            for i in range(n)]


def body(wav: bytes, name: str) -> bytes:
    """``wav`` with a LIST/ICMT chunk naming the request before ``data``."""
    text = name.encode() + b"\0"
    if len(text) % 2:
        text += b"\0"
    info = b"INFO" + b"ICMT" + struct.pack("<I", len(text)) + text
    chunk = b"LIST" + struct.pack("<I", len(info)) + info
    pos = wav.index(b"data", 12)
    out = wav[:pos] + chunk + wav[pos:]
    return out[:4] + struct.pack("<I", len(out) - 8) + out[8:]


def request_name(payload: bytes) -> str:
    """The name :func:`body` put into a request's WAV."""
    pos = payload.find(b"ICMT", 0, 256)
    if pos < 0:
        return ""
    n = struct.unpack("<I", payload[pos + 4:pos + 8])[0]
    return payload[pos + 8:pos + 8 + n].rstrip(b"\0").decode()


def mean_audio_s(mix: Dict) -> float:
    d = durations(mix, 0)
    return float(sum(d) / len(d)) if d else math.nan
