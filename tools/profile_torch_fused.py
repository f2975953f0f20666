#!/usr/bin/env python
"""Device-time breakdown of the PyTorch port's fused ASR program on one
CUDA card.

    python3 tools/profile_torch_fused.py [--seed N]
        [--attention-impl {flash_rel,flash}]

Builds ``audio_processor_tpu_torch.pipeline.asr_engine.ASREngine`` in
synthetic mode (w2v-bert-2.0 width, random weights from the seed, bf16),
makes one full batch of 16 chunks x 25 s (48 encoder rows x 1280
frames, int16 wire) under the chosen attention (``flash_rel``, the
default, or ``flash``: the materialised bf16 bias and the flash
kernel), warms it up, times ``_fused`` with a host clock
around ``torch.cuda.synchronize()``, then runs it once more under
``torch.profiler`` and reads the exported Chrome trace. Only device
activity counts (kernels, memcpy, memset), so host-side operator
events are never added to kernel time. Prints:

- wall per batch (host clock, five runs) and the host's enqueue
  time in the profiled call;
- device time by category and its share of the profiled call's window
  (host call start to the last device activity's end);
- device busy time (the union of device intervals) and the idle share
  of the window;
- the top device kernels by time.

Imports nothing of JAX. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import torch

# (category, substrings of the kernel name), first match wins.
CATEGORIES = (
    ("flash_rel", ("flash_rel_kernel",)),
    ("flash", ("flash_attention_kernel",)),
    ("bias gather", ("gather",)),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
    ("cast/copy", ("copy_kernel",)),
    ("layer_norm", ("layer_norm",)),
    ("conv", ("conv",)),
    ("softmax/reduce", ("softmax", "reduce_kernel")),
    ("elementwise", ("elementwise",)),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "fused_batch"
RUNS = 5


def category(event: dict) -> str:
    if event["cat"] != "kernel":
        return event["cat"]
    for cat, keys in CATEGORIES:
        if any(k in event["name"] for k in keys):
            return cat
    return "other"


def breakdown(trace: dict) -> dict:
    """Device time of the one ``SPAN`` call in a Chrome trace: per
    category and per kernel name (ms, count), busy (union) ms, and the
    window from the host span's start to the last device end."""
    events = trace["traceEvents"]
    (span,) = [e for e in events if e.get("name") == SPAN
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and e["ts"] >= span["ts"]]
    by_cat: dict = {}
    by_name: dict = {}
    for e in dev:
        for table, key in ((by_cat, category(e)), (by_name, e["name"])):
            ms, n = table.get(key, (0.0, 0))
            table[key] = (ms + e["dur"] / 1e3, n + 1)
    busy, end = 0.0, span["ts"]
    for e in sorted(dev, key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], end), e["ts"] + e["dur"]
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    return {"by_cat": by_cat, "by_name": by_name, "busy_ms": busy / 1e3,
            "window_ms": (end - span["ts"]) / 1e3,
            "host_ms": span["dur"] / 1e3}


def make_batch(engine, seed: int):
    from audio_processor_tpu.pipeline.chunker import Chunk, chunk_batch

    rng = np.random.default_rng(seed)
    n = engine.device_chunks
    samples = max(engine.bucket_samples)
    chunks = [Chunk("profile.wav", i, 0.0, 25.0,
                    agent=(0.1 * rng.standard_normal(samples))
                    .astype(np.float32),
                    client=(0.1 * rng.standard_normal(samples))
                    .astype(np.float32))
              for i in range(n)]
    (batch,) = chunk_batch(chunks, engine.bucket_samples)
    buf, lengths = engine._prepare_fused_buffer(batch, n)
    return engine._upload(buf), engine._upload(lengths), batch.bucket_len


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attention-impl", choices=("flash_rel", "flash"),
                    default="flash_rel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_fused: needs a CUDA device")
    from audio_processor_tpu.config import PipelineConfig
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine

    cfg = PipelineConfig.from_dict({"chunk_batch_size": 16,
                                    "enable_mixed_precision": True,
                                    "attention_impl": args.attention_impl})
    engine = ASREngine(cfg, device="cuda")
    buf, lengths, bucket = make_batch(engine, args.seed)
    print(f"batch: {tuple(buf.shape)} {buf.dtype} -> encoder "
          f"{3 * buf.shape[0]} rows, attention {engine.attention_impl}, "
          f"{engine.dtype}", flush=True)

    for _ in range(3):
        engine._fused(buf, lengths, bucket)
    torch.cuda.synchronize()
    walls = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        engine._fused(buf, lengths, bucket)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"wall per batch (host clock, {RUNS} runs): "
          f"{[round(w, 4) for w in walls]} s, median "
          f"{float(np.median(walls)):.4f} s", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            engine._fused(buf, lengths, bucket)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path, encoding="utf-8") as f:
            b = breakdown(json.load(f))

    win = b["window_ms"]
    print(f"profiled call: window {win:.1f} ms (host span start to last "
          f"device end), host enqueue {b['host_ms']:.1f} ms, device busy "
          f"{b['busy_ms']:.1f} ms, device idle share "
          f"{1 - b['busy_ms'] / win:.4f}")
    print(f"{'category':16s} {'ms':>9s} {'count':>6s} {'share':>7s}")
    total = 0.0
    for cat, (ms, n) in sorted(b["by_cat"].items(), key=lambda x: -x[1][0]):
        total += ms
        print(f"{cat:16s} {ms:9.2f} {n:6d} {ms / win:7.3f}")
    print(f"{'sum':16s} {total:9.2f}")
    print("top device kernels:")
    for name, (ms, n) in sorted(b["by_name"].items(),
                                key=lambda x: -x[1][0])[:15]:
        print(f"  {ms:9.2f} ms {n:5d}x  {name[:110]}")
    assert "jax" not in sys.modules
    return 0


if __name__ == "__main__":
    sys.exit(main())
