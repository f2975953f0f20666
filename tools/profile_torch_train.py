#!/usr/bin/env python
"""Device-time breakdown of the PyTorch port's CTC fine-tuning step on
one CUDA card.

    python3 tools/profile_torch_train.py [--seed N] [--batch B]

Builds ``audio_processor_tpu_torch.models.wav2vec2bert.Wav2Vec2Bert`` at
w2v-bert-2.0 width with seeded random weights on the card, one batch of
B rows x 25 s (1249 encoder frames; valid lengths drawn from 5-25 s,
prefix masks, ~10 labels a second) and AdamW (``training.train_step``'s
``make_optimizer``), then runs ``train_step`` as fine-tuning does (bf16,
remat, SpecAugment, the plain attention): 2 warm-up steps, 3 timed
steps (host clock around ``torch.cuda.synchronize()``, split into
forward+backward and optimizer), then one step under ``torch.profiler``,
read from its Chrome trace (device activity only, as
``tools/profile_torch_fused.py`` reads it). Prints the step wall and
its split, device time by category and its share of the profiled
step's window, the device's idle share, the top kernels and the peak
memory.

Imports nothing of JAX or of the JAX package. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np
import torch

import profile_torch_fused as fused

# (category, substrings of the kernel name), first match wins.
CATEGORIES = (
    ("scatter/gather (bias)", ("scatter_gather",)),
    ("ctc", ("ctc",)),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("cast/copy", ("copy_kernel",)),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")),
    ("layer_norm", ("layer_norm",)),
    ("conv", ("conv",)),
    ("softmax/reduce", ("softmax", "reduce_kernel")),
    ("elementwise", ("elementwise",)),
)
SPAN = "train_step"
TIMED = 3
BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak (data sheet)


def category(event: dict) -> str:
    if event["cat"] != "kernel":
        return event["cat"]
    for cat, keys in CATEGORIES:
        if any(k in event["name"] for k in keys):
            return cat
    return "other"


def make_batch(seed: int, B: int, vocab_size: int, device) -> dict:
    from audio_processor_tpu_torch.dsp.fbank import max_num_frames

    rng = np.random.default_rng(seed)
    T = max_num_frames(25 * 16000) // 2
    valid = (rng.uniform(5.0, 25.0, B) * 50).astype(int).clip(max=T)
    valid[0] = T
    fmask = (np.arange(T)[None, :] < valid[:, None]).astype(np.float32)
    feats = rng.standard_normal((B, T, 160)).astype(np.float32) \
        * fmask[:, :, None]
    lens = valid // 5                                # ~10 labels a second
    N = int(lens.max())
    labels = rng.integers(5, vocab_size, (B, N))
    lmask = (np.arange(N)[None, :] < lens[:, None]).astype(np.float32)
    batch = {"features": feats, "feature_mask": fmask,
             "labels": labels * (lmask > 0), "label_mask": lmask}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs a CUDA device")
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.models.tokenizer import CTCVocab
    from audio_processor_tpu_torch.training import train_step as ts

    dev = torch.device("cuda")
    cfg = w2v.W2VBertConfig(vocab_size=len(CTCVocab.darija_default()))
    model = w2v.build_synthetic(cfg, dev, seed=args.seed).train()
    batch = make_batch(args.seed, args.batch, cfg.vocab_size, dev)
    state = ts.init_state(model, ts.make_optimizer())
    step = ts.make_train_step(dtype=torch.bfloat16, augment=ts.SpecAugment(),
                              augment_seed=args.seed + 1)
    n_params = sum(p.numel() for p in model.parameters())
    frames = int(batch["feature_mask"].sum())
    padded = batch["feature_mask"].numel()
    print(f"card: {torch.cuda.get_device_name(0)}; model {n_params / 1e6:.1f}"
          f" M params; batch {tuple(batch['features'].shape)}, {frames} "
          f"valid of {padded} frames, {batch['labels'].shape[1]} labels max",
          flush=True)

    for _ in range(2):
        state, loss = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(TIMED):
        times = {}
        state, loss = step(state, batch, times=times)
        walls.append((times["fwd_bwd_s"], times["opt_s"]))
        assert torch.isfinite(loss)
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.median([a + b for a, b in walls]))
    print(f"step wall ({TIMED} steps, host clock, synchronised): "
          f"forward+backward {[round(a, 4) for a, _ in walls]} s, optimizer "
          f"{[round(b, 4) for _, b in walls]} s; median {wall:.4f} s; "
          f"{frames / wall:.0f} valid frames/s; model FLOP share of bf16 "
          f"peak {6 * n_params * padded / wall / BF16_FLOPS:.4f}",
          flush=True)
    print(f"peak memory {peak / 2**30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            state, loss = step(state, batch)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
    b = fused.breakdown(trace, SPAN, category)
    win = b["window_ms"]
    print(f"profiled step: window {win:.1f} ms (host span start to last "
          f"device end), host enqueue {b['host_ms']:.1f} ms, device busy "
          f"{b['busy_ms']:.1f} ms, device idle share "
          f"{1 - b['busy_ms'] / win:.4f}")
    print(f"{'category':22s} {'ms':>9s} {'count':>6s} {'share':>7s}")
    total = 0.0
    for cat, (ms, n) in sorted(b["by_cat"].items(), key=lambda x: -x[1][0]):
        total += ms
        print(f"{cat:22s} {ms:9.2f} {n:6d} {ms / win:7.3f}")
    print(f"{'sum':22s} {total:9.2f}")
    print("top device kernels:")
    for name, (ms, n) in sorted(b["by_name"].items(),
                                key=lambda x: -x[1][0])[:15]:
        print(f"  {ms:9.2f} ms {n:5d}x  {name[:110]}")
    assert not any(m == "jax" or m.split(".")[0] == "audio_processor_tpu"
                   for m in sys.modules)
    return 0


if __name__ == "__main__":
    sys.exit(main())
