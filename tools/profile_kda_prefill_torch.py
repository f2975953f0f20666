#!/usr/bin/env python3
"""Card time of one KDA layer's prefill (``models/kda.py``: the projections
and the prefill kernel, ``csrc/kda_prefill.cu``) at Kimi-Linear-48B-A3B's
widths (hidden 2,304, 32 heads of 128, conv 4,
bf16 stand-in weights) over the topics mix's prompt shapes.

    python3 tools/profile_kda_prefill_torch.py [--rows 8] [--lengths 1270,3960]

For each prompt length: ms per layer prefill (CUDA events over repeats)
and the card's time by kernel in one ``torch.profiler`` window, the
largest first, with the peak memory the prefill adds. One JSON line per
length. Runs only on a CUDA device.
"""

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from audio_processor_tpu_torch.models import kda  # noqa: E402


def layer(dev):
    cfg = SimpleNamespace(kda_num_heads=32, kda_head_dim=128,
                          kda_conv_size=4, hidden_size=2304,
                          rms_norm_eps=1e-5)
    m = kda.KimiDeltaAttention(cfg).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for name, p in m.named_parameters():
            kda.stand_in(name, p, gen)
    m = m.to(torch.bfloat16).eval().requires_grad_(False)
    for name in ("A_log", "dt_bias"):
        getattr(m, name).data = getattr(m, name).data.float()
    return m


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--lengths", default="1270,3960")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_kda_prefill_torch: needs a CUDA device",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    m = layer(dev)
    R = args.rows
    for L in (int(v) for v in args.lengths.split(",")):
        lens = [L - 37 * r for r in range(R)]
        rows, s = [], 0
        for n in lens:
            rows.append((s, n))
            s += n
        x = torch.randn(s, 2304, device=dev).to(torch.bfloat16)
        st = torch.zeros(R, 32, 128, 128, device=dev)
        cv = torch.zeros(R, 3, 3 * 4096, device=dev, dtype=torch.bfloat16)

        def run():
            with torch.inference_mode():
                m.prefill(x, rows, st, cv)

        run()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(args.reps):
            run()
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / args.reps
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        by = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            if t > 0:
                by[e.key[:90]] = (t / 1e3, e.count)
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:14]
        print(json.dumps({"rows": R, "length": L, "tokens": s,
                          "ms_per_layer": ms, "peak_extra_gb": peak / 1e9,
                          "top_ms": [[k, round(v[0], 3), v[1]]
                                     for k, v in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
