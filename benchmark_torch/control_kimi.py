#!/usr/bin/env python3
"""Readings that set the Kimi-Linear cell's correctness limits, on the card,
in one process (set-up is paid once for the build, then per seed).

    python3 benchmark_torch/control_kimi.py --seeds <s1,s2,...> \\
        --control-seeds <c1,c2,...> [--controls bf16_state,skip_decay] \\
        [--seconds 1] [--out control_kimi.json]

For each of ``--seeds`` it runs the cell ``kimi.calls3m-pcm16k`` as the
benchmark does (one short window) and keeps every number compared. For
each control of ``--controls`` and each of ``--control-seeds`` it runs the
program with that control switched on (``harness/batch_kimi.py``:
``bf16_state`` holds the KDA state in bf16 between the prefill's chunks
and between decode steps, ``skip_decay`` gives the prefill a state pass
that skips the decay of each row's last chunk).
``limits/kimi.calls3m-pcm16k.json`` is set between the largest sound
reading and the smallest reading of each control, as PERF.md records.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELL = "kimi.calls3m-pcm16k"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="bf16_state,skip_decay")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control_kimi: needs a CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "benchmark_torch"))
    import run as bench_run
    from benchmark_torch.harness.spec import Spec

    bench_run._caches()
    spec = Spec(ROOT)
    cell = spec.cell(CELL)
    controls = [c for c in args.controls.split(",") if c]
    plan = [(int(s), None) for s in args.seeds.split(",") if s] + [
        (int(s), c) for c in controls
        for s in args.control_seeds.split(",") if s]
    out = {"cell": CELL, "program": [], **{c: [] for c in controls}}
    for seed, control in plan:
        t0 = time.perf_counter()
        res = bench_run.run_cell(
            spec, cell, seed, args.seconds, False, "cuda",
            control=control is not None, keep_job=True,
            mix_overrides={"control": control} if control else None)
        job = res.pop("job")
        row = {"seed": seed, "control": control, "correct": res["correct"],
               "checks": {k: v["value"] for k, v in res["checks"].items()},
               "readings": job.readings,
               "memory_peak_bytes": res["device"]["memory_peak_bytes"],
               "seconds": time.perf_counter() - t0}
        out[control or "program"].append(row)
        print(json.dumps(row), flush=True)
    for side in ["program", *controls]:
        rows = out[side]
        if not rows:
            continue
        keys = sorted({k for r in rows for k in r["checks"]}
                      | {k for r in rows for k in r["readings"]})
        for k in keys:
            vals = [r["checks"].get(k, r["readings"].get(k)) for r in rows]
            vals = [v for v in vals if v is not None]
            if vals:
                print(f"{side} {k}: min {min(vals)!r} max {max(vals)!r} "
                      f"over {len(vals)} seeds", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
