#!/usr/bin/env python3
"""Readings that set a cell's correctness limits, on the card, in one
process (set-up is paid once for the build, then per seed).

    python3 benchmark_torch/control.py --workload <cell> \\
        --seeds <s1,s2,...> --control-seeds <c1,c2,c3> [--seconds 1] \\
        [--out chiprun_out/control.json]

For each of ``--seeds`` it runs the cell as the benchmark does (one short
window) and keeps every number compared. For each of ``--control-seeds`` it
runs the control: the program with its own lower-precision path switched on
(``quantization: int8``, the step below the configured bf16), and the
acoustic features of the reference computed in bfloat16 in place of the
program's fp32. ``limits/<cell>.json`` is set from the largest sound
reading and the smallest control reading, as PERF.md records.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "benchmark_torch"))
    import run as bench_run
    from benchmark_torch.harness.spec import Spec

    bench_run._caches()
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    out = {"cell": cell["name"], "program": [], "control": []}
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        t0 = time.perf_counter()
        res = bench_run.run_cell(
            spec, cell, seed, args.seconds, False, "cuda", control=control,
            overrides={"quantization": "int8"} if control else None,
            keep_job=True)
        job = res.pop("job")
        row = {"seed": seed, "correct": res["correct"],
               "checks": {k: v["value"] for k, v in res["checks"].items()},
               "readings": job.readings,
               "seconds": time.perf_counter() - t0}
        out["control" if control else "program"].append(row)
        print(json.dumps(row), flush=True)
    for side in ("program", "control"):
        rows = out[side]
        if not rows:
            continue
        keys = sorted({k for r in rows for k in r["checks"]}
                      | {k for r in rows for k in r["readings"]})
        for k in keys:
            vals = [r["checks"].get(k, r["readings"].get(k)) for r in rows]
            vals = [v for v in vals if v is not None]
            print(f"{side} {k}: min {min(vals)!r} max {max(vals)!r} "
                  f"over {len(vals)} seeds", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
