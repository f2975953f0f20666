#!/usr/bin/env python3
"""Find the highest rate the server sustains, once, on the card: run a
serving cell at each offered rate in one process and print, per rate, the
95th-percentile latency of all requests and of the first and last thirds
of the schedule (a last third far above the first is a backlog that grows
through the run), and the requests that failed.

    python3 benchmark_torch/sweep_rate.py --workload serve.prod-poisson \\
        --rates 2,4,6,8 [--seconds 20] [--seed N]

The knee is the highest rate whose backlog does not grow; the cell's mix
file then states 0.8 of it as ``rate_per_s``.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sweep_rate: needs a CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "benchmark_torch"))
    import run as bench_run
    from benchmark_torch.harness.spec import Spec

    bench_run._caches()
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    for rate in [float(r) for r in args.rates.split(",")]:
        res = bench_run.run_cell(spec, cell, args.seed, args.seconds, False,
                                 "cuda", keep_job=True,
                                 mix_overrides={"rate_per_s": rate})
        rd = res.pop("job").readings
        print(json.dumps({"rate_per_s": rate, "attempted": res["attempted"],
                          "failed": res["failed"],
                          "correct": res["correct"],
                          "p95_s": rd.get("request_latency_p95_s"),
                          "p95_first_third_s": rd.get("latency_first_third_s"),
                          "p95_last_third_s": rd.get("latency_last_third_s")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
