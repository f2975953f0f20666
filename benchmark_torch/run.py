#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 benchmark_torch/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

The cell, its configuration, traffic mix, per-layer metrics and limits are
found by name from ``BENCHMARK.json`` (see ``benchmark_torch/README.md``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every number compared with its limit,
which also end standard error.

Needs as many CUDA devices as the cell asks for; without them it exits with
code 3 and prints no result. It never runs on the CPU.
"""

import time

T_PROCESS = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def _caches() -> None:
    """Every compiler cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "audio_processor_tpu_torch").is_dir():
        print("benchmark: the program (audio_processor_tpu_torch/) is not in "
              "this checkout", file=sys.stderr)
        return 2
    _caches()
    sys.path.insert(0, str(ROOT))
    from benchmark_torch.harness.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: cell {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(spec, cell, seed: int, seconds: float, trace: bool,
             device: str, control: bool = False, overrides=None,
             keep_job: bool = False, mix_overrides=None) -> dict:
    """One run of ``cell``; ``overrides`` replace keys of the config's
    ``pipeline`` section (the control's ``quantization``). ``keep_job``
    returns the job under ``"job"`` too (its readings)."""
    import importlib

    from benchmark_torch.harness.job import Job

    config = spec.config(cell)
    if overrides:
        config = dict(config, pipeline=dict(config["pipeline"], **overrides))
    mix = dict(spec.mix(cell), **(mix_overrides or {}))
    gen = spec.generator(mix["kind"])
    driver = importlib.import_module(f"benchmark_torch.harness.{gen.DRIVER}")
    tmp = Path(tempfile.mkdtemp(prefix="bench-"))
    try:
        job = Job(
            name=cell["name"], config=config, mix=mix, generator=gen,
            limits=spec.limits(cell), end_to_end=spec.end_to_end(cell),
            per_layer=spec.per_layer(cell), seed=seed, seconds=seconds,
            trace=trace, device=device, tmp=tmp, t_process=T_PROCESS,
            control=control)
        result = driver.run(job)
        if keep_job:
            result["job"] = job
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
