"""Traffic kind ``batch_sweep_kimi``: the pool of :mod:`batch_sweep` (the
same mix parameters, files and decoding), swept by the Kimi-Linear driver
``harness/batch_kimi.py``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_traffic_batch_sweep", Path(__file__).with_name("batch_sweep.py"))
_pool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_pool)

DRIVER = "batch_kimi"
durations = _pool.durations
make_pool = _pool.make_pool
read_pcm = _pool.read_pcm
