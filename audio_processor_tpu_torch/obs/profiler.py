"""Device tracing via torch.profiler (port of obs/profiler.py).

Enable with ``enable_profiling: true`` (+ ``profile_dir``, default
``<output_folder>/profile``) in the config, or wrap any region with
:func:`trace`. The trace records host and CUDA activity (kernel names
and device times) and is written as a Chrome trace JSON, viewable in
Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path
from typing import Iterator

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(profile_dir: str | Path) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed region into
    ``profile_dir/trace_<timestamp>.json``."""
    pdir = Path(profile_dir)
    pdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = pdir / f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json"
        prof.export_chrome_trace(str(path))
        logger.info("Profiler trace written to %s", path)


@contextlib.contextmanager
def maybe_trace(config) -> Iterator[None]:
    """Trace when the config asks for it; no-op otherwise."""
    if config.get("enable_profiling", False):
        pdir = config.get("profile_dir", "") or str(
            Path(config.get("output_folder", ".")) / "profile")
        with trace(pdir):
            yield
    else:
        yield


def annotate(name: str):
    """Named region for traces (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
