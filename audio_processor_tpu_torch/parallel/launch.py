"""Start a group of rank processes and wait for them, bounded in time.

A collective waits for every rank, so one rank that dies or hangs stalls
the rest: :func:`run_ranks` starts all ranks at once, waits for them
against one deadline, and kills every rank still running when it passes
or when any rank fails, so no process outlives the call.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence


def rank_env(rank: int, world: int, extra: Optional[dict] = None) -> dict:
    """The environment of rank ``rank`` of ``world`` on this host
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``)."""
    env = dict(os.environ)
    env.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)})
    env.update(extra or {})
    return env


def run_ranks(argv: Callable[[int], Sequence[str]], world: int,
              timeout_s: float, env: Optional[Callable[[int], dict]] = None,
              cwd: Optional[str] = None) -> List[str]:
    """Run ``argv(rank)`` for every rank at once, each with
    ``env(rank)`` (default :func:`rank_env`), and return their standard
    outputs. Raises RuntimeError with the failing ranks' output tails if
    a rank exits non-zero, TimeoutError past ``timeout_s``; either way
    every rank still running is killed first."""
    env = env or (lambda r: rank_env(r, world))
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(2 * world)]
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                list(argv(r)), cwd=cwd, env=env(r), stdout=logs[2 * r],
                stderr=logs[2 * r + 1], text=True))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    stdout, stderr = outs[0::2], outs[1::2]
    timed_out = any(p.returncode < 0 for p in procs) and not any(
        p.returncode > 0 for p in procs)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = "\n".join(
            f"--- rank {r} (rc {procs[r].returncode}):\n"
            f"{stdout[r][-2000:]}\n{stderr[r][-4000:]}" for r in bad)
        if timed_out:
            raise TimeoutError(f"ranks {bad} killed after {timeout_s} s\n"
                               f"{tails}")
        raise RuntimeError(f"ranks {bad} failed\n{tails}")
    return stdout


def python_argv(module_or_code: str, *args: str,
                module: bool = True) -> List[str]:
    """``python -m module args`` (or ``python -c code args``)."""
    return [sys.executable, "-m" if module else "-c", module_or_code,
            *map(str, args)]


def file_init_method(directory) -> str:
    """A ``file://`` rendezvous in ``directory`` (no port to collide)."""
    path = Path(directory) / "pg"
    if path.exists():
        path.unlink()
    return path.resolve().as_uri()
