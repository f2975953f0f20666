"""One run of one cell, as the drivers receive it."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple


@dataclass
class Job:
    name: str
    config: Dict
    mix: Dict
    generator: ModuleType
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Tuple[Dict, ModuleType]]
    seed: int
    seconds: float
    trace: bool
    device: str
    tmp: Path
    t_process: float
    control: bool = False
    readings: Dict[str, float] = field(default_factory=dict)
    marks: List[Tuple[str, float]] = field(default_factory=list)

    def mark(self, phase: str) -> None:
        """End of a set-up phase, on the host clock."""
        import time

        self.marks.append((phase, time.perf_counter()))

    def phases(self) -> str:
        """Set-up phases as 'name seconds' from the process's start."""
        out, t = [], self.t_process
        for name, t1 in self.marks:
            out.append(f"{name} {t1 - t:.3f}")
            t = t1
        return ", ".join(out)

    def say(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)
