"""Reduction of one ``torch.profiler`` Chrome trace to device numbers.

The arithmetic is the port's device-time profiler's (device events only:
kernels, copies and sets; busy time is the union of their intervals, so
overlapping streams are not counted twice), extended with attribution to
the benchmark's spans (:mod:`.spans`): a span's host times are moved onto
the trace's clock through the ``bench.window`` range, its thread is found
by the ``cudaStreamQuery`` marker it made at its start, and the kernels,
copies and sets that thread launched inside the span are the span's,
matched to the device by the profiler's correlation id.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from .spans import RANGE_PREFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "cudaStreamQuery"
WINDOW = RANGE_PREFIX + "window"
MARKER_SLACK_US = 2000.0


class Trace:
    """Device events of one traced window, in microseconds of the trace's
    clock. ``spans`` are the run's (layer, t0, t1, thread) on the host
    clock and ``host_t0`` the host time at which the window range opened."""

    def __init__(self, events: List[dict], spans=(), host_t0: float = 0.0):
        xs = [e for e in events if e.get("ph") == "X"]
        win = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise ValueError("trace has no window range")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        off = self.t0 - host_t0 * 1e6
        self.spans = [(name, a * 1e6 + off, b * 1e6 + off)
                      for name, a, b, _ in spans
                      if self.t0 <= a * 1e6 + off <= self.t1]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS
                       and self.t0 <= float(e["ts"]) < self.t1]
        self.launches = [e for e in xs if e.get("cat") in LAUNCH_CATS
                         and self.t0 <= float(e["ts"]) <= self.t1]
        self.markers = sorted((float(e["ts"]), e["tid"])
                              for e in self.launches
                              if e.get("name") == MARKER)

    @classmethod
    def load(cls, path: Path, spans=(), host_t0: float = 0.0) -> "Trace":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f)["traceEvents"], spans, host_t0)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def intervals(self) -> List[Tuple[float, float]]:
        return union((float(e["ts"]),
                      min(float(e["ts"]) + float(e["dur"]), self.t1))
                     for e in self.device)

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.intervals()) / 1e6

    def kernel_s(self, substring: str) -> Tuple[float, int]:
        """Seconds and launches of kernels whose name holds ``substring``."""
        ks = [e for e in self.device if e.get("cat") == "kernel"
              and substring in e["name"]]
        return sum(float(e["dur"]) for e in ks) / 1e6, len(ks)

    def _thread_of(self, ts: float):
        """The runtime thread of the marker nearest to ``ts``."""
        i = bisect.bisect_left(self.markers, (ts, -1))
        best = None
        for j in (i - 1, i):
            if 0 <= j < len(self.markers):
                d = abs(self.markers[j][0] - ts)
                if d <= MARKER_SLACK_US and (best is None or d < best[0]):
                    best = (d, self.markers[j][1])
        return None if best is None else best[1]

    def span_device_s(self, layer: str) -> Tuple[float, int]:
        """Device seconds of the work launched inside the spans of
        ``layer`` by their own threads, and how many spans were found."""
        by_tid: Dict = {}
        n = 0
        for name, a, b in self.spans:
            if name != layer:
                continue
            tid = self._thread_of(a)
            if tid is None:
                continue
            by_tid.setdefault(tid, []).append((a, b))
            n += 1
        corr = set()
        for e in self.launches:
            spans = by_tid.get(e["tid"])
            c = (e.get("args") or {}).get("correlation")
            if spans is None or c is None:
                continue
            ts = float(e["ts"])
            if any(lo <= ts <= hi for lo, hi in spans):
                corr.add(c)
        dev = sum(float(e["dur"]) for e in self.device
                  if (e.get("args") or {}).get("correlation") in corr)
        return dev / 1e6, n

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + float(e["dur"]) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])][:n]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time in the window, by the benchmark spans open on
        the host at the middle of each gap (``idle: none`` when none)."""
        gaps, end = [], self.t0
        for lo, hi in self.intervals():
            if lo > end:
                gaps.append((end, lo))
            end = max(end, hi)
        if self.t1 > end:
            gaps.append((end, self.t1))
        by: Dict[str, float] = {}
        for lo, hi in gaps:
            mid = 0.5 * (lo + hi)
            open_ = sorted({name for name, a, b in self.spans
                            if a <= mid <= b})
            key = "idle: " + ("+".join(open_) if open_ else "none")
            by[key] = by.get(key, 0.0) + (hi - lo) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])][:n]


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[list] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]

