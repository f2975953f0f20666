"""Spans of the batch pipeline, and device tracing via torch.profiler
(port of obs/profiler.py).

Tracing: ``enable_profiling: true`` (+ ``profile_dir``, default
``<output_folder>/profile``) in the config, or :func:`trace` around any
region, records host and CUDA activity (kernel names and device times,
every thread's ranges) and writes a Chrome trace JSON, viewable in
Perfetto or ``chrome://tracing``.

Spans: :func:`span` times a stage of the pipeline on the thread that runs
it, :func:`record` an interval that starts on one thread and ends on
another (a queue wait). Each span holds its name, start and end on
``time.perf_counter_ns()``, the native thread id (the ``tid`` that a
profiler which registers the thread gives its events) and the pthread id,
its own id, the id of the span that caused it, and small attributes. A
span opened with a parent, or inside another span on its thread, takes
the parent's ``batch`` attribute unless given one, so every span of a file
batch can be joined on it.

Spans are recorded only while a ``torch.profiler`` records in the process
or a :func:`recording_spans` scope is open (``enable_tracing: true``).
While a profiler records, each span also opens a ``record_function``
range of its name, so a trace shows the program's stages beside the
kernels. Recorded spans stay in a bounded buffer in memory
(:func:`spans`, :func:`clear`) until a report asks for them
(:func:`stage_summary`). Off, a span site costs the check of two module
flags and returns a shared null context.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)

MAX_SPANS = 1 << 16


class Span(NamedTuple):
    name: str
    t0: int                 # time.perf_counter_ns()
    t1: int
    tid: int                # threading.get_native_id()
    pthread: int            # threading.get_ident()
    id: int
    parent: Optional[int]   # id of the span that caused this one
    attrs: Dict[str, Any]


_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()
_scopes = 0                 # open recording_spans() scopes
_scopes_lock = threading.Lock()


class _Null:
    """The span of a site while nothing records: enters as None."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def recording() -> bool:
    return bool(_scopes or _autograd_profiler._is_profiler_enabled)


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _inherit(parent: Optional["_Open"], attrs: Dict[str, Any]) -> None:
    if parent is not None and "batch" not in attrs \
            and "batch" in parent.attrs:
        attrs["batch"] = parent.attrs["batch"]


class _Open:
    """A span being timed on its thread; ``t0``/``t1`` are set on enter
    and exit, so a caller can hand them to :func:`record`."""

    __slots__ = ("name", "attrs", "parent", "id", "t0", "t1", "_range")

    def __init__(self, name: str, parent: Optional["_Open"],
                 attrs: Dict[str, Any]):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.id = next(_ids)
        self.t0 = self.t1 = 0
        self._range = None

    def __enter__(self) -> "_Open":
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        _inherit(self.parent, self.attrs)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        self.t1 = time.perf_counter_ns()
        _stack().pop()
        _buffer.append(Span(
            self.name, self.t0, self.t1, threading.get_native_id(),
            threading.get_ident(), self.id,
            None if self.parent is None else self.parent.id, self.attrs))
        return False


def span(name: str, parent: Optional[_Open] = None, **attrs):
    """Time the enclosed block as span ``name``. ``parent`` is the span
    that caused it when that span runs on another thread (default: the
    innermost span open on this thread). ``with span(...) as sp``: ``sp``
    is None while nothing records."""
    if not (_scopes or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Open(name, parent, attrs)


def record(name: str, t0_ns: int, t1_ns: int,
           parent: Optional[_Open] = None, **attrs) -> None:
    """Record an interval timed elsewhere (from one thread to another),
    on the calling thread's ids."""
    if not (_scopes or _autograd_profiler._is_profiler_enabled):
        return
    _inherit(parent, attrs)
    _buffer.append(Span(name, int(t0_ns), int(t1_ns),
                        threading.get_native_id(), threading.get_ident(),
                        next(_ids), None if parent is None else parent.id,
                        attrs))


def current() -> Optional[_Open]:
    """The innermost span open on this thread (None while nothing
    records): the parent to hand to work another thread runs."""
    if not (_scopes or _autograd_profiler._is_profiler_enabled):
        return None
    stack = _stack()
    return stack[-1] if stack else None


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most ``MAX_SPANS``)."""
    return list(_buffer)


def clear() -> None:
    _buffer.clear()


@contextlib.contextmanager
def recording_spans(on: bool = True) -> Iterator[None]:
    """Record spans inside the block without a profiler
    (``enable_tracing: true``); a no-op when ``on`` is false."""
    global _scopes
    if not on:
        yield
        return
    with _scopes_lock:
        _scopes += 1
    try:
        yield
    finally:
        with _scopes_lock:
            _scopes -= 1


# ----------------------------------------------------------------------
CALL_STAGES = ("decode", "queue_device", "device_stage", "queue_analysis",
               "analysis")


def call_stages(recorded: List[Span]) -> List[Dict[str, Any]]:
    """Each recorded call's latency split by stage, in seconds: decode
    (from the call's own start to its batch's decode end), the wait for
    the device worker, the device stage, the wait for the analysis
    worker, and the analysis stage. Calls whose batch lacks a stage are
    left out."""
    by_batch: Dict[tuple, Dict[str, Span]] = {}
    for s in recorded:
        b = s.attrs.get("batch")
        if b is not None and s.name in _STAGE_OF:
            by_batch.setdefault(tuple(b), {})[_STAGE_OF[s.name]] = s
    out = []
    for c in recorded:
        if c.name != "engine.call":
            continue
        st = by_batch.get(tuple(c.attrs.get("batch") or ()), {})
        if len(st) < len(CALL_STAGES):
            continue
        row = {"call": c.attrs.get("call"), "batch": c.attrs.get("batch"),
               "latency": (c.t1 - c.t0) / 1e9,
               "decode": (st["decode"].t1 - c.t0) / 1e9}
        for k in CALL_STAGES[1:]:
            row[k] = (st[k].t1 - st[k].t0) / 1e9
        out.append(row)
    return out


_STAGE_OF = {"engine.decode": "decode",
             "engine.queue.device": "queue_device",
             "engine.device_stage": "device_stage",
             "engine.queue.analysis": "queue_analysis",
             "engine.analysis": "analysis"}


def _cover(intervals: List[tuple], lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def stage_summary(recorded: Optional[List[Span]] = None
                  ) -> Optional[Dict[str, Any]]:
    """The report's ``stages`` section (None when nothing was recorded):
    per span name its count, total and self seconds (the duration less
    what its children cover), and the per-call stage split at p50/p90."""
    recorded = spans() if recorded is None else recorded
    if not recorded:
        return None
    children: Dict[int, List[tuple]] = {}
    for s in recorded:
        if s.parent is not None:
            children.setdefault(s.parent, []).append((s.t0, s.t1))
    names: Dict[str, Dict[str, float]] = {}
    for s in recorded:
        d = names.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                      "self_s": 0.0})
        d["count"] += 1
        d["total_s"] += (s.t1 - s.t0) / 1e9
        d["self_s"] += (s.t1 - s.t0 - _cover(children.get(s.id, []),
                                             s.t0, s.t1)) / 1e9
    calls = call_stages(recorded)
    split = {}
    if calls:
        for k in ("latency",) + CALL_STAGES:
            v = np.array([c[k] for c in calls])
            split[k] = {"p50": float(np.percentile(v, 50)),
                        "p90": float(np.percentile(v, 90))}
    return {"spans": names, "calls": len(calls), "call_split_s": split}


# ----------------------------------------------------------------------
@contextlib.contextmanager
def trace(profile_dir: str | Path) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed region, every
    thread's ranges included, into ``profile_dir/trace_<timestamp>.json``."""
    pdir = Path(profile_dir)
    pdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
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
