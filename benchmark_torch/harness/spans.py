"""Spans the benchmark records around calls into the program.

The program is not edited: :class:`Recorder` wraps named methods of its
classes for the run and puts them back afterwards. Each wrapped call adds a
span (layer name, host start and end on ``time.perf_counter``, thread).
Spans are kept in memory and read when the run ends.

While a trace is on, each wrapped call on a CUDA machine first makes one
``cudaStreamQuery`` (a runtime call the program itself never makes): the
profiler records it on the calling thread's timeline, which is how
:mod:`.trace` finds that thread among the runtime events and attributes the
kernels it launched inside the span to the span's layer.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Callable, List, Optional

import torch

RANGE_PREFIX = "bench."


class Recorder:
    def __init__(self):
        self.spans: List[tuple] = []       # (layer, t0, t1, thread id)
        self.on = False                     # record only in the window
        self.tracing = False                # mark spans for the trace
        self._lock = threading.Lock()
        self._undo: List[Callable] = []

    def wrap(self, owner, attr: str, layer: str,
             before: Optional[Callable] = None,
             after: Optional[Callable] = None) -> None:
        """Record ``owner.attr`` as a span of ``layer``. ``before(args,
        kwargs)`` runs first; ``after(result, args, kwargs, t0, t1)`` runs
        on the result (both only while recording)."""
        orig = getattr(owner, attr)
        rec = self

        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            if not rec.on:
                return orig(*args, **kwargs)
            if before is not None:
                before(args, kwargs)
            t0 = time.perf_counter()
            if rec.tracing:
                torch.cuda.current_stream().query()   # thread marker
            out = orig(*args, **kwargs)
            t1 = time.perf_counter()
            with rec._lock:
                rec.spans.append((layer, t0, t1, threading.get_ident()))
            if after is not None:
                after(out, args, kwargs, t0, t1)
            return out

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()

    def total(self, layer: str) -> float:
        return sum(t1 - t0 for name, t0, t1, _ in self.spans
                   if name == layer)

    def count(self, layer: str) -> int:
        return sum(1 for name, *_ in self.spans if name == layer)
