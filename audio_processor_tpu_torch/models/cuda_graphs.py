"""CUDA graphs of a model's work on the card: the encoder's forward per
input shape (``models/wav2vec2bert.py``), the text decoder's step per
decode key (``models/seamless_s2t.py``) and the topic LM's decode step per
(rows, cache capacity) key (``models/moe_lm.py``).

A model owns one :class:`GraphCache`; :meth:`GraphCache.on` gives its
:class:`DeviceGraphs` on a device, all over one set of parameter storage
(:func:`storage_key`), so a weight put in other storage drops every
device's entries. A device's graphs share one memory pool and capture
stream: :meth:`DeviceGraphs.capture` records a function on the side stream
into the pool, and :meth:`DeviceGraphs.replay` replays a graph on the
current stream. Each replay adds the kernel-wrapper launches its capture
tallied (``_cuda_call.tally_launches``) to the wrappers' counts, since
nothing of the graph passes through the wrappers.
"""

from __future__ import annotations

import itertools
import logging
import threading
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn

from audio_processor_tpu_torch.models import _cuda_call

logger = logging.getLogger(__name__)


class Graph(NamedTuple):
    """A captured function: its graph, the static tensors each replay
    copies its inputs into, what the function returned (written again by
    each replay), and the kernel-wrapper launches (wrapper -> count) that
    each replay makes."""

    graph: Any
    inputs: tuple
    out: Any
    launches: Dict[Any, int]


def storage_key(module: nn.Module) -> tuple:
    """The storage of every parameter and buffer of ``module``. A tensor
    reassigned to other storage changes it; an in-place update does not,
    and a replay reads it."""
    return tuple(t.data_ptr() for t in itertools.chain(
        module.parameters(), module.buffers()))


class DeviceGraphs:
    """A model's graphs on one device and what they share: ``entries``
    (the model's own, by its own keys), one memory pool and capture stream
    (made by the first capture) and ``lock``. The graphs share the pool,
    so no two may run at once on the card: ``lock`` covers each capture
    and each replay with its copies in and out, and a replay on another
    stream than the last one first waits on the last one's event."""

    def __init__(self, device: torch.device):
        self.device = device
        self.entries: Dict[Any, Any] = {}
        self.lock = threading.Lock()
        self.pool = self.stream = None
        self.last = None                # (stream, event) of the last replay

    def capture(self, table: dict, key, fn: Callable[..., Any], what: str,
                like: Sequence[torch.Tensor] = ()) -> Optional[Graph]:
        """``table[key]``, filled here unless another thread filled it
        first: ``fn(*inputs)`` captured on the side stream into the pool,
        ``inputs`` new tensors shaped like ``like`` (:meth:`replay` copies
        its arguments into them). A capture that fails leaves None there,
        with one warning naming ``what``: that key runs eagerly."""
        with self.lock:
            if key not in table:
                table[key] = self._capture(fn, what, like)
            return table[key]

    def _capture(self, fn, what, like) -> Optional[Graph]:
        dev = self.device
        try:
            if self.stream is None:
                self.pool = torch.cuda.graph_pool_handle()
                self.stream = torch.cuda.Stream(dev)
            with torch.inference_mode(False):   # copied into at any mode
                inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=dev)
                               for t in like)
            cur = torch.cuda.current_stream(dev)
            self.stream.wait_stream(cur)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.device(dev), torch.cuda.stream(self.stream), \
                    _cuda_call.tally_launches() as launches:
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn(*inputs)
                finally:
                    graph.capture_end()
            cur.wait_stream(self.stream)
        except Exception:   # any failure leaves this key eager
            logger.warning("CUDA graph capture of %s on %s failed; it runs "
                           "eagerly", what, dev, exc_info=True)
            return None
        return Graph(graph, inputs, out, launches)

    def replay(self, g: Graph, *inputs: torch.Tensor
               ) -> Optional[torch.Tensor]:
        """Copy ``inputs`` into ``g``'s, replay it on the current stream
        and return a clone of its output (None where the captured function
        returned None), all under the lock; then add its launches to the
        wrappers'."""
        with self.lock:
            cur = torch.cuda.current_stream(self.device)
            if self.last is not None and self.last[0] != cur:
                cur.wait_event(self.last[1])
            for static, x in zip(g.inputs, inputs):
                static.copy_(x)
            g.graph.replay()
            out = None if g.out is None else g.out.clone()
            done = torch.cuda.Event()
            done.record(cur)
            self.last = (cur, done)
        for wrapper, n in g.launches.items():
            wrapper.launches += n
        return out


class GraphCache:
    """A model's :class:`DeviceGraphs` per device, all over one set of
    parameter storage: :meth:`on` with other storage drops them. A copy or
    pickle of the model starts with an empty cache."""

    def __init__(self):
        self.ptrs: Optional[tuple] = None
        self.devices: Dict[torch.device, DeviceGraphs] = {}
        self.lock = threading.Lock()

    def __reduce__(self):
        return (GraphCache, ())

    def on(self, device: torch.device, ptrs: tuple) -> DeviceGraphs:
        """The graphs on ``device`` over the storage ``ptrs``
        (:func:`storage_key`)."""
        with self.lock:
            if ptrs != self.ptrs:
                self.ptrs, self.devices = ptrs, {}
            dg = self.devices.get(device)
            if dg is None:
                dg = self.devices[device] = DeviceGraphs(device)
            return dg
