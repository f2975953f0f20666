"""Calling a kernel of ``csrc/`` through its plain C interface.

Every ``csrc/<name>.cu`` exports ``int <name>_fwd(..., void* stream)``
(or several such entries, ``<name>_<part>_fwd``), which returns the
launch's cudaError_t (0: launched), and ``const char* <name>_error(int)``.
:func:`call` builds and loads the library on first use (``_build``),
launches on the tensors' device and current stream, and raises on a
non-zero code; :func:`check_tensors`
checks what every such interface assumes of the tensors it is handed;
:func:`count_launch` counts a wrapper's launches, or, while the thread
captures a CUDA graph, the capture's (:func:`tally_launches`), and
:func:`counted` runs a function and returns the launches it made.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from audio_processor_tpu_torch import _build

# One letter per argument of ``<name>_fwd`` before the stream.
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "l": ctypes.c_longlong}
_local = threading.local()


@functools.lru_cache(maxsize=None)
def _entry(name: str, signature: str, entry: str):
    lib = _build.load(name)
    fwd = getattr(lib, f"{entry}_fwd")
    fwd.argtypes = [_CTYPES[c] for c in signature] + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    error = getattr(lib, f"{name}_error")
    error.argtypes = [ctypes.c_int]
    error.restype = ctypes.c_char_p
    return fwd, error


def refuse_autograd(name: str, *tensors) -> None:
    """Raise RuntimeError when autograd is recording and any of
    ``tensors`` (None allowed) requires grad. The kernels of ``csrc/``
    write into fresh outputs through their C interface, so an output
    would have no ``grad_fn`` and the operands would silently get no
    gradient. Wrappers call this before choosing between the kernel and
    the plain version, so the CPU behaves as the card does."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an operand requires grad while "
            "autograd is recording. Training runs attention_impl=\"xla\", "
            "as the JAX train step does; run inference under "
            "torch.inference_mode() or torch.no_grad().")


def check_tensors(device: torch.device, named) -> None:
    """Raise ValueError unless every (name, tensor) of ``named`` lies on
    ``device``, is contiguous and starts 16-byte aligned (the kernels
    compute offsets from dense strides and use vector loads)."""
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, not on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def check_operands(q: torch.Tensor, named) -> None:
    """:func:`check_tensors` on q's device, and q's B*H fits the
    attention kernels' launch grid's y dimension."""
    check_tensors(q.device, named)
    B, H = q.shape[:2]
    if B * H > 65535:
        raise ValueError(f"B*H={B * H} exceeds the kernel's grid limit")


def call(name: str, signature: str, device: torch.device, *args,
         label: str = "", entry: str = "") -> None:
    """Launch ``<entry>_fwd(*args, stream)`` of ``csrc/<name>.cu``
    (``entry`` defaults to ``name``) on ``device``'s current stream;
    ``signature`` has one letter per arg (p pointer, i int, l 64-bit int,
    f float). Raises RuntimeError, naming ``label`` (default the entry),
    if the launch returns an error."""
    entry = entry or name
    fwd, error = _entry(name, signature, entry)
    with torch.cuda.device(device):
        rc = fwd(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{label or entry} launch failed: cudaError {rc} "
                           f"({error(rc).decode()})")


def count_launch(wrapper, n: int = 1) -> None:
    """Add ``n`` to ``wrapper.launches``; while this thread captures a
    CUDA graph (:func:`tally_launches`), to the capture's tally instead,
    since nothing runs until the graph is replayed."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        wrapper.launches += n
    else:
        tally[wrapper] = tally.get(wrapper, 0) + n


@contextlib.contextmanager
def tally_launches() -> Iterator[Dict]:
    """Inside the block, this thread's :func:`count_launch` calls fill the
    yielded {wrapper: launches} instead of the wrappers' counters (or of
    an enclosing block's tally, which is restored after)."""
    prev = getattr(_local, "tally", None)
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        _local.tally = prev


def counted(fn: Callable[..., Any], *args) -> Tuple[Any, Dict]:
    """``fn(*args)`` run now, and the {wrapper: launches} it made on this
    thread, which are counted as :func:`count_launch` counts."""
    with tally_launches() as launched:
        out = fn(*args)
    for wrapper, n in launched.items():
        count_launch(wrapper, n)
    return out, launched
