"""Calling a kernel of ``csrc/`` through its plain C interface.

Every ``csrc/<name>.cu`` exports ``int <name>_fwd(..., void* stream)``,
which returns the launch's cudaError_t (0: launched), and
``const char* <name>_error(int)``. :func:`call` builds and loads the
library on first use (``_build``), launches on the tensors' device and
current stream, and raises on a non-zero code; :func:`check_operands`
checks what every such interface assumes of the tensors it is handed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audio_processor_tpu_torch import _build

# One letter per argument of ``<name>_fwd`` before the stream.
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


@functools.lru_cache(maxsize=None)
def _entry(name: str, signature: str):
    lib = _build.load(name)
    fwd = getattr(lib, f"{name}_fwd")
    fwd.argtypes = [_CTYPES[c] for c in signature] + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    error = getattr(lib, f"{name}_error")
    error.argtypes = [ctypes.c_int]
    error.restype = ctypes.c_char_p
    return fwd, error


def check_operands(q: torch.Tensor, named) -> None:
    """Raise ValueError unless every (name, tensor) of ``named`` lies on
    q's device, is contiguous and starts 16-byte aligned (the kernels
    compute offsets from dense strides and use vector loads), and q's
    B*H fits the launch grid's y dimension."""
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    B, H = q.shape[:2]
    if B * H > 65535:
        raise ValueError(f"B*H={B * H} exceeds the kernel's grid limit")


def call(name: str, signature: str, device: torch.device, *args,
         label: str = "") -> None:
    """Launch ``<name>_fwd(*args, stream)`` on ``device``'s current
    stream; ``signature`` has one letter per arg (p pointer, i int, f
    float). Raises RuntimeError, naming ``label`` (default ``name``), if
    the launch returns an error."""
    fwd, error = _entry(name, signature)
    with torch.cuda.device(device):
        rc = fwd(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{label or name} launch failed: cudaError {rc} "
                           f"({error(rc).decode()})")
