"""Device and system probes (port of utils/system.py).

The device probes read the CUDA device through torch, on the port's one
device-memory reader (:func:`obs.monitor.device_memory_stats`);
``get_system_stats`` and ``pad_chunk_waveforms`` are the reference's,
copied. The reference's ``enable_compilation_cache`` has no
counterpart: eager PyTorch compiles no program, and the port's only
compiled artefacts, its CUDA kernels and native I/O library, are cached
by ``_build.py`` under names hashed from their sources.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from audio_processor_tpu_torch.obs.monitor import device_memory_stats


def check_device_availability(device_index: int = 0) -> Tuple[bool, str]:
    """CUDA device availability (reference contract: utils/utils.py:14-26
    ``check_gpu_availability``)."""
    if not torch.cuda.is_available():
        return False, "No CUDA device available (torch.cuda.is_available() " \
                      "is False)"
    n = torch.cuda.device_count()
    if device_index >= n:
        return False, (f"Device index {device_index} not available "
                       f"(only {n} devices found)")
    return True, (f"Device {device_index}: "
                  f"{torch.cuda.get_device_name(device_index)}")


def get_device_memory_usage(device_index: int = 0) -> Optional[float]:
    """Percent of one CUDA device's memory held by torch's allocator
    (replaces get_gpu_memory_usage); None without that device."""
    stats = device_memory_stats(f"cuda:{device_index}")
    if not stats:
        return None
    used, limit = stats[0]["bytes_in_use"], stats[0]["bytes_limit"]
    if used is None or not limit:
        return None
    return 100.0 * used / limit


def get_system_stats() -> dict:
    """CPU/RAM/disk snapshot (reference: utils/utils.py:36-54)."""
    stats = {}
    try:
        import psutil

        stats["cpu_percent"] = psutil.cpu_percent(interval=0.1)
        vm = psutil.virtual_memory()
        stats["memory_percent"] = vm.percent
        stats["memory_available_gb"] = vm.available / 1024 ** 3
        stats["disk_free_gb"] = psutil.disk_usage("/").free / 1024 ** 3
    except ImportError:
        pass
    dev = get_device_memory_usage()
    if dev is not None:
        stats["device_memory_percent"] = dev
    return stats


def pad_chunk_waveforms(waveforms: List[np.ndarray]) -> np.ndarray:
    """Right-pad [C, T_i] waveforms to a dense stack (reference:
    utils/utils.py:56-72)."""
    if not waveforms:
        return np.empty((0,))
    max_len = max(w.shape[-1] for w in waveforms)
    out = []
    for w in waveforms:
        pad = max_len - w.shape[-1]
        if pad:
            w = np.pad(w, [(0, 0)] * (w.ndim - 1) + [(0, pad)])
        out.append(w)
    return np.stack(out)


# Reference-name aliases (utils/utils.py:14-34) so imports migrate
# drop-in.
check_gpu_availability = check_device_availability
get_gpu_memory_usage = get_device_memory_usage
