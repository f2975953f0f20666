"""Performance monitoring (port of obs/monitor.py).

Daemon thread sampling host RAM/CPU, device memory (torch's CUDA
allocator's and the device's memory counters for the processor's device) and
registered callbacks (queue depths), with throughput computation
(files/h, audio-hours/h), bounded histories, JSON reports, and the
advisory batch/worker tuners. :func:`device_memory_stats` reads torch's
memory counters where the reference reads the JAX devices'; the report
gains a ``stages`` section (obs/profiler.stage_summary) when spans were
recorded.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from audio_processor_tpu_torch.obs import profiler

logger = logging.getLogger(__name__)


@dataclass
class ProcessingMetrics:
    files_processed: int = 0
    audio_seconds_processed: float = 0.0
    start_time: Optional[float] = None

    def calculate_throughput(self) -> Dict[str, float]:
        if not self.start_time:
            return {"files_per_hour": 0.0, "audio_hours_per_hour": 0.0}
        elapsed_h = max(1e-9, (time.time() - self.start_time) / 3600.0)
        return {
            "files_per_hour": self.files_processed / elapsed_h,
            "audio_hours_per_hour":
                self.audio_seconds_processed / 3600.0 / elapsed_h,
        }


def device_memory_stats(device=None) -> List[Dict[str, Any]]:
    """Memory of one CUDA device (``device``, default the current one):
    the allocator's bytes in use and the device's total memory, as
    ``bytes_in_use`` / ``bytes_limit``. Empty without CUDA or for a CPU
    device."""
    out = []
    try:
        import torch

        if not torch.cuda.is_available():
            return out
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda":
            return out
        free, total = torch.cuda.mem_get_info(dev)
        stats = torch.cuda.memory_stats(dev)
        out.append({
            "device": f"{dev} ({torch.cuda.get_device_name(dev)})",
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "bytes_limit": total,
            "bytes_free": free,
        })
    except Exception as e:  # pragma: no cover
        logger.debug("device memory stats unavailable: %s", e)
    return out


class PerformanceMonitor:
    def __init__(self, config, interval_sec: float = 1.0, device=None):
        self.config = config
        self.device = device
        self.interval = interval_sec
        self.metrics = ProcessingMetrics()
        self.memory_history: deque = deque(maxlen=1000)
        self.device_memory_history: deque = deque(maxlen=1000)
        self.batch_metrics: deque = deque(maxlen=1000)
        self.file_times: deque = deque(maxlen=1000)
        self.callback_history: deque = deque(maxlen=1000)
        self.peaks: Dict[str, float] = {"memory_percent": 0.0}
        self._callbacks: Dict[str, Callable[[], Any]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # RLock: save_performance_report holds it while calling
        # get_performance_summary.
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    def add_callback(self, name: str, fn: Callable[[], Any]) -> None:
        self._callbacks[name] = fn

    def start_monitoring(self) -> None:
        if self._thread is not None:
            return
        self.metrics.start_time = time.time()
        self._stop.clear()
        self._thread = threading.Thread(target=self._monitor_resources,
                                        daemon=True)
        self._thread.start()
        logger.info("Performance monitoring started")

    def stop_monitoring(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        logger.info("Performance monitoring stopped")

    # Device memory sampling throttle: memory_stats() can be a slow
    # RPC on tunneled TPU transports; sample it sparsely and disable
    # it entirely when a probe exceeds _DEVICE_SAMPLE_BUDGET seconds.
    _DEVICE_SAMPLE_EVERY = 10.0
    _DEVICE_SAMPLE_BUDGET = 0.5

    def _monitor_resources(self) -> None:
        device_sampling = True
        last_device_sample = 0.0
        while not self._stop.wait(self.interval):
            try:
                # All potentially-slow probes run OUTSIDE the lock so
                # report writers never block behind an RPC.
                sample: Dict[str, Any] = {"ts": time.time()}
                try:
                    import psutil

                    vm = psutil.virtual_memory()
                    sample["memory_percent"] = vm.percent
                    sample["memory_used_gb"] = vm.used / 1024 ** 3
                    self.peaks["memory_percent"] = max(
                        self.peaks["memory_percent"], vm.percent)
                except ImportError:
                    pass

                dev_sample = None
                now = time.time()
                if device_sampling and \
                        now - last_device_sample >= self._DEVICE_SAMPLE_EVERY:
                    t0 = time.time()
                    dev_sample = {
                        "ts": now,
                        "devices": device_memory_stats(self.device)}
                    last_device_sample = now
                    if time.time() - t0 > self._DEVICE_SAMPLE_BUDGET:
                        logger.info("device memory sampling is slow on "
                                    "this transport - disabling")
                        device_sampling = False

                cb = {"ts": sample["ts"]}
                for name, fn in self._callbacks.items():
                    try:
                        cb[name] = fn()
                    except Exception as e:
                        cb[name] = f"error: {e}"

                with self._lock:
                    self.memory_history.append(sample)
                    if dev_sample is not None:
                        self.device_memory_history.append(dev_sample)
                    self.callback_history.append(cb)
            except Exception as e:  # pragma: no cover
                logger.debug("monitor sample failed: %s", e)

    # ------------------------------------------------------------------
    def record_batch(self, batch_id: int, num_files: int,
                     num_chunks: int, seconds: float,
                     audio_seconds: float) -> None:
        with self._lock:
            self.batch_metrics.append({
                "batch_id": batch_id, "files": num_files,
                "chunks": num_chunks, "seconds": seconds,
                "audio_seconds": audio_seconds})
            self.metrics.files_processed += num_files
            self.metrics.audio_seconds_processed += audio_seconds

    def record_file(self, name: str, seconds: float) -> None:
        with self._lock:
            self.file_times.append({"file": name, "seconds": seconds})

    # ------------------------------------------------------------------
    def get_performance_summary(self) -> Dict[str, Any]:
        with self._lock:
            mem = [m.get("memory_percent", 0.0)
                   for m in self.memory_history]
            batches = list(self.batch_metrics)
        throughput = self.metrics.calculate_throughput()
        avg_batch = (sum(b["seconds"] for b in batches) / len(batches)
                     if batches else 0.0)
        return {
            "throughput": throughput,
            "avg_memory_percent": sum(mem) / len(mem) if mem else 0.0,
            "peak_memory_percent": self.peaks["memory_percent"],
            "avg_batch_seconds": avg_batch,
            "batches_recorded": len(batches),
            "files_processed": self.metrics.files_processed,
        }

    def save_performance_report(self, output_dir: str | Path) -> Path:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        path = output_dir / f"performance_report_{ts}.json"
        with self._lock:
            report = {
                "summary": self.get_performance_summary(),
                "memory_history": list(self.memory_history),
                "device_memory_history": list(self.device_memory_history),
                "batch_metrics": list(self.batch_metrics),
                "file_times": list(self.file_times),
                "callbacks": list(self.callback_history),
            }
        stages = profiler.stage_summary()
        if stages is not None:
            report["stages"] = stages
        path.write_text(json.dumps(report, indent=2, default=str))
        logger.info("Performance report written to %s", path)
        return path

    # ------------------------------------------------------------------
    def optimize_batch_size(self, current: int,
                            target_batch_seconds: float = 30.0) -> int:
        """Advisory tuner (reference: performance_monitor.py:272-288)."""
        with self._lock:
            batches = list(self.batch_metrics)[-10:]
        if not batches:
            return current
        avg = sum(b["seconds"] for b in batches) / len(batches)
        if avg > target_batch_seconds * 1.2:
            return max(1, current // 2)
        if avg < target_batch_seconds * 0.5:
            return min(int(self.config.get("max_auto_batch_size", 64)),
                       current * 2)
        return current

    def optimize_worker_count(self, current: int) -> int:
        try:
            import psutil

            if psutil.virtual_memory().percent > 85:
                return max(1, current - 2)
            if psutil.cpu_percent(interval=0.1) < 50:
                return min(int(self.config.get("max_workers", 32)),
                           current + 2)
        except ImportError:
            pass
        return current
