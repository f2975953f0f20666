"""Multi-device scale-out of the inference pipeline (port of
parallel/multi_device.py).

The reference runs one SPMD program whose chunk batch shards over the
mesh's 'data' axis. Here one process keeps a model replica per 'data'
device: the ASR engine built with this manager's mesh splits each padded
device batch into equal slices, runs each on its replica and concatenates
the rows on the host (pipeline/asr_engine.py). Across processes, each
process runs the calls it owns (parallel/distributed.py ``owns_call``).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from audio_processor_tpu_torch.parallel.mesh import Mesh, make_mesh

logger = logging.getLogger(__name__)


def get_optimal_device_count(max_devices: Optional[int] = None) -> int:
    """Usable accelerator count: the visible cards, else 1 (the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return min(n, max_devices) if max_devices else n


def data_shardings(mesh: Mesh) -> Dict[str, tuple]:
    """Which dim of each engine input splits over 'data' (None:
    replicated): the [N, 2, T] upload buffer, [N, T] rows and [N]
    lengths split on N."""
    return {"buf3": ("data", None, None), "rows2": ("data", None),
            "vec": ("data",), "replicated": ()}


def mesh_from_config(config, device=None) -> Mesh:
    """The mesh ``config.mesh_shape`` ({data, model, seq}) names: over the
    launch's processes or the visible cards (RuntimeError when none is
    visible), or over CPU replicas when ``device`` is the CPU (the
    counterpart of the reference's virtual CPU devices)."""
    shape = config.get("mesh_shape") or {}
    data = int(shape.get("data", 0)) if shape else 0
    model = int(shape.get("model", 1)) if shape else 1
    seq = int(shape.get("seq", 1)) if shape else 1
    n = data * model * seq if data else None
    devices = None
    if device is not None and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")] * (n or 1)
    return make_mesh(n_devices=n, data=data or None, model=model, seq=seq,
                     devices=devices)


class MultiDeviceManager:
    """Distributes chunk batches across the mesh's 'data' devices.

    Mirrors the reference manager: ``num_workers``, ``data_parallel_size``
    and ``process_batches_parallel(batches, processor)``; the processor's
    ASR engine must have been built with this manager's mesh."""

    def __init__(self, config, mesh: Optional[Mesh] = None, device=None):
        self.config = config
        self.mesh = mesh if mesh is not None \
            else mesh_from_config(config, device)
        self.num_workers = int(np.prod(self.mesh.devices.shape))
        logger.info("Multi-device mesh: %s", self.mesh.shape)

    @property
    def data_parallel_size(self) -> int:
        return self.mesh.devices.shape[0]

    def process_batches_parallel(self, file_batches: Sequence,
                                 processor) -> int:
        total = 0
        for i, batch in enumerate(file_batches):
            total += processor.process_file_batch(i, batch)
        return total
