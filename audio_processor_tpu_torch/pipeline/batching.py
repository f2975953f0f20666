"""Size-aware file batching (reference: services/pipeline.py:237-278).

Largest-first packing bounded by ``max_batch_size_mb`` and
``file_batch_size``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Sequence

logger = logging.getLogger(__name__)


def file_size_mb(path: Path) -> float:
    try:
        return path.stat().st_size / (1024 * 1024)
    except OSError as e:
        logger.warning("Could not get size for %s: %s", path, e)
        return 0.0


def create_file_batches(files: Sequence[Path],
                        max_batch_size_mb: float = 23.0,
                        max_files_per_batch: int = 32) -> List[List[Path]]:
    batches: List[List] = []
    current: List = []
    current_mb = 0.0

    sized = sorted(((f, file_size_mb(Path(f))) for f in files),
                   key=lambda x: x[1], reverse=True)
    for path, mb in sized:
        if (current_mb + mb > max_batch_size_mb and current) \
                or len(current) >= max_files_per_batch:
            batches.append([f for f, _ in current])
            current = [(path, mb)]
            current_mb = mb
        else:
            current.append((path, mb))
            current_mb += mb
    if current:
        batches.append([f for f, _ in current])
    if batches:
        avg = sum(len(b) for b in batches) / len(batches)
        logger.info("Created %d file batches (max %.1fMB, avg %.1f files)",
                    len(batches), max_batch_size_mb, avg)
    return batches
