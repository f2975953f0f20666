"""Work-unit idempotence markers + retention cleanup
(reference: services/pipeline.py:280-350).

``.done`` / ``.failed`` marker files under
``<output>/processed_markers/`` make re-runs skip completed calls; DB
upserts make replays idempotent; retention cleanup deletes aged
temp/intermediate/marker artifacts and optionally processed inputs.
"""

from __future__ import annotations

import json
import logging
from datetime import datetime, timedelta
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)


class ProcessedMarkers:
    def __init__(self, markers_dir: str | Path):
        self.dir = Path(markers_dir)
        self.dir.mkdir(parents=True, exist_ok=True)

    def is_processed(self, file_path: str | Path) -> bool:
        return (self.dir / f"{Path(file_path).stem}.done").exists()

    def _write(self, name: str, payload: str, what: str) -> None:
        # Recreate the marker dir if an operator (or retention
        # cleanup) removed it mid-run: losing a marker silently costs
        # idempotence on the next sweep.
        try:
            try:
                (self.dir / name).write_text(payload)
            except FileNotFoundError:
                self.dir.mkdir(parents=True, exist_ok=True)
                (self.dir / name).write_text(payload)
        except OSError:
            logger.warning("Failed to create %s marker %s", what, name)

    def mark_processed(self, file_path: str | Path) -> None:
        self._write(f"{Path(file_path).stem}.done",
                    datetime.now().isoformat(), "processed")

    def mark_failed(self, file_path: str | Path, error: str = "") -> None:
        self._write(f"{Path(file_path).stem}.failed",
                    json.dumps({"timestamp": datetime.now().isoformat(),
                                "error": error}), "failed")

    def failed_error(self, file_path: str | Path) -> Optional[str]:
        p = self.dir / f"{Path(file_path).stem}.failed"
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text()).get("error", "")
        except (OSError, json.JSONDecodeError):
            return ""


def cleanup_old_artifacts(config, markers: ProcessedMarkers,
                          temp_dir: Path, intermediate_dir: Path) -> int:
    """Delete aged artifacts; optionally processed input audio
    (reference: pipeline.py:317-350). Returns deleted-file count.

    Intentional fix vs the reference: processed-audio deletion runs
    BEFORE the marker directory is purged. The reference purges
    markers first and then requires ``marker.exists()`` to delete the
    audio (pipeline.py:335-348), so aged audio is in practice never
    deleted — contradicting its own ``delete_processed_files``
    contract (config.yaml:77).
    """
    retention_days = int(config.get("retention_days", 30))
    delete_processed = bool(config.get("delete_processed_files", False))
    cutoff = datetime.now() - timedelta(days=retention_days)
    deleted = 0

    if delete_processed:
        input_dir = Path(config.get("input_folder", "."))
        for pattern in ("*.wav", "*.ogg"):
            for audio in input_dir.rglob(pattern):
                marker = markers.dir / f"{audio.stem}.done"
                try:
                    if marker.exists() and datetime.fromtimestamp(
                            marker.stat().st_mtime) < cutoff:
                        audio.unlink(missing_ok=True)
                        deleted += 1
                except OSError:
                    pass

    def _cleanup_dir(d: Path):
        nonlocal deleted
        if not d.exists():
            return
        for p in d.glob("**/*"):
            try:
                if p.is_file() and \
                        datetime.fromtimestamp(p.stat().st_mtime) < cutoff:
                    p.unlink(missing_ok=True)
                    deleted += 1
            except OSError:
                pass

    _cleanup_dir(temp_dir)
    _cleanup_dir(intermediate_dir)
    _cleanup_dir(markers.dir)
    return deleted
