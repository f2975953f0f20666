"""MinIO ingest sync (reference: utils/minio-access.py:13-171).

Downloads objects under ``minio.folder_prefix`` that are missing
locally. Credentials come from MINIO_ACCESS_KEY / MINIO_SECRET_KEY env
vars; endpoint/bucket from config. Gated on the ``minio`` SDK.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict

logger = logging.getLogger(__name__)


class MinIOSyncManager:
    def __init__(self, config):
        self.config = config
        mc = config.minio if hasattr(config, "minio") else None
        self.enabled = bool(mc and mc.enabled)
        self.bucket = mc.bucket_name if mc else ""
        self.prefix = (mc.folder_prefix if mc else "input") or ""
        self.client = None
        if not self.enabled:
            return
        access_key = os.environ.get("MINIO_ACCESS_KEY")
        secret_key = os.environ.get("MINIO_SECRET_KEY")
        if not access_key or not secret_key:
            logger.error("MINIO_ACCESS_KEY / MINIO_SECRET_KEY not set - "
                         "MinIO sync disabled")
            self.enabled = False
            return
        try:
            from minio import Minio

            self.client = Minio(mc.endpoint, access_key=access_key,
                                secret_key=secret_key, secure=mc.secure)
        except ImportError:
            logger.error("minio SDK not installed - MinIO sync disabled")
            self.enabled = False

    def _check_bucket_exists(self) -> bool:
        try:
            return self.client.bucket_exists(self.bucket)
        except Exception as e:
            logger.error("Bucket check failed: %s", e)
            return False

    def download_missing_files(self, local_dir: str | Path) -> Dict[str, int]:
        stats = {"downloaded": 0, "skipped": 0, "errors": 0,
                 "total_objects": 0}
        if not self.enabled or not self._check_bucket_exists():
            return stats
        local_dir = Path(local_dir)
        local_dir.mkdir(parents=True, exist_ok=True)
        try:
            objects = self.client.list_objects(
                self.bucket, prefix=self.prefix, recursive=True)
            for obj in objects:
                stats["total_objects"] += 1
                name = obj.object_name
                local_path = local_dir / Path(name).name
                if local_path.exists():
                    stats["skipped"] += 1
                    continue
                try:
                    self.client.fget_object(self.bucket, name,
                                            str(local_path))
                    stats["downloaded"] += 1
                except Exception as e:
                    logger.error("Download failed for %s: %s", name, e)
                    stats["errors"] += 1
        except Exception as e:
            logger.error("MinIO listing failed: %s", e)
            stats["errors"] += 1
        return stats

    def sync_to_local(self, local_dir: str | Path) -> Dict[str, int]:
        stats = self.download_missing_files(local_dir)
        logger.info("MinIO sync: %s", stats)
        return stats
