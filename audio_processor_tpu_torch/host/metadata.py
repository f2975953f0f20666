"""Sidecar-JSON metadata loading (reference: utils/utils.py:81-135).

One JSON per call next to the audio; id = filename stem; adds
BUSINESS_TYPE from the destination number before upserting into
call_metadata.
"""

from __future__ import annotations

import json
import logging
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Tuple

logger = logging.getLogger(__name__)


def _process_one(file_path: str, db_manager) -> Tuple[str, bool, str]:
    try:
        with open(file_path, "r", encoding="utf-8") as f:
            metadata = json.load(f)
        cid = Path(file_path).stem
        metadata["BUSINESS_TYPE"] = db_manager.business_type(
            metadata.get("DESTINATION_NUMBER"))
        db_manager.insert_call_metadata(cid, metadata)
        return file_path, True, ""
    except Exception as e:
        return file_path, False, str(e)


def load_metadata(db_manager, config) -> Tuple[int, int]:
    """Returns (loaded, failed)."""
    folder = Path(config.get("input_folder", "."))
    if not folder.exists():
        logger.warning("Metadata folder %s does not exist", folder)
        return 0, 0
    json_files = sorted(folder.glob("*.json"))
    if not json_files:
        logger.info("No metadata JSON files found in %s", folder)
        return 0, 0
    logger.info("Loading %d metadata files", len(json_files))
    loaded = failed = 0
    with ThreadPoolExecutor(
            max_workers=int(config.get("io_workers", 32))) as ex:
        futures = {ex.submit(_process_one, str(f), db_manager): f
                   for f in json_files}
        for fut in as_completed(futures):
            _, ok, err = fut.result()
            if ok:
                loaded += 1
            else:
                failed += 1
                logger.warning("Metadata load failed for %s: %s",
                               futures[fut], err)
    logger.info("Metadata loading complete: %d ok, %d failed",
                loaded, failed)
    return loaded, failed
