"""Parallel file scanning and validation.

Equivalent of the reference's ``AudioFileScanner``
(services/pipeline.py:55-108): recursive ``*.wav``/``*.ogg`` glob with
parallel header validation. Reference semantics preserved: empty files
are rejected and **mono files are rejected** (the pipeline expects
2-channel agent/client calls, pipeline.py:98-101).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

from audio_processor_tpu_torch.io.decode import probe

logger = logging.getLogger(__name__)


class AudioFileScanner:
    def __init__(self, config):
        self.config = config
        self.io_workers = int(config.get("io_workers", 32))

    def _validate_file(self, file_path: Path) -> bool:
        try:
            if not file_path.exists():
                logger.warning("File does not exist: %s", file_path)
                return False
            ai = probe(file_path)
            if ai is None:
                logger.warning("Unreadable audio header: %s", file_path)
                return False
            if ai.num_frames == 0:
                logger.warning("Empty audio file: %s", file_path)
                return False
            if ai.num_channels == 1:
                logger.warning("Mono file rejected (expects 2-channel "
                               "agent/client): %s", file_path)
                return False
            return True
        except Exception as e:  # pragma: no cover - defensive
            logger.error("Error validating %s: %s", file_path, e)
            return False

    def scan_files_parallel(self, input_dir: Path) -> List[Path]:
        input_dir = Path(input_dir)
        files = sorted(input_dir.rglob("*.wav"))
        files.extend(sorted(input_dir.rglob("*.ogg")))
        # beyond-reference: .opus routes through the same Ogg/Opus
        # decoder chain as .ogg (io/decode.py); .mp3 through the
        # optional libmpg123 binding (io/mp3.py) — scanned only when
        # that decoder is present so absent-lib setups match the
        # reference's .wav/.ogg surface exactly
        files.extend(sorted(input_dir.rglob("*.opus")))
        # .flac decodes through the always-available first-party
        # decoder (io/flac.py)
        files.extend(sorted(input_dir.rglob("*.flac")))
        from audio_processor_tpu_torch.io.mp3 import mpg123_available

        if mpg123_available():
            files.extend(sorted(input_dir.rglob("*.mp3")))
        valid: List[Path] = []
        with ThreadPoolExecutor(max_workers=self.io_workers) as ex:
            for f, ok in zip(files, ex.map(self._validate_file, files)):
                if ok:
                    valid.append(f)
        return valid
