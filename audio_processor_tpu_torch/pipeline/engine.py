"""Pipeline engine over the port's device engines (port of
pipeline/engine.py).

The batch pipeline (scan -> batch -> decode -> ASR -> sentiment ->
persist, with markers, retries, reports and streamed CSV) is the
reference's JAX-free host code; :class:`DataProcessor` subclasses it
and overrides only what touches JAX:

- ``setup_models`` builds the port's ASR engine and sentiment analyzer
  on an explicit torch device;
- ``_decode_one`` resamples through the port's ``prepare_and_split``;
- ``run`` does not ask ``jax.process_count()``: one process only for
  now (multi-host sharding is ROADMAP.md work).

The VAD message path, device meshes and multi-process runs are not
ported yet and raise NotImplementedError when configured.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional

import torch

from audio_processor_tpu.io.decode import load_audio
from audio_processor_tpu.pipeline import engine as _reference
from audio_processor_tpu_torch.pipeline.chunker import prepare_and_split

logger = logging.getLogger(__name__)


class DataProcessor(_reference.DataProcessor):
    def __init__(self, config, db_manager=None, asr_engine=None,
                 sentiment_analyzer=None, topic_classifier=None,
                 monitor=None, device="cuda"):
        super().__init__(config, db_manager=db_manager,
                         asr_engine=asr_engine,
                         sentiment_analyzer=sentiment_analyzer,
                         topic_classifier=topic_classifier,
                         monitor=monitor)
        self.device = torch.device(device)

    def setup_models(self):
        """Build the device engines lazily."""
        if self.config.get("enable_message_path", False):
            raise NotImplementedError(
                "enable_message_path: the VAD message path is not ported "
                "yet (ROADMAP.md, Queue 1: message path)")
        if self.asr_engine is None:
            if self.config.get("mesh_shape"):
                raise NotImplementedError(
                    "mesh_shape: device meshes are not ported yet "
                    "(ROADMAP.md, Queue 1: parallel/)")
            from audio_processor_tpu_torch.pipeline.asr_engine import (
                ASREngine,
            )

            self.asr_engine = ASREngine(self.config, device=self.device)
        if self.sentiment_analyzer is None:
            from audio_processor_tpu_torch.pipeline.sentiment import (
                SentimentAnalyzer,
            )

            self.sentiment_analyzer = SentimentAnalyzer(
                self.config, db_manager=self.db_manager,
                topic_classifier=self.topic_classifier, device=self.device)
        elif self.db_manager is not None:
            self.sentiment_analyzer.set_database_manager(self.db_manager)

    def _decode_one(self, file_path: Path, preloaded=None,
                    t_start: Optional[float] = None):
        """Decode + resample + chunk one call, with retries; ``t_start``
        stamps the start of this file's decode for its latency."""
        if t_start is None:
            t_start = time.perf_counter()
        last_error: Optional[Exception] = None
        for attempt in range(1, self.max_retries + 1):
            try:
                if preloaded is not None and attempt == 1:
                    waveform, sr = preloaded
                else:
                    waveform, sr = load_audio(file_path)
                waveform, sr, chunks = prepare_and_split(
                    waveform, sr, file_path.name, self.config)
                if not chunks:
                    raise RuntimeError("no_chunks")
                return {"file": file_path, "chunks": chunks,
                        "duration": waveform.shape[-1] / sr,
                        "waveform": waveform, "t_start": t_start}
            except Exception as e:
                last_error = e
                logger.warning("Attempt %d/%d failed for %s: %s",
                               attempt, self.max_retries, file_path, e)
                time.sleep(min(5, attempt) * 0.01)
        logger.error("All %d attempts failed for %s: %s",
                     self.max_retries, file_path, last_error)
        return {"file": file_path, "chunks": [], "duration": 0.0,
                "error": str(last_error), "waveform": None,
                "t_start": t_start}

    def run(self) -> int:
        logger.info("Starting audio processing on %s", self.device)
        if torch.distributed.is_available() \
                and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise NotImplementedError(
                "multi-process runs are not ported yet (ROADMAP.md, "
                "Queue 1: parallel/)")
        self.setup_models()
        input_dir = Path(self.config.get("input_folder", "./input"))
        if not input_dir.exists():
            raise FileNotFoundError(
                f"Input directory {input_dir} does not exist")
        files = self.file_scanner.scan_files_parallel(input_dir)
        logger.info("Found %d valid audio files", len(files))
        # Run every chunk shape once OUTSIDE the timeout-bounded batch
        # loop (first-use costs must not read as a hung device).
        warmup = self.config.get("batch_warmup", True)
        if warmup and files and hasattr(self.asr_engine, "warmup"):
            t0 = time.perf_counter()
            n = self.asr_engine.warmup(all_buckets=(warmup == "all"))
            if n:
                logger.info("Warmup ran %d shape(s) in %.1fs",
                            n, time.perf_counter() - t0)
        total_success = self.process_files_parallel(files)
        self.log_results()
        self._close_csv_stream()
        logger.info("Processing completed: %d files succeeded",
                    total_success)
        return total_success
