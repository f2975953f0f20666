"""Reference-compatible public facades (port of pipeline/facades.py).

Users of the reference interact with ``AudioProcessor``,
``SpeechSegment``/``SpeechBatchTranscriber`` and ``SentimentAnalyzer``.
``SentimentAnalyzer`` and the segmenter classes live in
pipeline/sentiment.py and pipeline/segmenter.py; this module provides
the ``AudioProcessor`` facade (reference: services/audio_processor.py:
17-448) over the port's engine, on the ``device`` it is given (default
``cuda``).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from audio_processor_tpu_torch.dsp.resample import resample_np
from audio_processor_tpu_torch.io.decode import load_audio as _load_audio
from audio_processor_tpu_torch.pipeline.chunker import Chunk, split_audio

logger = logging.getLogger(__name__)


class AudioProcessor:
    """Decode -> chunk -> batched CTC transcription facade."""

    def __init__(self, config, db_manager=None, device="cuda"):
        self.config = config
        self.db_manager = db_manager
        self.device = torch.device(device)
        self.engine = None
        self.transcriber = None
        self.failed_files: List[Dict[str, Any]] = []
        self.chunk_duration_sec = float(config.get("chunk_duration_sec", 25))
        self.overlap_sec = float(config.get("overlap_sec", 1))
        self.target_sample_rate = int(config.get("target_sample_rate",
                                                 16000))
        self.max_retries = int(config.get("max_retries", 3))

    def load_models(self):
        from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
        from audio_processor_tpu_torch.pipeline.segmenter import (
            SpeechBatchTranscriber,
        )

        self.engine = ASREngine(self.config, device=self.device)
        self.transcriber = SpeechBatchTranscriber(
            self.config, asr_engine=self.engine)
        logger.info("Transcription model loaded")

    def _require_engine(self):
        if self.engine is None:
            self.load_models()
        return self.engine

    # ------------------------------------------------------------------
    def load_audio(self, audio_path: Path) -> Tuple[np.ndarray, int]:
        """[C, T] float32 + sample rate (reference contract:
        audio_processor.py:73-97)."""
        return _load_audio(audio_path)

    def get_resampler(self, orig_freq: int, new_freq: int):
        """Callable waveform resampler (reference contract:
        audio_processor.py:99-111 returns a cached
        torchaudio.transforms.Resample; here the polyphase kernels are
        cached inside dsp.resample per (orig, new) pair)."""
        def resampler(waveform):
            return resample_np(np.asarray(waveform, np.float32),
                               orig_freq, new_freq)
        return resampler

    def split_audio(self, waveform: np.ndarray, sample_rate: int,
                    file_name: str):
        """Returns (chunk dicts, agent_waveform, client_waveform)
        matching the reference contract (audio_processor.py:104-160)."""
        waveform = np.asarray(waveform, np.float32)
        if sample_rate != self.target_sample_rate:
            waveform = resample_np(waveform, sample_rate,
                                   self.target_sample_rate)
            sample_rate = self.target_sample_rate
        chunks = split_audio(waveform, sample_rate, file_name,
                             self.chunk_duration_sec, self.overlap_sec)
        if waveform.ndim == 2 and waveform.shape[0] == 2:
            agent, client = waveform[0], waveform[1]
        else:
            flat = waveform.reshape(-1) if waveform.ndim == 1 \
                else waveform[0]
            agent = client = flat
        chunk_dicts = [self._chunk_to_dict(c) for c in chunks]
        return chunk_dicts, agent, client

    @staticmethod
    def _chunk_to_dict(c: Chunk) -> Dict[str, Any]:
        return {
            "file_name": c.file_name,
            "stereo_waveform": c.mixed,
            "agent_waveform": c.agent,
            "client_waveform": c.client,
            "chunk_idx": c.chunk_idx,
            "start_time": c.start_time,
            "end_time": c.end_time,
        }

    @staticmethod
    def _dict_to_chunk(d: Dict[str, Any]) -> Chunk:
        mixed = np.asarray(d.get("stereo_waveform",
                                 d.get("agent_waveform"))).reshape(-1)
        return Chunk(
            file_name=d.get("file_name", ""),
            chunk_idx=d.get("chunk_idx", 0),
            start_time=d.get("start_time", 0.0),
            end_time=d.get("end_time", 0.0),
            mixed=mixed,
            agent=np.asarray(d.get("agent_waveform", mixed)).reshape(-1),
            client=np.asarray(d.get("client_waveform", mixed)).reshape(-1),
        )

    # ------------------------------------------------------------------
    def transcribe_batch(self, chunks: List[Dict]) -> List[Dict]:
        """Chunk dicts in -> chunk dicts out with transcription_chunk /
        agent_transcription / client_transcription / error added
        (reference: audio_processor.py:162-212)."""
        if not chunks:
            return []
        engine = self._require_engine()
        results = engine.transcribe_chunks(
            [self._dict_to_chunk(d) for d in chunks])
        for original, result in zip(chunks, results):
            original.update({
                "transcription_chunk": result["transcription_chunk"],
                "agent_transcription": result["agent_transcription"],
                "client_transcription": result["client_transcription"],
                "error": result["error"],
            })
        return chunks

    def process_batch(self, batch_id: int,
                      audio_files: List[Path]) -> List[Dict]:
        """Load + chunk + transcribe a file batch
        (reference: audio_processor.py:324-367)."""
        all_chunks: List[Dict] = []
        for file in audio_files:
            chunks = self._process_single_file_with_retries(Path(file))
            if chunks:
                all_chunks.extend(chunks)
            else:
                self.failed_files.append({
                    "filename": Path(file).name, "path": str(file),
                    "error": "empty_chunks_after_retries", "chunks": []})
        return self.transcribe_batch(all_chunks) if all_chunks else []

    def _process_single_file_with_retries(self, file_path: Path
                                          ) -> List[Dict]:
        import time as _time

        last = None
        for attempt in range(1, self.max_retries + 1):
            try:
                chunks = self._process_single_file(file_path)
                if chunks:
                    return chunks
                raise RuntimeError("no_chunks")
            except Exception as e:
                last = e
                logger.warning("Attempt %d/%d failed for %s: %s",
                               attempt, self.max_retries, file_path, e)
                _time.sleep(min(5, attempt) * 0.01)
        logger.error("All %d attempts failed for %s: %s",
                     self.max_retries, file_path, last)
        return []

    def _process_single_file(self, file_path: Path) -> List[Dict]:
        waveform, sample_rate = self.load_audio(file_path)
        chunks, _, _ = self.split_audio(waveform, sample_rate,
                                        file_path.name)
        if self.db_manager is not None:
            try:
                self.db_manager.insert_call({
                    "id_enregistrement": file_path.stem,
                    "duration_seconds":
                        waveform.shape[-1] / sample_rate,
                    "topics": "", "emotion_client_globale": "",
                    "ton_agent_global": ""})
            except Exception as e:
                logger.error("Failed to save call to database: %s", e)
        return chunks
