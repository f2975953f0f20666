"""Decoded call -> chunks (port of pipeline/chunker.prepare_and_split).

Chunking itself is the reference's JAX-free host code, imported as is
(``split_audio``, ``chunk_batch``, ``Chunk``). Only
``prepare_and_split`` is re-stated here: the reference resamples
through its JAX ``dsp.resample`` module, and this one through the
port's numpy ``resample_np`` (same numerics).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from audio_processor_tpu.pipeline.chunker import (  # noqa: F401
    Chunk, chunk_batch, split_audio,
)
from audio_processor_tpu_torch.dsp.resample import resample_np


def prepare_and_split(waveform: np.ndarray, sample_rate: int,
                      file_name: str, config
                      ) -> Tuple[np.ndarray, int, List[Chunk]]:
    """Decoded audio -> (waveform, rate, chunks) under the pipeline's
    config: resample to target_sample_rate, truncate at
    max_audio_length, split into overlapping chunks."""
    target_sr = int(config.get("target_sample_rate", 16000))
    if sample_rate != target_sr:
        waveform = resample_np(waveform, sample_rate, target_sr)
        sample_rate = target_sr
    max_len = int(float(config.get("max_audio_length", 1800.0))
                  * sample_rate)
    if waveform.shape[-1] > max_len:
        waveform = waveform[..., :max_len]
    chunks = split_audio(
        waveform, sample_rate, file_name,
        float(config.get("chunk_duration_sec", 25.0)),
        float(config.get("overlap_sec", 1.0)))
    return waveform, sample_rate, chunks
