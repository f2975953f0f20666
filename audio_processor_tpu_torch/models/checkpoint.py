"""Cache of converted ASR weights (port of models/checkpoint.py).

Converting an HF checkpoint (models/convert_hf.py) reads and checks every
tensor; the converted state dict is cached beside the HF directory, in
``torch_converted/`` (``params.pt``, a ``torch.save``d state dict, and
``metadata.json`` with the model config and the CTC vocab), so later runs
restore it memory-mapped. The reference's semantics: a present, valid
cache is restored; a restore that fails reconverts with a warning; a
cache that cannot be written is a warning, not an error.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from audio_processor_tpu_torch.models.convert_hf import (
    load_w2v_bert_from_pretrained,
)
from audio_processor_tpu_torch.models.wav2vec2bert import W2VBertConfig

logger = logging.getLogger(__name__)

CACHE_DIRNAME = "torch_converted"
PARAMS_FILE = "params.pt"
META_FILE = "metadata.json"


def save_params(sd: Dict[str, torch.Tensor], directory: str | Path,
                metadata: Dict[str, Any]) -> Path:
    """Write the state dict, then the metadata that marks it complete."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    torch.save(sd, directory / PARAMS_FILE)
    (directory / META_FILE).write_text(json.dumps(metadata))
    logger.info("Saved converted params to %s", directory)
    return directory


def load_params(directory: str | Path
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    directory = Path(directory)
    meta = json.loads((directory / META_FILE).read_text())
    sd = torch.load(directory / PARAMS_FILE, map_location="cpu",
                    weights_only=True, mmap=True)
    return sd, meta


def cache_dir_for(model_path: str | Path) -> Path:
    return Path(model_path) / CACHE_DIRNAME


def load_or_convert_w2v_bert(model_path: str | Path
                             ) -> Tuple[W2VBertConfig,
                                        Dict[str, torch.Tensor],
                                        Optional[Dict[str, int]]]:
    """Restore the cache when present and valid, else convert the HF
    checkpoint and write the cache. Returns (config, state dict, vocab)."""
    cache = cache_dir_for(model_path)
    if cache.exists():
        try:
            sd, meta = load_params(cache)
            cfg = W2VBertConfig(**meta["config"])
            logger.info("Restored converted params from %s", cache)
            return cfg, sd, meta.get("vocab")
        except Exception as e:  # any unreadable cache is reconverted
            logger.warning("Cache restore failed (%s); reconverting", e)
    cfg, sd, vocab = load_w2v_bert_from_pretrained(model_path)
    try:
        save_params(sd, cache, {"config": dataclasses.asdict(cfg),
                                "vocab": vocab})
    except OSError as e:
        logger.warning("Could not write param cache: %s", e)
    return cfg, sd, vocab
