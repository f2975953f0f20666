"""HF checkpoint directories read without ``transformers`` or
``safetensors``: what ``from_pretrained`` reads for the JAX package's
loaders (models/convert_hf.py, pipeline/sentiment.py), kept to the files
those checkpoints hold.

- ``config.json`` as a dict (:func:`read_config`);
- the weights (:func:`read_state_dict`), from the first of
  ``model.safetensors``, ``model.safetensors.index.json`` (sharded),
  ``pytorch_model.bin`` and ``pytorch_model.bin.index.json`` that the
  directory holds, as ``from_pretrained`` prefers them. Float tensors come
  back as fp32 CPU tensors (``from_pretrained(...,
  torch_dtype=torch.float32)``), legacy ``LayerNorm.gamma/beta`` keys are
  renamed ``weight/bias``, and the ``position_ids`` buffers, which the
  models recompute, are dropped.

A safetensors file is an 8-byte little-endian header length, a JSON
header (name -> dtype, shape, byte range; ``__metadata__`` aside) and the
raw buffers. numpy has no bfloat16: BF16 is read as uint16 and viewed as
``torch.bfloat16``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

WEIGHT_FILES = ("model.safetensors", "model.safetensors.index.json",
                "pytorch_model.bin", "pytorch_model.bin.index.json")
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
              "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}


def read_json(path: str | Path) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def special_token(value: Any) -> Optional[str]:
    """A special token as tokenizer files store it: a string, or an
    AddedToken dict."""
    return value.get("content") if isinstance(value, dict) else value


def read_config(model_dir: str | Path) -> Dict[str, Any]:
    """``config.json`` of an HF checkpoint directory."""
    return read_json(Path(model_dir) / "config.json")


def read_safetensors(path: str | Path) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, copied into CPU memory
    in its stored dtype."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    data = (np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
            if header else None)
    out = {}
    for name, info in header.items():
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which is not read")
        start, end = info["data_offsets"]
        t = torch.from_numpy(np.array(data[start:end].view(dtype)))
        if info["dtype"] == "BF16":
            t = t.view(torch.bfloat16)
        out[name] = t.reshape(info["shape"])
    return out


def _read_weights_file(path: Path) -> Dict[str, torch.Tensor]:
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_key(key: str) -> str:
    """``from_pretrained``'s rename of legacy LayerNorm keys."""
    if key.endswith("LayerNorm.gamma"):
        return key[:-len("gamma")] + "weight"
    if key.endswith("LayerNorm.beta"):
        return key[:-len("beta")] + "bias"
    return key


def read_state_dict(model_dir: str | Path) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor (floats as fp32) of an HF checkpoint directory."""
    d = Path(model_dir)
    name = next((n for n in WEIGHT_FILES if (d / n).exists()), None)
    if name is None:
        raise FileNotFoundError(f"{d} holds none of {', '.join(WEIGHT_FILES)}")
    if name.endswith(".index.json"):
        shards = sorted(set(read_json(d / name)["weight_map"].values()))
        raw: Dict[str, torch.Tensor] = {}
        for shard in shards:
            raw.update(_read_weights_file(d / shard))
    else:
        raw = _read_weights_file(d / name)
    return {_load_key(k): (v.float() if v.is_floating_point() else v)
            for k, v in raw.items() if not k.endswith("position_ids")}
