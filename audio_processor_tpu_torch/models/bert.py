"""BERT sequence classifier in PyTorch (port of models/bert.py): the text
sentiment heads, HF ``BertForSequenceClassification``'s architecture and
state-dict names (``bert.encoder.layer.{i}.attention.self.query`` ...).

The reference's numerics: post-LN encoder with the LayerNorms in fp32,
an additive mask of ``(1 - mask) * finfo(float32).min``, fp32 scores
divided by sqrt(head size) and softmax, erf GELU, a tanh pooler over
[CLS] and an fp32 classifier. The product of attention is plain torch,
as the reference's is plain XLA (no Pallas kernel). ``quantization:
int8`` swaps the reference's set of dense layers for W8A8 ones
(:func:`quantize_model`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_processor_tpu_torch.models.quant import (
    is_quantized, quantize_linears,
)
from audio_processor_tpu_torch.models.wav2vec2bert import dense, layer_norm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    num_labels: int = 4
    layer_norm_eps: float = 1e-12

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> "BertConfig":
        """From an HF ``BertConfig`` as its ``config.json`` dict. A field
        the file leaves out takes this class's default, which is HF's;
        ``num_labels`` is the size of ``id2label`` (which HF makes from a
        bare ``num_labels``), or 2 without either."""
        kw = {f.name: hf[f.name] for f in dataclasses.fields(cls)
              if f.name in hf and f.name != "num_labels"}
        return cls(num_labels=len(hf.get("id2label") or {})
                   or hf.get("num_labels") or 2, **kw)


def _linear_ln(h: int, eps: float) -> nn.ModuleDict:
    return nn.ModuleDict({"dense": nn.Linear(h, h),
                          "LayerNorm": nn.LayerNorm(h, eps=eps)})


class BertForSequenceClassification(nn.Module):
    """[B, L] token ids (+ [B, L] mask) -> fp32 [B, num_labels] logits."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.layer_norm_eps

        def layer() -> nn.ModuleDict:
            return nn.ModuleDict({
                "attention": nn.ModuleDict({
                    "self": nn.ModuleDict({n: nn.Linear(h, h) for n in (
                        "query", "key", "value")}),
                    "output": _linear_ln(h, eps)}),
                "intermediate": nn.ModuleDict({
                    "dense": nn.Linear(h, cfg.intermediate_size)}),
                "output": nn.ModuleDict({
                    "dense": nn.Linear(cfg.intermediate_size, h),
                    "LayerNorm": nn.LayerNorm(h, eps=eps)}),
            })

        self.bert = nn.ModuleDict({
            "embeddings": nn.ModuleDict({
                "word_embeddings": nn.Embedding(cfg.vocab_size, h),
                "position_embeddings": nn.Embedding(
                    cfg.max_position_embeddings, h),
                "token_type_embeddings": nn.Embedding(cfg.type_vocab_size,
                                                      h),
                "LayerNorm": nn.LayerNorm(h, eps=eps)}),
            "encoder": nn.ModuleDict({
                "layer": nn.ModuleList(layer()
                                       for _ in range(cfg.num_hidden_layers))}),
            "pooler": nn.ModuleDict({"dense": nn.Linear(h, h)}),
        })
        self.classifier = nn.Linear(h, cfg.num_labels)

    def _layer(self, p: nn.ModuleDict, x: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
        B, L, H = x.shape
        nh, hd = self.cfg.num_attention_heads, self.cfg.head_size
        a = p["attention"]

        def heads(lin):
            return dense(lin, x).view(B, L, nh, hd).transpose(1, 2)

        q, k, v = (heads(a["self"][n]) for n in ("query", "key", "value"))
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores + bias, dim=-1).to(x.dtype)
        ctx = (probs.float() @ v.float()).to(x.dtype)
        ctx = ctx.transpose(1, 2).reshape(B, L, H)
        out = a["output"]
        x = layer_norm(out["LayerNorm"], x + dense(out["dense"], ctx))
        h = F.gelu(dense(p["intermediate"]["dense"], x).float()).to(x.dtype)
        return layer_norm(p["output"]["LayerNorm"],
                          x + dense(p["output"]["dense"], h))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        B, L = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(B, L, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros(B, L, dtype=torch.long, device=dev)
        e = self.bert["embeddings"]
        # Indices past a table's end take its last row, as the reference's
        # gathers clamp (a 512-token bucket on a model with fewer
        # positions, an added token past the vocab).
        cfg = self.cfg
        pos = torch.arange(L, device=dev).clamp_max(
            cfg.max_position_embeddings - 1)
        x = (e["word_embeddings"](input_ids.long().clamp_max(
                 cfg.vocab_size - 1))
             + e["position_embeddings"](pos)[None]
             + e["token_type_embeddings"](token_type_ids.long().clamp_max(
                 cfg.type_vocab_size - 1)))
        x = layer_norm(e["LayerNorm"], x.to(dtype))
        bias = ((1.0 - attention_mask.float())
                * torch.finfo(torch.float32).min)[:, None, None, :]
        for p in self.bert["encoder"]["layer"]:
            x = self._layer(p, x, bias)
        pooled = torch.tanh(dense(self.bert["pooler"]["dense"], x[:, 0, :]))
        return dense(self.classifier, pooled.float()).float()


# The dense layers int8 mode quantizes, per encoder layer (the reference's
# quantize_params): attention q/k/v/output and the FFN. The embeddings,
# pooler and classifier stay fp32.
QUANTIZED = ("attention.self.query", "attention.self.key",
             "attention.self.value", "attention.output.dense",
             "intermediate.dense", "output.dense")


def quantize_model(model: BertForSequenceClassification
                   ) -> BertForSequenceClassification:
    """An int8 W8A8 copy of ``model`` on its device; every tensor it keeps
    in float is shared with ``model``, which stays as it was. A model
    that is already int8 is returned."""
    if is_quantized(model):
        return model
    with torch.device("meta"):
        q = BertForSequenceClassification(model.cfg)
    q.load_state_dict(model.state_dict(), assign=True)
    quantize_linears(q, [f"bert.encoder.layer.{i}.{name}"
                         for i in range(model.cfg.num_hidden_layers)
                         for name in QUANTIZED])
    return q.eval()


# JAX param path -> the port's module path (per encoder layer for
# "layers"); leaves: kernel -> weight (transposed), kernel_q -> weight_q
# (transposed, int8), LayerNorm scale -> weight, a quantized dense's scale
# stays scale.
_JAX_LAYER = {
    ("attention", "query"): "attention.self.query",
    ("attention", "key"): "attention.self.key",
    ("attention", "value"): "attention.self.value",
    ("attention", "output"): "attention.output.dense",
    ("attention", "output_layer_norm"): "attention.output.LayerNorm",
    ("intermediate",): "intermediate.dense",
    ("output",): "output.dense",
    ("output_layer_norm",): "output.LayerNorm",
}


def params_from_jax(params_np: Dict[str, Any], cfg: BertConfig
                    ) -> Dict[str, torch.Tensor]:
    """The JAX classifier's param tree (leaves as numpy arrays; the
    reference's ``quantize_params`` output too) -> a state dict of
    :class:`BertForSequenceClassification` (of :func:`quantize_model`'s
    model for a quantized tree)."""
    out: Dict[str, torch.Tensor] = {}

    def put(path: str, d: Dict[str, Any], layer=None) -> None:
        for name, arr in d.items():
            arr = np.asarray(arr if layer is None else np.asarray(arr)[layer])
            dtype = torch.float32
            if name == "kernel":
                key, arr = "weight", arr.T
            elif name == "kernel_q":
                key, arr, dtype = "weight_q", arr.T, torch.int8
            elif name == "scale":
                key = "scale" if "kernel_q" in d else "weight"
            elif name == "bias":
                key = "bias"
            else:
                raise ValueError(f"unexpected param {path}.{name}")
            out[f"{path}.{key}"] = torch.tensor(arr, dtype=dtype)

    e = params_np["embeddings"]
    for name in ("word", "position", "token_type"):
        out[f"bert.embeddings.{name}_embeddings.weight"] = torch.tensor(
            np.asarray(e[f"{name}_embeddings"]), dtype=torch.float32)
    put("bert.embeddings.LayerNorm", e["layer_norm"])
    layers = params_np["layers"]
    for i in range(cfg.num_hidden_layers):
        for jax_path, port in _JAX_LAYER.items():
            d = layers
            for part in jax_path:
                d = d[part]
            put(f"bert.encoder.layer.{i}.{port}", d, layer=i)
    put("bert.pooler.dense", params_np["pooler"])
    put("classifier", params_np["classifier"])
    return out
