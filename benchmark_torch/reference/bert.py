"""Plain PyTorch reference of a BERT sequence classifier (HF
``BertForSequenceClassification``: post-LayerNorm encoder, erf GELU, a tanh
pooler over the first token, a linear classifier), fp32 with TF32 off, or
with ``tf32=True`` the control's TF32 products. Weights use
``harness.weights.bert_layout`` names. Imports nothing of the program."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def _lin(w, name, x):
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def _ln(w, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"],
                        w[f"{name}.bias"], eps)


def logits(w: Dict[str, torch.Tensor], m: Dict, ids: torch.Tensor,
           mask: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """[B, L] token ids and 0/1 mask -> [B, num_labels] fp32 logits."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        eps = m["layer_norm_eps"]
        B, L = ids.shape
        nh = m["num_attention_heads"]
        hd = m["hidden_size"] // nh
        x = (w["embeddings.word_embeddings.weight"][ids.long()]
             + w["embeddings.position_embeddings.weight"][:L][None]
             + w["embeddings.token_type_embeddings.weight"][0])
        x = _ln(w, "embeddings.LayerNorm", x, eps)
        keep = mask.bool()[:, None, None, :]
        for i in range(m["num_hidden_layers"]):
            p = f"encoder.layer.{i}"

            def heads(n):
                return _lin(w, f"{p}.attention.self.{n}", x) \
                    .view(B, L, nh, hd).transpose(1, 2)

            q, k, v = heads("query"), heads("key"), heads("value")
            s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
            s = s.masked_fill(~keep, float("-inf"))
            ctx = (torch.softmax(s, dim=-1) @ v).transpose(1, 2) \
                .reshape(B, L, -1)
            x = _ln(w, f"{p}.attention.output.LayerNorm",
                    x + _lin(w, f"{p}.attention.output.dense", ctx), eps)
            h = F.gelu(_lin(w, f"{p}.intermediate.dense", x))
            x = _ln(w, f"{p}.output.LayerNorm",
                    x + _lin(w, f"{p}.output.dense", h), eps)
        pooled = torch.tanh(_lin(w, "pooler.dense", x[:, 0]))
        return _lin(w, "classifier", pooled)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
