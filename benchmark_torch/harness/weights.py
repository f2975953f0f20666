"""Seeded weights, made by the benchmark, for the program and the reference.

The benchmark owns the weights: it draws them on the device from the run's
seed and hands the same tensors to the program under test (loaded into the
port's modules by name) and, after the window, draws them again for the
plain reference. The reference never reads anything the program made.

Every random tensor is a view into one flat fp32 buffer filled by a single
``normal_`` call on a ``torch.Generator`` of the device, so set-up costs one
kernel and not one per leaf. The distribution is the port's synthetic one:
dense, conv and embedding weights ~ N(0, 0.02), biases 0, LayerNorms 1 / 0.
A BERT classifier head is scaled by 50 so its classes are visibly unequal.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

STD = 0.02

# (name, shape, kind): kind is "normal", "zeros" or "ones".
Layout = List[Tuple[str, Tuple[int, ...], str]]


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of one run (weights, traffic, sample),
    so that the streams of one run never overlap."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _ln(name: str, d: int) -> Layout:
    return [(f"{name}.weight", (d,), "ones"), (f"{name}.bias", (d,), "zeros")]


def _linear(name: str, d_in: int, d_out: int, bias: bool = True) -> Layout:
    out = [(f"{name}.weight", (d_out, d_in), "normal")]
    if bias:
        out.append((f"{name}.bias", (d_out,), "zeros"))
    return out


def w2v_bert_layout(m: Dict) -> Layout:
    """Parameter names and shapes of a Wav2Vec2-BERT CTC model (HF's
    ``Wav2Vec2BertForCTC`` modules without the ``wav2vec2_bert.encoder``
    prefixes), from the configuration's ``model`` section."""
    h, f = m["hidden_size"], m["intermediate_size"]
    hd = h // m["num_attention_heads"]
    P = m["left_max_position_embeddings"] \
        + m["right_max_position_embeddings"] + 1
    K = m["conv_depthwise_kernel_size"]
    fin = m["feature_projection_input_dim"]
    out: Layout = _ln("feature_projection.layer_norm", fin)
    out += _linear("feature_projection.projection", fin, h)
    for i in range(m["num_hidden_layers"]):
        p = f"layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            out += _ln(f"{p}.{ffn}_layer_norm", h)
            out += _linear(f"{p}.{ffn}.intermediate_dense", h, f)
            out += _linear(f"{p}.{ffn}.output_dense", f, h)
        out += _ln(f"{p}.self_attn_layer_norm", h)
        for n in ("q", "k", "v", "out"):
            out += _linear(f"{p}.self_attn.linear_{n}", h, h)
        out.append((f"{p}.self_attn.distance_embedding", (P, hd), "normal"))
        out += _ln(f"{p}.conv_module.layer_norm", h)
        out += _linear(f"{p}.conv_module.pointwise_conv1", h, 2 * h, False)
        out.append((f"{p}.conv_module.depthwise_conv.weight", (h, 1, K),
                    "normal"))
        out += _ln(f"{p}.conv_module.depthwise_layer_norm", h)
        out += _linear(f"{p}.conv_module.pointwise_conv2", h, h, False)
        out += _ln(f"{p}.final_layer_norm", h)
    out += _linear("lm_head", h, m["vocab_size"])
    return out


def bert_layout(m: Dict) -> Layout:
    """Parameter names and shapes of a BERT sequence classifier (HF's
    ``BertForSequenceClassification`` names without the ``bert.`` prefix)."""
    h, f, n = m["hidden_size"], m["intermediate_size"], m["num_labels"]
    out: Layout = [
        ("embeddings.word_embeddings.weight", (m["vocab_size"], h), "normal"),
        ("embeddings.position_embeddings.weight",
         (m["max_position_embeddings"], h), "normal"),
        ("embeddings.token_type_embeddings.weight",
         (m["type_vocab_size"], h), "normal"),
    ]
    out += _ln("embeddings.LayerNorm", h)
    for i in range(m["num_hidden_layers"]):
        p = f"encoder.layer.{i}"
        for q in ("query", "key", "value"):
            out += _linear(f"{p}.attention.self.{q}", h, h)
        out += _linear(f"{p}.attention.output.dense", h, h)
        out += _ln(f"{p}.attention.output.LayerNorm", h)
        out += _linear(f"{p}.intermediate.dense", h, f)
        out += _linear(f"{p}.output.dense", f, h)
        out += _ln(f"{p}.output.LayerNorm", h)
    out += _linear("pooler.dense", h, h)
    out += _linear("classifier", h, n)
    return out


def make(layout: Layout, seed: int, device,
         scale: Dict[str, float] = None) -> Dict[str, torch.Tensor]:
    """fp32 tensors of ``layout`` on ``device``, the random ones views into
    one buffer drawn by one ``normal_`` call seeded with ``seed``."""
    device = torch.device(device)
    total = sum(_numel(s) for _, s, kind in layout if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(0.0, STD, generator=gen)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape, kind in layout:
        n = _numel(shape)
        if kind == "normal":
            t = flat[offset:offset + n].view(shape)
            offset += n
        elif kind == "ones":
            t = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            t = torch.zeros(shape, dtype=torch.float32, device=device)
        out[name] = t
    for name, s in (scale or {}).items():
        out[name].mul_(s)
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n
