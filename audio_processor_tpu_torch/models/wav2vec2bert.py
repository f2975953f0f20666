"""Wav2Vec2Bert CTC encoder in PyTorch (port of models/wav2vec2bert.py).

Architecture-compatible with HF ``Wav2Vec2BertForCTC``: feature
projection over 160-dim stacked fbank features, a stack of conformer
layers (ffn1*0.5 -> self-attention with relative-key position
embeddings -> causal depthwise-conv module -> ffn2*0.5 -> final LN) and
a CTC head.

Conventions kept from the JAX package:

- Params stay fp32; the compute dtype is a forward() argument and each
  matmul casts its weight to it (``dense``). LayerNorms run in fp32.
  Logits are fp32.
- Attention: ``attention_impl="flash_rel"`` runs the hand-written CUDA
  kernel that builds the relative bias inside
  (models/flash_rel_attention.py); ``"flash"`` materialises the bias
  (relative logits + kv mask) to [B, H, L, L] in bf16 and runs the flash
  kernel of models/flash_attention.py on it; ``"xla"`` is the plain eager
  path with the static-index relative bias; ``"auto"`` picks
  ``flash_rel`` for CUDA tensors and the plain path on the CPU. As in
  the reference, ``flash_rel`` takes its kernel only when L is a
  multiple of 256 and ``flash`` only when L is a multiple of 128; at any
  other L both run the plain path.
- :func:`params_from_jax` turns the JAX param pytree (stacked leading
  layer axis, ``kernel [in, out]``) into this module's state dict, so
  both packages can run one set of weights.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_processor_tpu_torch.models.flash_attention import flash_attention
from audio_processor_tpu_torch.models.flash_rel_attention import (
    flash_rel_attention,
)


@dataclasses.dataclass(frozen=True)
class W2VBertConfig:
    vocab_size: int = 64
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    conv_depthwise_kernel_size: int = 31
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 0            # CTC blank

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_positions(self) -> int:
        return (self.left_max_position_embeddings
                + self.right_max_position_embeddings + 1)


# The L multiple at which each kernel path takes its kernel (the
# reference's rule); attention at any other L takes the plain path. The
# engine pads L to a multiple of every entry, so its batches always
# reach the kernel.
KERNEL_L_MULTIPLE = {"flash_rel": 256, "flash": 128}


def resolve_attention_impl(impl: str, device: torch.device) -> str:
    """Map a configured ``attention_impl`` to the path that runs."""
    if impl == "auto":
        return "flash_rel" if device.type == "cuda" else "xla"
    if impl not in ("flash_rel", "flash", "xla"):
        raise ValueError(f"unknown attention_impl {impl!r}")
    return impl


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b in x's dtype; the fp32 params are cast here."""
    b = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), b)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32, returned in x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def _ln(cfg: W2VBertConfig, d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class FeedForward(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size,
                                      cfg.hidden_size)

    def forward(self, x):
        return dense(self.output_dense, F.silu(dense(self.intermediate_dense,
                                                     x)))


@functools.lru_cache(maxsize=32)
def _distance_index(seq_len: int, left: int, right: int,
                    device: torch.device) -> torch.Tensor:
    """Static [L, L] map: (query i, key j) -> clipped-distance bucket."""
    pos = torch.arange(seq_len, device=device)
    return (pos[None, :] - pos[:, None]).clamp(-left, right) + left


def _relative_bias(cfg: W2VBertConfig, q: torch.Tensor, E: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Unscaled relative_key bias rel[b,h,l,m] = q_l . E[clip(m-l)] as
    [B, H, L, L] in ``out_dtype``: the bucket logits q . E^T (fp32
    accumulation) rounded to ``out_dtype``, then gathered with the
    static distance index (rounding commutes with the gather)."""
    B, H, L, _ = q.shape
    idx = _distance_index(L, cfg.left_max_position_embeddings,
                          cfg.right_max_position_embeddings, q.device)
    srel = (q.float() @ E.float().T).to(out_dtype)       # [B, H, L, P]
    return srel.gather(3, idx.expand(B, H, L, L))


def flash_bias(cfg: W2VBertConfig, q: torch.Tensor, E: torch.Tensor,
               attn_bias: torch.Tensor, scale: float) -> torch.Tensor:
    """The [B, H, L, L] bias the reference feeds the stock flash kernel:
    bf16(rel) + bf16(attn_bias / scale), in bf16 whatever the compute
    dtype (the kernel multiplies the sum by ``scale``). The mask is
    added in place, so one [B, H, L, L] tensor is allocated."""
    ab = _relative_bias(cfg, q, E, torch.bfloat16)
    ab += (attn_bias / scale).to(torch.bfloat16)
    return ab


class SelfAttention(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.linear_q = nn.Linear(h, h)
        self.linear_k = nn.Linear(h, h)
        self.linear_v = nn.Linear(h, h)
        self.linear_out = nn.Linear(h, h)
        self.distance_embedding = nn.Parameter(
            torch.empty(cfg.num_positions, cfg.head_size))

    def _heads(self, lin, x):
        B, L, _ = x.shape
        nh, hd = self.cfg.num_attention_heads, self.cfg.head_size
        return dense(lin, x).view(B, L, nh, hd).transpose(1, 2).contiguous()

    def forward(self, x, attn_bias, kv_mask, impl: str):
        B, L, H = x.shape
        cfg = self.cfg
        q = self._heads(self.linear_q, x)                # [B, nh, L, hd]
        k = self._heads(self.linear_k, x)
        v = self._heads(self.linear_v, x)
        scale = 1.0 / math.sqrt(cfg.head_size)
        left, P = cfg.left_max_position_embeddings, cfg.num_positions
        E = self.distance_embedding.to(x.dtype)          # [P, hd]
        kernel = (impl in KERNEL_L_MULTIPLE
                  and L % KERNEL_L_MULTIPLE[impl] == 0)
        if impl == "flash_rel" and kernel:
            out = flash_rel_attention(q, k, v, E, kv_mask, scale, left, P)
        elif impl == "flash" and kernel:
            out = flash_attention(q, k, v,
                                  flash_bias(cfg, q, E, attn_bias, scale),
                                  scale)
        else:
            # Plain path: scores and the static-index relative bias in
            # fp32, probabilities rounded to the compute dtype.
            scores = (q.float() @ k.float().transpose(-1, -2)) * scale \
                + _relative_bias(cfg, q, E, torch.float32) * scale \
                + attn_bias
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = (probs.float() @ v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(B, L, H)
        return dense(self.linear_out, out)


class ConvModule(nn.Module):
    """Conformer convolution block with causal (left-only) padding."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        h, K = cfg.hidden_size, cfg.conv_depthwise_kernel_size
        self.layer_norm = _ln(cfg, h)
        self.pointwise_conv1 = nn.Linear(h, 2 * h, bias=False)
        self.depthwise_conv = nn.Conv1d(h, h, K, groups=h, bias=False)
        self.depthwise_layer_norm = _ln(cfg, h)
        self.pointwise_conv2 = nn.Linear(h, h, bias=False)

    def forward(self, x, pad_mask):
        x = layer_norm(self.layer_norm, x)
        x = x * pad_mask[..., None].to(x.dtype)
        a, g = dense(self.pointwise_conv1, x).chunk(2, dim=-1)
        x = a * torch.sigmoid(g)                                 # GLU
        K = self.depthwise_conv.kernel_size[0]
        xt = F.pad(x.transpose(1, 2), (K - 1, 0))                # causal
        w = self.depthwise_conv.weight
        if x.dtype == torch.float32 and x.is_cuda:
            # fp32 compute means true fp32: cuDNN would run an fp32
            # convolution in TF32 by default; float64 never is.
            y = F.conv1d(xt.double(), w.double(), groups=x.shape[-1])
        else:
            y = F.conv1d(xt, w.to(x.dtype), groups=x.shape[-1])
        x = y.to(x.dtype).transpose(1, 2)
        x = F.silu(layer_norm(self.depthwise_layer_norm, x))
        return dense(self.pointwise_conv2, x)


class ConformerLayer(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.ffn1_layer_norm = _ln(cfg, h)
        self.ffn1 = FeedForward(cfg)
        self.self_attn_layer_norm = _ln(cfg, h)
        self.self_attn = SelfAttention(cfg)
        self.conv_module = ConvModule(cfg)
        self.ffn2_layer_norm = _ln(cfg, h)
        self.ffn2 = FeedForward(cfg)
        self.final_layer_norm = _ln(cfg, h)

    def forward(self, x, attn_bias, pad_mask, impl: str):
        x = self.ffn1(layer_norm(self.ffn1_layer_norm, x)) * 0.5 + x
        h = layer_norm(self.self_attn_layer_norm, x)
        x = self.self_attn(h, attn_bias, pad_mask, impl) + x
        x = self.conv_module(x, pad_mask) + x
        x = self.ffn2(layer_norm(self.ffn2_layer_norm, x)) * 0.5 + x
        return layer_norm(self.final_layer_norm, x)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.layer_norm = _ln(cfg, cfg.feature_projection_input_dim)
        self.projection = nn.Linear(cfg.feature_projection_input_dim,
                                    cfg.hidden_size)


class Wav2Vec2Bert(nn.Module):
    """[B, L, 160] features (+ bool [B, L] mask) -> fp32 [B, L, vocab]."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_projection = FeatureProjection(cfg)
        self.layers = nn.ModuleList(ConformerLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def forward(self, input_features: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32,
                attention_impl: str = "auto") -> torch.Tensor:
        impl = resolve_attention_impl(attention_impl, input_features.device)
        B, L, _ = input_features.shape
        if attention_mask is None:
            attention_mask = torch.ones(B, L, dtype=torch.bool,
                                        device=input_features.device)
        pad_mask = attention_mask.float()
        fp = self.feature_projection
        x = input_features.to(dtype)
        x = dense(fp.projection, layer_norm(fp.layer_norm, x))
        # Zero padded positions once at encoder entry (HF semantics).
        x = x * pad_mask[..., None].to(dtype)
        attn_bias = ((1.0 - pad_mask) * -1e9)[:, None, None, :]
        for layer in self.layers:
            x = layer(x, attn_bias, pad_mask, impl)
        return dense(self.lm_head, x.float())


def build_synthetic(cfg: W2VBertConfig, device: torch.device,
                    seed: int = 0) -> Wav2Vec2Bert:
    """Randomly initialised model made directly on ``device`` (the JAX
    package's synthetic mode): dense and conv kernels and distance
    embeddings ~ N(0, 0.02), biases 0, LayerNorms identity. Draws from
    an explicit generator seeded with ``seed``; the values differ from
    the JAX package's (another generator), the distributions do not."""
    with torch.device("meta"):
        model = Wav2Vec2Bert(cfg)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layer_norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model.eval()


def params_from_jax(params_np: Dict[str, Any], cfg: W2VBertConfig
                    ) -> Dict[str, torch.Tensor]:
    """The JAX param pytree (leaves as numpy arrays) -> a state dict of
    :class:`Wav2Vec2Bert`. Splits the stacked leading layer axis;
    ``kernel [in, out]`` -> ``weight [out, in]``; the depthwise kernel
    ``[K, H]`` -> ``[H, 1, K]``; LayerNorm ``scale`` -> ``weight``."""
    out: Dict[str, torch.Tensor] = {}

    def leaf(prefix: str, name: str, arr: np.ndarray) -> None:
        if name == "kernel":
            key = "weight"
            arr = (arr.T[:, None, :] if prefix.endswith("depthwise_conv")
                   else arr.T)
        elif name == "scale":
            key = "weight"
        elif name in ("bias", "distance_embedding"):
            key = name
        elif name == "kernel_q":
            raise NotImplementedError(
                "int8-quantized params are not ported yet (ROADMAP.md, "
                "Queue 1: int8 quant.py)")
        else:
            raise ValueError(f"unexpected param {prefix}.{name}")
        out[f"{prefix}.{key}" if prefix else key] = torch.tensor(
            np.asarray(arr), dtype=torch.float32)

    def walk(tree: Dict[str, Any], prefix: str, layer=None) -> None:
        for name, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, f"{prefix}.{name}" if prefix else name, layer)
            else:
                arr = np.asarray(sub)
                leaf(prefix, name, arr if layer is None else arr[layer])

    walk(params_np["feature_projection"], "feature_projection")
    walk(params_np["lm_head"], "lm_head")
    for i in range(cfg.num_hidden_layers):
        walk(params_np["layers"], f"layers.{i}", layer=i)
    return out


def greedy_ctc_ids(logits: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   pad_id: int = 0) -> torch.Tensor:
    """Frame-level argmax; padded frames forced to the blank/pad id so
    host-side decoding can treat the batch uniformly."""
    ids = torch.argmax(logits, dim=-1)
    if mask is not None:
        ids = torch.where(mask, ids, torch.full_like(ids, pad_id))
    return ids
