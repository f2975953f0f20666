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
- int8 W8A8 (``quantization: int8``): :func:`quantize_model` swaps the
  reference's set of dense layers for :class:`~.quant.QuantLinear`,
  which ``dense`` runs through ``quant.dense_int8``.
- Tensor and sequence parallel (parallel/mesh.py ``shard_params``, which
  calls :meth:`Wav2Vec2Bert.set_parallel`): over a 'model' group each
  rank runs H/tp heads and FFN/tp columns, with a sum after the
  row-parallel products; over a 'seq' group each rank runs 1/sp of the
  frames and gathers keys, values and the conv's input where attention and
  the depthwise conv need the whole sequence, then the logits.
- CUDA graphs: inference on a CUDA device (autograd off, no parallel
  groups, no ``remat``) replays one captured graph per input shape
  instead of launching each of the encoder's kernels from Python
  (:meth:`Wav2Vec2Bert.forward`; the graphs' capture and replay live in
  ``models/cuda_graphs.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from audio_processor_tpu_torch.models import cuda_graphs
from audio_processor_tpu_torch.models.flash_attention import flash_attention
from audio_processor_tpu_torch.models.flash_rel_attention import (
    flash_rel_attention,
)
from audio_processor_tpu_torch.models.quant import (
    QuantLinear, dense_int8, is_quantized, quantize_linears,
)
from audio_processor_tpu_torch.obs import profiler
from audio_processor_tpu_torch.parallel.collectives import (
    copy_to_group, gather_partial, gather_replicated, group_rank, group_size,
    reduce_from_group,
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

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> "W2VBertConfig":
        """From an HF ``Wav2Vec2BertConfig`` as its ``config.json`` dict.
        A field the file leaves out takes this class's default, which is
        HF's; a null ``pad_token_id`` is 0 (the CTC blank)."""
        kw = {f.name: hf[f.name] for f in dataclasses.fields(cls)
              if f.name in hf}
        kw["pad_token_id"] = hf.get("pad_token_id") or 0
        return cls(**kw)


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


def dense(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b in x's dtype; the fp32 params are cast here. An int8
    layer runs the W8A8 product."""
    if isinstance(lin, QuantLinear):
        return dense_int8(lin, x)
    b = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), b)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32, returned in x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def _ln(cfg: W2VBertConfig, d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class ParallelGroups(NamedTuple):
    """The process groups a sharded model computes over (None: no split):
    'model' splits heads and FFN columns, 'seq' splits frames."""

    model: Any = None
    seq: Any = None


def row_parallel(lin: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel product: this rank's input columns times its slice
    of the weight, summed over ``group``, then the (replicated) bias."""
    y = reduce_from_group(F.linear(x, lin.weight.to(x.dtype)), group)
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


class FeedForward(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size,
                                      cfg.hidden_size)
        self.tp = None          # 'model' group: FFN/tp columns per rank

    def forward(self, x):
        if self.tp is None:
            return dense(self.output_dense,
                         F.silu(dense(self.intermediate_dense, x)))
        h = F.silu(dense(self.intermediate_dense, copy_to_group(x, self.tp)))
        return row_parallel(self.output_dense, h, self.tp)


# Unbounded: a captured CUDA graph reads a cached index by its address,
# so an entry must never be evicted (one per attention length and offset).
@functools.lru_cache(maxsize=None)
def _distance_index(q_len: int, k_len: int, q_offset: int, left: int,
                    right: int, device: torch.device) -> torch.Tensor:
    """Static [Lq, Lk] map: (query i, key j) -> clipped-distance bucket,
    the queries at frames q_offset .. q_offset+Lq-1 of the keys'. Made
    outside inference mode: the cache outlives the call, and an inference
    tensor could not be saved for a later backward."""
    with torch.inference_mode(False):
        qpos = torch.arange(q_offset, q_offset + q_len, device=device)
        kpos = torch.arange(k_len, device=device)
        return (kpos[None, :] - qpos[:, None]).clamp(-left, right) + left


def _relative_bias(cfg: W2VBertConfig, q: torch.Tensor, E: torch.Tensor,
                   out_dtype: torch.dtype, k_len: Optional[int] = None,
                   q_offset: int = 0) -> torch.Tensor:
    """Unscaled relative_key bias rel[b,h,l,m] = q_l . E[clip(m-l)] as
    [B, H, Lq, Lk] in ``out_dtype``: the bucket logits q . E^T (fp32
    accumulation) rounded to ``out_dtype``, then gathered with the
    static distance index (rounding commutes with the gather). Keys
    default to the queries' frames; under sequence parallel the local
    queries start at ``q_offset`` of ``k_len`` gathered keys."""
    B, H, L, _ = q.shape
    Lk = L if k_len is None else k_len
    idx = _distance_index(L, Lk, q_offset, cfg.left_max_position_embeddings,
                          cfg.right_max_position_embeddings, q.device)
    srel = (q.float() @ E.float().T).to(out_dtype)       # [B, H, L, P]
    return srel.gather(3, idx.expand(B, H, L, Lk))


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
        self.tp = None          # 'model' group: H/tp heads per rank
        self.sp = None          # 'seq' group: 1/sp of the frames per rank

    def _heads(self, lin, x):
        B, L, _ = x.shape
        return dense(lin, x).view(B, L, -1, self.cfg.head_size) \
            .transpose(1, 2).contiguous()

    def forward(self, x, attn_bias, kv_mask, impl: str):
        B, L, H = x.shape
        cfg = self.cfg
        E = self.distance_embedding
        if self.tp is not None:
            # Replicated inputs into this rank's heads: their gradients
            # (and the distance embedding's) sum over the 'model' group.
            x, E = copy_to_group(x, self.tp), copy_to_group(E, self.tp)
        q = self._heads(self.linear_q, x)                # [B, nh, L, hd]
        k = self._heads(self.linear_k, x)
        v = self._heads(self.linear_v, x)
        q_offset = 0
        if self.sp is not None:
            # Local query frames against every frame's keys and values.
            q_offset = group_rank(self.sp) * L
            k = gather_partial(k, 2, self.sp)
            v = gather_partial(v, 2, self.sp)
        scale = 1.0 / math.sqrt(cfg.head_size)
        left, P = cfg.left_max_position_embeddings, cfg.num_positions
        E = E.to(x.dtype)                                # [P, hd]
        kernel = (impl in KERNEL_L_MULTIPLE and self.sp is None
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
                + _relative_bias(cfg, q, E, torch.float32, k.shape[2],
                                 q_offset) * scale \
                + attn_bias
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = (probs.float() @ v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(B, L, -1)
        if self.tp is not None:
            return row_parallel(self.linear_out, out, self.tp)
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
        self.sp = None          # 'seq' group: 1/sp of the frames per rank

    def forward(self, x, pad_mask):
        x = layer_norm(self.layer_norm, x)
        x = x * pad_mask[..., None].to(x.dtype)
        a, g = dense(self.pointwise_conv1, x).chunk(2, dim=-1)
        x = a * torch.sigmoid(g)                                 # GLU
        K = self.depthwise_conv.kernel_size[0]
        L = x.shape[1]
        if self.sp is None:
            xt = F.pad(x.transpose(1, 2), (K - 1, 0))            # causal
        else:
            # The K-1 frames before this rank's come from the ranks
            # before it: gather the sequence, keep this rank's window.
            full = F.pad(gather_partial(x, 1, self.sp).transpose(1, 2),
                         (K - 1, 0))
            xt = full[:, :, group_rank(self.sp) * L:][:, :, :L + K - 1]
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


class ConformerEncoder(nn.Module):
    """The conformer stack without a head: feature projection and
    ``num_hidden_layers`` conformer layers (:meth:`_body`), and
    :meth:`forward`, which on the card replays a CUDA graph per
    :meth:`graph_key` (``models/cuda_graphs.py``: the graphs, their pool
    and their replays). A subclass's :meth:`_encode` puts
    its head on the body: the CTC head (:class:`Wav2Vec2Bert`) or the
    speech-to-text encoder's tail and length adaptor
    (``models/seamless_s2t.py``)."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_projection = FeatureProjection(cfg)
        self.layers = nn.ModuleList(ConformerLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.parallel = ParallelGroups()
        self._graphs = cuda_graphs.GraphCache()

    def set_parallel(self, groups: ParallelGroups) -> None:
        """Compute over ``groups`` from now on (parallel/mesh.py
        ``shard_params``, which also slices the weights for 'model')."""
        if groups.model is not None and is_quantized(self):
            raise ValueError("an int8 model does not run tensor parallel")
        self.parallel = groups
        for layer in self.layers:
            layer.self_attn.tp = layer.ffn1.tp = layer.ffn2.tp = groups.model
            layer.self_attn.sp = layer.conv_module.sp = groups.seq

    def forward(self, input_features: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32,
                attention_impl: str = "auto",
                remat: bool = False) -> torch.Tensor:
        """``remat`` recomputes each conformer layer in the backward pass
        instead of keeping its activations (the JAX package's
        ``jax.checkpoint`` per layer): the same logits and gradients, one
        layer's activations alive at a time.

        Under sequence parallel every rank passes the whole rows; each
        keeps its 1/sp of the frames (the frames padded, masked, to a
        multiple of sp) and the logits come back whole on every rank.

        A CUDA input with autograd off, no parallel groups and no
        ``remat`` runs as a CUDA graph, in span ``encoder.graph`` (``mode``
        capture, replay or eager). The first call of a key
        (:meth:`graph_key`) runs eagerly and returns that result, then
        captures the key on a side stream; a later call copies its inputs
        into the graph's, replays it on the current stream and returns a
        copy of its logits. A key whose capture fails stays eager. Every
        other call runs eagerly, outside the span."""
        impl = resolve_attention_impl(attention_impl, input_features.device)
        B, L, _ = input_features.shape
        if attention_mask is None:
            attention_mask = torch.ones(B, L, dtype=torch.bool,
                                        device=input_features.device)
        if not self.graphable(input_features, remat):
            return self._encode(input_features, attention_mask, dtype, impl,
                                remat)
        with profiler.span("encoder.graph", rows=B, frames=L) as sp:
            logits, mode = self._graph_forward(input_features,
                                               attention_mask, dtype, impl)
            if sp is not None:
                sp.attrs["mode"] = mode
        return logits

    def graphable(self, x: torch.Tensor, remat: bool = False) -> bool:
        """Whether forward on ``x`` may run as a CUDA graph."""
        return (x.is_cuda and not torch.is_grad_enabled() and not remat
                and all(g is None for g in self.parallel))

    def graph_key(self, x: torch.Tensor, mask: torch.Tensor,
                  dtype: torch.dtype, impl: str) -> tuple:
        """A graph's key: device, input shapes and dtypes, compute dtype,
        attention path, and the storage of every parameter and buffer. A
        tensor reassigned to other storage makes another key; an in-place
        update does not, and a replay reads it."""
        return (x.device, tuple(x.shape), x.dtype, tuple(mask.shape),
                mask.dtype, dtype, impl, cuda_graphs.storage_key(self))

    def _graph_forward(self, x, mask, dtype, impl):
        key = self.graph_key(x, mask, dtype, impl)
        dg = self._graphs.on(x.device, key[-1])
        g = dg.entries.get(key, False)
        if g is None:
            return self._encode(x, mask, dtype, impl), "eager"
        if g is False:
            # The eager run first fills the lazy state (kernel attributes,
            # library handles, cached indexes) that a capture cannot make.
            logits = self._encode(x, mask, dtype, impl)
            g = dg.capture(dg.entries, key,
                           lambda f, m: self._encode(f, m, dtype, impl),
                           f"the encoder at {tuple(x.shape)}", like=(x, mask))
            return logits, "capture" if g else "eager"
        return dg.replay(g, x, mask), "replay"

    def _encode(self, input_features: torch.Tensor,
                attention_mask: torch.Tensor, dtype: torch.dtype, impl: str,
                remat: bool = False) -> torch.Tensor:
        """The eager forward (forward's arguments resolved): the body and
        the subclass's head."""
        raise NotImplementedError

    def _body(self, input_features: torch.Tensor,
              attention_mask: torch.Tensor, dtype: torch.dtype, impl: str,
              remat: bool = False) -> torch.Tensor:
        """Feature projection and every conformer layer: [B, L, H] in
        ``dtype`` (this rank's frames under sequence parallel)."""
        B, L, _ = input_features.shape
        pad_mask = attention_mask.float()
        x = input_features
        sp = self.parallel.seq
        if sp is not None:
            n = group_size(sp)
            pad = (-L) % n
            x = F.pad(x, (0, 0, 0, pad))
            pad_mask = F.pad(pad_mask, (0, pad))
        attn_bias = ((1.0 - pad_mask) * -1e9)[:, None, None, :]
        if sp is not None:
            Ll = (L + pad) // n
            s = group_rank(sp) * Ll
            x, pad_mask = x[:, s:s + Ll], pad_mask[:, s:s + Ll]
        fp = self.feature_projection
        x = dense(fp.projection, layer_norm(fp.layer_norm, x.to(dtype)))
        # Zero padded positions once at encoder entry (HF semantics).
        x = x * pad_mask[..., None].to(dtype)
        for layer in self.layers:
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, attn_bias, pad_mask, impl, use_reentrant=False)
            else:
                x = layer(x, attn_bias, pad_mask, impl)
        return x


class Wav2Vec2Bert(ConformerEncoder):
    """[B, L, 160] features (+ bool [B, L] mask) -> fp32 [B, L, vocab]."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def _encode(self, input_features: torch.Tensor,
                attention_mask: torch.Tensor, dtype: torch.dtype, impl: str,
                remat: bool = False) -> torch.Tensor:
        """The encoder's eager body and its CTC head."""
        x = self._body(input_features, attention_mask, dtype, impl, remat)
        logits = dense(self.lm_head, x.float())
        sp = self.parallel.seq
        if sp is not None:
            L = input_features.shape[1]
            logits = gather_replicated(logits, 1, sp)[:, :L]
        return logits


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


# The dense layers int8 mode quantizes, per conformer layer (the
# reference's quantize_params): ffn1/ffn2, attention q/k/v/out and the two
# pointwise convs. The feature projection, lm_head, LayerNorms, depthwise
# conv and distance embeddings stay fp32.
QUANTIZED = tuple(
    [f"{ffn}.{part}" for ffn in ("ffn1", "ffn2")
     for part in ("intermediate_dense", "output_dense")]
    + [f"self_attn.linear_{p}" for p in ("q", "k", "v", "out")]
    + ["conv_module.pointwise_conv1", "conv_module.pointwise_conv2"])


def quantize_model(model: Wav2Vec2Bert) -> Wav2Vec2Bert:
    """An int8 W8A8 copy of ``model`` on its device: the ``QUANTIZED``
    layers become int8, every other tensor is shared with ``model``,
    which stays as it was. A model that is already int8 is returned."""
    if is_quantized(model):
        return model
    with torch.device("meta"):
        q = Wav2Vec2Bert(model.cfg)
    q.load_state_dict(model.state_dict(), assign=True)
    quantize_linears(q, [f"layers.{i}.{name}"
                         for i in range(model.cfg.num_hidden_layers)
                         for name in QUANTIZED])
    return q.eval()


def params_from_jax(params_np: Dict[str, Any], cfg: W2VBertConfig
                    ) -> Dict[str, torch.Tensor]:
    """The JAX param pytree (leaves as numpy arrays) -> a state dict of
    :class:`Wav2Vec2Bert` (of :func:`quantize_model`'s model where the
    tree went through the reference's ``quantize_params``). Splits the
    stacked leading layer axis; ``kernel [in, out]`` -> ``weight [out,
    in]``, int8 ``kernel_q [in, out]`` -> ``weight_q [out, in]`` beside
    its per-channel ``scale``; the depthwise kernel ``[K, H]`` -> ``[H, 1,
    K]``; LayerNorm ``scale`` -> ``weight``."""
    out: Dict[str, torch.Tensor] = {}

    def leaf(prefix: str, name: str, arr: np.ndarray,
             quantized: bool) -> None:
        dtype = torch.float32
        if name == "kernel":
            key = "weight"
            arr = (arr.T[:, None, :] if prefix.endswith("depthwise_conv")
                   else arr.T)
        elif name == "kernel_q":
            key, arr, dtype = "weight_q", arr.T, torch.int8
        elif name == "scale":
            key = "scale" if quantized else "weight"
        elif name in ("bias", "distance_embedding"):
            key = name
        else:
            raise ValueError(f"unexpected param {prefix}.{name}")
        out[f"{prefix}.{key}" if prefix else key] = torch.tensor(
            np.asarray(arr), dtype=dtype)

    def walk(tree: Dict[str, Any], prefix: str, layer=None) -> None:
        for name, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, f"{prefix}.{name}" if prefix else name, layer)
            else:
                arr = np.asarray(sub)
                leaf(prefix, name, arr if layer is None else arr[layer],
                     "kernel_q" in tree)

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
