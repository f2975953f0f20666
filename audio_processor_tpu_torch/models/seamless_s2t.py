"""SeamlessM4T v2 speech-to-text: the w2v-BERT 2.0 conformer, its length
adaptor and an autoregressive text decoder, decoded greedily.

Architecture-compatible with HF ``SeamlessM4Tv2ForSpeechToText``
(transformers 4.57, ``models/seamless_m4t_v2``), whose defaults are the
published facebook/seamless-m4t-v2-large:

- :class:`SpeechEncoder`: the w2v-BERT 2.0 conformer stack of
  ``models/wav2vec2bert.py`` (the ``flash_rel`` kernel, its CUDA graph per
  shape) without a CTC head, then a final LayerNorm, an intermediate ReLU
  FFN added as ``x + 0.5 ffn(x)``, the length adaptor (LayerNorm, two
  stride-8 Conv1d + GLU branches, plain multi-head attention under the
  subsampled padding mask, a ReLU FFN) and ``inner_layer_norm``. The whole
  speech encoder is one graph per input shape.
- :class:`TextDecoder`: pre-LN layers of self-attention, cross-attention
  and a ReLU FFN with biases; embeddings scaled by sqrt(hidden) plus
  sinusoidal positions offset by ``pad_token_id + 1``; a final LayerNorm
  and an LM head tied to the embedding.

Generation (:meth:`TextDecoder.generate`): the prompt is
``decoder_start_token_id`` then the target-language token; each row decodes
greedily to ``</s>`` or to its cap, whichever comes first, and never emits
the pad id (fairseq2's generator masks it). The cap is
:meth:`DecodeRule.cap` of the row's adaptor frames. The loop runs to the
batch's largest cap, known on the host from the lengths, and freezes
finished rows on the device, so no step waits on the card. The
self-attention K/V cache is static and preallocated, the cross-attention
K/V is computed once per device batch (span ``decoder.cross_kv``), and on
a CUDA device every position of the loop (span ``decoder.loop``) replays
one CUDA graph of a step per (rows, adaptor frames, dtype, target
language) key (span ``decoder.graph``, ``mode`` capture / replay / eager,
``attn_launches``; the graphs' capture and replay live in
``models/cuda_graphs.py``). Each layer's self- and cross-attention is one
launch of ``models/decode_attention.py``'s kernel, which writes the step's
key and value into the cache at the position held on the device and
attends over positions 0 .. pos.

Departures from HF, each so that a row's result is its result alone:
padded encoder frames are zeroed after the adaptor's LayerNorms, before
its strided convolutions (HF convolves whatever the padded frames hold;
alone, a row has zeros there). The strided convolutions run as one
product over frames reshaped by the stride (kernel = stride).

Precision: the compute dtype is a :meth:`SeamlessS2T.forward`-time
argument as in the CTC model. The decoder's weights are cast once, at
load, by :meth:`SeamlessS2T.cast_decoder` (LayerNorms stay fp32), so a step
reads them without a cast; the speech encoder keeps fp32 parameters and
casts per call like ``Wav2Vec2Bert``. Logits come out in the compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Any, Callable, Collection, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_processor_tpu_torch.dsp.fbank import (
    FRAME_LENGTH, HOP_LENGTH, STRIDE,
)
from audio_processor_tpu_torch.models import _cuda_call, cuda_graphs
from audio_processor_tpu_torch.models.decode_attention import (
    decode_attention,
)
from audio_processor_tpu_torch.models.quant import (
    QuantLinear, is_quantized, quantize_linears,
)
from audio_processor_tpu_torch.models.wav2vec2bert import (
    QUANTIZED as ENCODER_QUANTIZED, ConformerEncoder, ParallelGroups,
    W2VBertConfig, dense, layer_norm,
)
from audio_processor_tpu_torch.obs import profiler

MODEL_TYPE = "seamless_m4t_v2_s2t"
CTC_MODEL_TYPE = "w2v_bert_ctc"    # asr_model_type's default
CACHE_ALIGN = 32      # the self K/V cache's length is a multiple of this
NEG = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class S2TConfig:
    # The speech encoder: w2v-BERT 2.0's conformer (Wav2Vec2Bert's names).
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    conv_depthwise_kernel_size: int = 31
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    layer_norm_eps: float = 1e-5
    # The length adaptor.
    adaptor_kernel_size: int = 8
    adaptor_stride: int = 8
    num_adapter_layers: int = 1
    # The text decoder.
    decoder_layers: int = 24
    decoder_attention_heads: int = 16
    decoder_ffn_dim: int = 8192
    vocab_size: int = 256102
    max_position_embeddings: int = 4096
    pad_token_id: int = 0
    eos_token_id: int = 3
    decoder_start_token_id: int = 3
    scale_embedding: bool = True

    def __post_init__(self):
        if self.adaptor_kernel_size != self.adaptor_stride:
            raise ValueError("the length adaptor runs kernel = stride only "
                             f"(got {self.adaptor_kernel_size} and "
                             f"{self.adaptor_stride})")

    @property
    def encoder(self) -> W2VBertConfig:
        return W2VBertConfig(
            vocab_size=0, **{f.name: getattr(self, f.name)
                             for f in dataclasses.fields(W2VBertConfig)
                             if f.name not in ("vocab_size", "pad_token_id")})

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "S2TConfig":
        """From a dict with these fields' names; other keys are ignored."""
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


@dataclasses.dataclass(frozen=True)
class DecodeRule:
    """A row decodes at most ``min(max_new_tokens, ceil(a * f) + b)``
    tokens, f its adaptor frames: fairseq2's linear-in-source length
    rule. ``a`` is held as an exact fraction, so the cap is integer
    arithmetic wherever it is computed."""

    max_new_tokens: int = 256
    a: float = 0.6
    b: int = 8

    def __post_init__(self):
        if self.max_new_tokens < 1 or self.a < 0 or self.b < 0:
            raise ValueError(f"bad decode-length rule {self}")

    def cap(self, adaptor_frames: int) -> int:
        f = Fraction(self.a).limit_denominator(10 ** 6)
        n = -(-(f.numerator * int(adaptor_frames)) // f.denominator)
        return min(self.max_new_tokens, n + int(self.b))


def rule_from_config(config) -> DecodeRule:
    """The decode-length rule of a pipeline config (``s2t_max_new_tokens``,
    ``s2t_len_a``, ``s2t_len_b``; published and fairseq2 defaults)."""
    return DecodeRule(int(config.get("s2t_max_new_tokens", 256)),
                      float(config.get("s2t_len_a", 0.6)),
                      int(config.get("s2t_len_b", 8)))


def check_pipeline_config(config, serve: bool = False) -> bool:
    """Refuse what the speech-to-text model does not run, with a clear
    error: word timestamps (it emits no frame-aligned ids), the message
    path and serving (no mono-rows program), unfused acoustic features,
    and a bad decode-length rule. Returns whether the config selects it
    (``asr_model_type``)."""
    kind = str(config.get("asr_model_type", CTC_MODEL_TYPE))
    if kind not in (CTC_MODEL_TYPE, MODEL_TYPE):
        raise ValueError(f"unknown asr_model_type {kind!r} (expected "
                         f"{CTC_MODEL_TYPE!r} or {MODEL_TYPE!r})")
    if kind != MODEL_TYPE:
        return False
    refused = [
        (config.get("emit_word_timestamps", False),
         "emit_word_timestamps (word times come from CTC frames)"),
        (config.get("enable_message_path", False),
         "enable_message_path (the message path transcribes mono rows)"),
        (serve, "serving (the server transcribes through the mono-rows "
                "path)"),
        (not config.get("fuse_acoustic_features", True),
         "fuse_acoustic_features: false (the unfused path runs mono rows)"),
    ]
    for on, what in refused:
        if on:
            raise ValueError(f"asr_model_type {MODEL_TYPE!r} does not run "
                             f"{what}")
    rule_from_config(config)
    return True


def encoder_frames(n_samples: int) -> int:
    """Valid encoder frames of a row of ``n_samples`` 16 kHz samples (the
    frontend's mask)."""
    return max(0, 1 + (int(n_samples) - FRAME_LENGTH) // HOP_LENGTH) \
        // STRIDE


def adaptor_frames(frames: int, stride: int = 8) -> int:
    """Valid adaptor frames of ``frames`` encoder frames (kernel = stride,
    padding stride // 2 on both sides)."""
    return int(frames) // stride + 1


def sinusoids(n: int, dim: int, padding_idx: int) -> torch.Tensor:
    """HF's (tensor2tensor's) sinusoidal table [n, dim], fp32, the row of
    ``padding_idx`` zero."""
    half = dim // 2
    step = math.log(10000) / (half - 1)
    freq = torch.exp(torch.arange(half, dtype=torch.int64).float() * -step)
    ang = torch.arange(n, dtype=torch.int64).float()[:, None] * freq[None]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).view(n, -1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros(n, 1)], dim=1)
    emb[padding_idx] = 0
    return emb


def _dense(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """:func:`dense`, with an int8 product of 16 rows or fewer on CUDA
    padded to 17 rows (``torch._int_mm`` takes more than 16)."""
    if isinstance(lin, QuantLinear) and x.is_cuda:
        n = x.numel() // x.shape[-1]
        if n <= 16:
            y = dense(lin, F.pad(x.reshape(n, -1), (0, 0, 0, 17 - n)))
            return y[:n].reshape(*x.shape[:-1], -1)
    return dense(lin, x)


def _heads(lin: nn.Module, x: torch.Tensor, nh: int) -> torch.Tensor:
    """[B, L, H] -> [B, nh, L, H/nh] of ``lin(x)``."""
    B, L, H = x.shape
    return _dense(lin, x).view(B, L, nh, -1).transpose(1, 2)


class ReluFFN(nn.Module):
    def __init__(self, h: int, f: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(h, f)
        self.output_dense = nn.Linear(f, h)

    def forward(self, x):
        return _dense(self.output_dense,
                      F.relu(_dense(self.intermediate_dense, x)))


class AdapterAttention(nn.Module):
    """The adaptor's multi-head attention: no position terms."""

    def __init__(self, h: int, nh: int):
        super().__init__()
        self.nh = nh
        self.linear_q = nn.Linear(h, h)
        self.linear_k = nn.Linear(h, h)
        self.linear_v = nn.Linear(h, h)
        self.linear_out = nn.Linear(h, h)

    def forward(self, x, bias):
        q, k, v = (_heads(lin, x, self.nh) for lin in
                   (self.linear_q, self.linear_k, self.linear_v))
        scale = 1.0 / math.sqrt(q.shape[-1])
        s = (q.float() @ k.float().transpose(-1, -2)) * scale + bias
        p = torch.softmax(s, dim=-1).to(x.dtype)
        out = (p.float() @ v.float()).to(x.dtype)
        B, nh, L, d = out.shape
        return _dense(self.linear_out, out.transpose(1, 2).reshape(B, L, -1))


def strided_conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (kernel = stride = s, padding s // 2) over [B, L, C]
    frames, as one product: the padded frames reshaped to [B, L // s + 1,
    s * C] times the kernel laid out frame-major."""
    B, L, C = x.shape
    s = conv.stride[0]
    La = L // s + 1
    left = s // 2
    right = s * La - L - left
    xp = F.pad(x, (0, 0, left, max(right, 0)))[:, :s * La]
    w = conv.weight.to(x.dtype).permute(0, 2, 1).reshape(conv.out_channels,
                                                         s * C)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.linear(xp.reshape(B, La, s * C), w, b)


class AdapterLayer(nn.Module):
    def __init__(self, cfg: S2TConfig):
        super().__init__()
        h, k, s = cfg.hidden_size, cfg.adaptor_kernel_size, cfg.adaptor_stride
        self.stride = s
        self.residual_layer_norm = nn.LayerNorm(h)
        self.residual_conv = nn.Conv1d(h, 2 * h, k, stride=s, padding=s // 2)
        self.self_attn_layer_norm = nn.LayerNorm(h)
        self.self_attn_conv = nn.Conv1d(h, 2 * h, k, stride=s,
                                        padding=s // 2)
        self.self_attn = AdapterAttention(h, cfg.num_attention_heads)
        self.ffn_layer_norm = nn.LayerNorm(h)
        self.ffn = ReluFFN(h, cfg.intermediate_size)

    def forward(self, x, pad_mask):
        """[B, L, H] and its bool [B, L] mask -> [B, L // s + 1, H] and its
        mask."""
        keep = pad_mask[..., None].to(x.dtype)
        r = layer_norm(self.residual_layer_norm, x) * keep
        r = F.glu(strided_conv(self.residual_conv, r), dim=-1)
        a = layer_norm(self.self_attn_layer_norm, x) * keep
        a = F.glu(strided_conv(self.self_attn_conv, a), dim=-1)
        n = pad_mask.sum(dim=1) // self.stride + 1                  # [B]
        mask = torch.arange(a.shape[1], device=x.device)[None] < n[:, None]
        bias = torch.where(mask, 0.0, NEG)[:, None, None, :]
        x = self.self_attn(a, bias) + r
        return x + self.ffn(layer_norm(self.ffn_layer_norm, x)), mask


class SpeechEncoder(ConformerEncoder):
    """[B, L, 160] features (+ bool [B, L] mask) -> [B, L // 8 + 1, H] in
    the compute dtype (:meth:`output_mask` gives its valid frames)."""

    def __init__(self, cfg: S2TConfig):
        super().__init__(cfg.encoder)
        h = cfg.hidden_size
        self.stride = cfg.adaptor_stride
        self.layer_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.intermediate_ffn = ReluFFN(h, cfg.intermediate_size)
        self.adapter = nn.ModuleList(AdapterLayer(cfg) for _ in
                                     range(cfg.num_adapter_layers))
        self.inner_layer_norm = nn.LayerNorm(h)

    def set_parallel(self, groups: ParallelGroups) -> None:
        if any(g is not None for g in groups):
            raise ValueError("the speech-to-text encoder runs on one device")

    def output_mask(self, mask: torch.Tensor) -> torch.Tensor:
        n = mask.sum(dim=1)
        L = mask.shape[1]
        for _ in self.adapter:
            n, L = n // self.stride + 1, L // self.stride + 1
        return torch.arange(L, device=mask.device)[None] < n[:, None]

    def _encode(self, input_features, attention_mask, dtype, impl,
                remat=False):
        x = self._body(input_features, attention_mask, dtype, impl, remat)
        x = layer_norm(self.layer_norm, x)
        x = x + 0.5 * self.intermediate_ffn(x)
        mask = attention_mask
        for layer in self.adapter:
            x, mask = layer(x, mask)
        return layer_norm(self.inner_layer_norm, x)


class DecoderAttention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)


class DecoderFFN(nn.Module):
    def __init__(self, h: int, f: int):
        super().__init__()
        self.fc1 = nn.Linear(h, f)
        self.fc2 = nn.Linear(f, h)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: S2TConfig):
        super().__init__()
        h = cfg.hidden_size
        self.nh = cfg.decoder_attention_heads
        self.scaling = (h // self.nh) ** -0.5
        self.self_attn = DecoderAttention(h)
        self.self_attn_layer_norm = nn.LayerNorm(h)
        self.cross_attention = DecoderAttention(h)
        self.cross_attention_layer_norm = nn.LayerNorm(h)
        self.ffn = DecoderFFN(h, cfg.decoder_ffn_dim)
        self.ffn_layer_norm = nn.LayerNorm(h)

    def step(self, x, k_cache, v_cache, pos, ck, cv, enc_bias):
        """One position of each row: x [B, 1, H]; its key and value go into
        the caches [B, nh, C, d] at ``pos`` (a [1] device tensor), and it
        attends over cache positions 0 .. pos and over the cross K/V under
        ``enc_bias`` [B, F], each in one :func:`decode_attention`."""
        B = x.shape[0]
        sa = self.self_attn
        h = layer_norm(self.self_attn_layer_norm, x)
        o = decode_attention(
            _dense(sa.q_proj, h).view(B, -1), k_cache, v_cache, self.scaling,
            pos=pos, k_new=_dense(sa.k_proj, h).view(B, -1),
            v_new=_dense(sa.v_proj, h).view(B, -1))
        x = x + _dense(sa.out_proj, o.view(B, 1, -1))
        ca = self.cross_attention
        h = layer_norm(self.cross_attention_layer_norm, x)
        o = decode_attention(_dense(ca.q_proj, h).view(B, -1), ck, cv,
                             self.scaling, bias=enc_bias)
        x = x + _dense(ca.out_proj, o.view(B, 1, -1))
        h = layer_norm(self.ffn_layer_norm, x)
        return x + _dense(self.ffn.fc2, F.relu(_dense(self.ffn.fc1, h)))


class _DecodeState:
    """The static buffers of the decode loop of one (rows, adaptor frames,
    dtype) key on one device: self K/V caches, cross K/V, the
    cross-attention bias, the position, each row's input token, cap and
    done flag, the tokens and text flags emitted, and the last step's
    logits; and the key's step graphs by target language, which read and
    write only these. It lives among the decoder's graphs on its device
    (``dg``), so new weight storage drops it with them."""

    def __init__(self, dec: "TextDecoder", rows: int, frames: int,
                 dtype: torch.dtype, dg: cuda_graphs.DeviceGraphs):
        cfg = dec.cfg
        nl, nh = cfg.decoder_layers, cfg.decoder_attention_heads
        d = cfg.hidden_size // nh
        C = dec.cache_len
        with torch.inference_mode(False):   # written in place at any mode
            z = dict(device=dg.device)
            self.k = torch.zeros(nl, rows, nh, C, d, dtype=dtype, **z)
            self.v = torch.zeros_like(self.k)
            self.ck = torch.zeros(nl, rows, nh, frames, d, dtype=dtype, **z)
            self.cv = torch.zeros_like(self.ck)
            self.enc_bias = torch.zeros(rows, frames, **z)
            self.pos = torch.zeros(1, dtype=torch.long, **z)
            self.tok = torch.zeros(rows, dtype=torch.long, **z)
            self.cap = torch.zeros(rows, dtype=torch.long, **z)
            self.done = torch.zeros(rows, dtype=torch.bool, **z)
            n = dec.rule.max_new_tokens
            self.ids = torch.zeros(rows, n, dtype=torch.long, **z)
            self.text = torch.zeros(rows, n, dtype=torch.bool, **z)
            self.logits = torch.zeros(rows, cfg.vocab_size, dtype=dtype, **z)
        self.dg = dg
        self.graphs: Dict[int, Optional[cuda_graphs.Graph]] = {}


class TextDecoder(nn.Module):
    """The text decoder with its greedy loop (:meth:`generate`)."""

    def __init__(self, cfg: S2TConfig, rule: DecodeRule = DecodeRule()):
        super().__init__()
        self.cfg = cfg
        self.rule = rule
        h = cfg.hidden_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, h)
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in
                                    range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(h)
        self.embed_scale = math.sqrt(h) if cfg.scale_embedding else 1.0
        self.cache_len = -(-(rule.max_new_tokens + 1) // CACHE_ALIGN) \
            * CACHE_ALIGN
        if self.cache_len > cfg.max_position_embeddings:
            raise ValueError(f"max_new_tokens {rule.max_new_tokens} needs "
                             "more positions than the model has")
        self._positions: Dict[torch.device, torch.Tensor] = {}
        self._graphs = cuda_graphs.GraphCache()   # loop states, step graphs
        # tap_steps(steps) -> generated-token indices whose logits the loop
        # keeps in ``tapped`` (index -> [B, vocab] clone); None keeps none.
        self.tap_steps: Optional[Callable[[int], Collection[int]]] = None
        self.tapped: Dict[int, torch.Tensor] = {}

    def positions(self, device: torch.device) -> torch.Tensor:
        """The sinusoidal table on ``device``, made once per device."""
        t = self._positions.get(device)
        if t is None:
            cfg = self.cfg
            with torch.inference_mode(False):
                t = sinusoids(self.cache_len + cfg.pad_token_id + 1,
                              cfg.hidden_size, cfg.pad_token_id).to(device)
            self._positions[device] = t
        return t

    def _state(self, rows: int, frames: int, dtype, device) -> _DecodeState:
        """The loop's buffers of this key, made on its first use; a weight
        put in other storage drops every key and its graphs."""
        dg = self._graphs.on(device, cuda_graphs.storage_key(self))
        key = (rows, frames, dtype)
        with dg.lock:
            st = dg.entries.get(key)
            if st is None:
                st = dg.entries[key] = _DecodeState(self, rows, frames,
                                                    dtype, dg)
        return st

    def cross_kv(self, st: _DecodeState, enc: torch.Tensor,
                 enc_mask: torch.Tensor) -> None:
        """Every layer's cross-attention K and V of the adaptor output, and
        the bias of its padded frames, into ``st`` (span
        ``decoder.cross_kv``)."""
        B, La, _ = enc.shape
        with profiler.span("decoder.cross_kv", rows=B, frames=La):
            for i, layer in enumerate(self.layers):
                ca = layer.cross_attention
                st.ck[i].copy_(_heads(ca.k_proj, enc, layer.nh))
                st.cv[i].copy_(_heads(ca.v_proj, enc, layer.nh))
            st.enc_bias.copy_(torch.where(enc_mask, 0.0, NEG))

    def _step(self, st: _DecodeState, lang_id: int) -> None:
        """One position of every row, all on the device: embed the input
        token at ``st.pos``, run the layers, the LM head and the greedy
        choice, record a generated token (position p gives token p - 1)
        for each row still active, and advance."""
        cfg = self.cfg
        pos = st.pos
        dtype = st.k.dtype
        emb = F.embedding(st.tok, self.embed_tokens.weight).float()
        x = emb * self.embed_scale + self.positions(pos.device) \
            .index_select(0, pos + cfg.pad_token_id + 1)
        x = x.to(dtype)[:, None]
        for i, layer in enumerate(self.layers):
            x = layer.step(x, st.k[i], st.v[i], pos, st.ck[i], st.cv[i],
                           st.enc_bias)
        h = layer_norm(self.layer_norm, x)[:, 0]
        st.logits.copy_(F.linear(h, self.embed_tokens.weight.to(dtype)))
        nxt = greedy(st.logits, cfg.pad_token_id)
        g = (pos - 1).clamp(min=0)
        active = (~st.done) & (pos >= 1) & (pos - 1 < st.cap)
        tok = torch.where(active, nxt, cfg.pad_token_id)
        st.ids.index_copy_(1, g, tok[:, None])
        st.text.index_copy_(1, g, (active & (nxt != cfg.eos_token_id))
                            [:, None])
        st.done |= active & (nxt == cfg.eos_token_id)
        st.tok.copy_(torch.where(pos == 0, lang_id, tok))
        st.pos += 1

    def generate(self, enc: torch.Tensor, enc_mask: torch.Tensor,
                 caps: torch.Tensor, steps: int, lang_id: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
        """Greedy decoding of adaptor outputs enc [B, La, H] (bool mask [B,
        La]) for ``steps`` tokens, each row to ``</s>`` or to its cap
        (``caps`` [B] on the device; a row with cap 0 stays idle): (ids [B,
        steps], text [B, steps], the ``decoder.loop`` span's attributes or
        None). ``ids`` holds each row's tokens, ``</s>`` included, then
        pad; ``text`` marks the tokens before ``</s>``."""
        B, La, _ = enc.shape
        st = self._state(B, La, enc.dtype, enc.device)
        self.cross_kv(st, enc, enc_mask)
        return self.decode(st, caps, steps, lang_id)

    def decode(self, st: _DecodeState, caps: torch.Tensor, steps: int,
               lang_id: int):
        """The loop of :meth:`generate` over ``st`` (cross K/V in place),
        in span ``decoder.loop``: positions 0 .. steps, eagerly on the CPU
        or with autograd on, else on the key's step graph
        (:meth:`_graph_loop`)."""
        B = st.tok.shape[0]
        self.reset(st, caps)
        taps = set(self.tap_steps(steps)) if self.tap_steps else set()
        self.tapped = {}
        with profiler.span("decoder.loop", rows=B, steps=steps,
                           cap_max=steps) as sp:
            if st.pos.device.type != "cuda" or torch.is_grad_enabled():
                for p in range(steps + 1):
                    self._step(st, lang_id)
                    self._tap(st, p, taps)
            else:
                self._graph_loop(st, steps, lang_id, taps)
            attrs = None if sp is None else sp.attrs
            ids, text = st.ids[:, :steps].clone(), st.text[:, :steps].clone()
        return ids, text, attrs

    def reset(self, st: _DecodeState, caps: torch.Tensor) -> None:
        """Start ``st`` on the prompt's first token with these caps."""
        st.pos.zero_()
        st.tok.fill_(self.cfg.decoder_start_token_id)
        st.done.zero_()
        st.cap.copy_(caps)
        st.ids.fill_(self.cfg.pad_token_id)
        st.text.zero_()

    def _tap(self, st, pos, taps) -> None:
        if pos - 1 in taps:
            self.tapped[pos - 1] = st.logits.clone()

    def _graph_loop(self, st, steps, lang_id, taps) -> None:
        """Positions 0 .. steps by the step graph of ``lang_id`` in ``st``,
        in span ``decoder.graph``: on the key's first use one eager step,
        the capture, then replays; later, replays only. A key whose capture
        failed runs eagerly. The span's ``attn_launches`` counts the
        decode-attention launches of these steps, a replay's being its
        capture's."""
        B, La = st.ck.shape[1], st.ck.shape[3]
        with profiler.span("decoder.graph", rows=B, frames=La,
                           steps=steps + 1) as sp:
            g = st.graphs.get(lang_id, False)   # False: not yet captured
            mode, launched = ("replay" if g else "eager"), 0
            for p in range(steps + 1):
                if g:
                    st.dg.replay(g)
                    launched += g.launches.get(decode_attention, 0)
                else:
                    launched += self._eager_step(st, lang_id)
                    if g is False:
                        # the eager step filled the lazy state that a
                        # capture cannot make
                        g = st.dg.capture(
                            st.graphs, lang_id,
                            lambda: self._step(st, lang_id),
                            f"a decoder step ({B} rows, {La} frames)")
                        mode = "capture" if g else "eager"
                self._tap(st, p, taps)
            if sp is not None:
                sp.attrs["mode"] = mode
                sp.attrs["attn_launches"] = launched

    def _eager_step(self, st, lang_id) -> int:
        """One eager step; its decode-attention launches (counted on this
        thread alone, then added to the wrappers')."""
        with _cuda_call.tally_launches() as launched:
            self._step(st, lang_id)
        for wrapper, n in launched.items():
            wrapper.launches += n
        return launched.get(decode_attention, 0)


def greedy(logits: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Each row's argmax (the first of equal maxima) over every id but the
    pad id."""
    if pad_id == 0:
        return logits[:, 1:].argmax(dim=-1) + 1
    return logits.index_fill(1, torch.tensor([pad_id], device=logits.device),
                             float("-inf")).argmax(dim=-1)


class SeamlessS2T(nn.Module):
    """The speech encoder and the text decoder. ``cfg`` and ``rule`` give
    the widths and the decode-length rule."""

    def __init__(self, cfg: S2TConfig, rule: DecodeRule = DecodeRule()):
        super().__init__()
        self.cfg = cfg
        self.speech_encoder = SpeechEncoder(cfg)
        self.text_decoder = TextDecoder(cfg, rule)

    @property
    def rule(self) -> DecodeRule:
        return self.text_decoder.rule

    def caps(self, n_samples: Sequence[int]) -> list:
        """Each row's cap from its valid samples."""
        s = self.cfg.adaptor_stride
        return [self.rule.cap(adaptor_frames(encoder_frames(n), s))
                for n in n_samples]

    def cast_decoder(self, dtype: torch.dtype) -> "SeamlessS2T":
        """Cast the decoder's weights to ``dtype`` once (LayerNorms stay
        fp32); int8 layers keep their int8 weights and fp32 scales."""
        for m in self.text_decoder.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.to(dtype)
        return self

    def forward(self, feats: torch.Tensor, mask: torch.Tensor,
                caps: torch.Tensor, steps: int, lang_id: int,
                dtype: torch.dtype = torch.float32,
                attention_impl: str = "auto"):
        """[B, L, 160] features and mask -> (ids [B, steps], text [B,
        steps], the loop span's attributes or None)."""
        enc = self.speech_encoder(feats, mask, dtype=dtype,
                                  attention_impl=attention_impl)
        return self.text_decoder.generate(
            enc, self.speech_encoder.output_mask(mask), caps, steps, lang_id)


def build_synthetic(cfg: S2TConfig, device: torch.device, seed: int = 0,
                    rule: DecodeRule = DecodeRule()) -> SeamlessS2T:
    """Seeded random weights made on ``device`` (the port's synthetic mode:
    dense, conv, distance and token embeddings ~ N(0, 0.02), biases 0,
    LayerNorms identity)."""
    with torch.device("meta"):
        model = SeamlessS2T(cfg, rule)
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


def quantized_names(cfg: S2TConfig) -> list:
    """The linears int8 mode quantizes: the conformer's (as the CTC
    model's), the intermediate FFN's, the adaptor's attention and FFN, and
    every decoder linear. The adaptor's convolutions, the embedding and
    tied LM head, LayerNorms and the feature projection stay float."""
    enc = [f"speech_encoder.layers.{i}.{n}"
           for i in range(cfg.num_hidden_layers) for n in ENCODER_QUANTIZED]
    enc += [f"speech_encoder.intermediate_ffn.{p}"
            for p in ("intermediate_dense", "output_dense")]
    for i in range(cfg.num_adapter_layers):
        a = f"speech_encoder.adapter.{i}"
        enc += [f"{a}.self_attn.linear_{p}" for p in ("q", "k", "v", "out")]
        enc += [f"{a}.ffn.{p}" for p in ("intermediate_dense",
                                         "output_dense")]
    for i in range(cfg.decoder_layers):
        d = f"text_decoder.layers.{i}"
        for att in ("self_attn", "cross_attention"):
            enc += [f"{d}.{att}.{p}_proj" for p in ("q", "k", "v", "out")]
        enc += [f"{d}.ffn.fc1", f"{d}.ffn.fc2"]
    return enc


def quantize_model(model: SeamlessS2T) -> SeamlessS2T:
    """An int8 W8A8 copy of ``model`` (its :func:`quantized_names` layers;
    every other tensor shared). A model already int8 is returned."""
    if is_quantized(model):
        return model
    with torch.device("meta"):
        q = SeamlessS2T(model.cfg, model.rule)
    q.load_state_dict(model.state_dict(), assign=True)
    quantize_linears(q, quantized_names(model.cfg))
    return q.eval()
