"""Plain PyTorch reference of SeamlessM4T v2 speech-to-text: the speech
encoder (w2v-BERT 2.0 conformer, final LayerNorm, intermediate FFN, length
adaptor, inner LayerNorm), the text decoder by a full causal forward over a
given token sequence, the decode-length rule, and detokenization.

Written from HF ``SeamlessM4Tv2ForSpeechToText`` (transformers 4.57.6,
``models/seamless_m4t_v2/modeling_seamless_m4t_v2.py``), not from the
program: no cache, no batching of rows of different lengths, no graphs.
Each row is computed alone at its own valid length, so no padding and no
attention mask enter it; everything runs in fp32 with TF32 off
(:func:`.w2v_bert.no_tf32`). Imports nothing of the program.

Departures from that code, none of which changes a result here:

- ``speech_encoder_chunk_size`` (20,000 frames) is not applied: its chunk
  mask masks nothing below 20,000 frames, and a 25 s chunk has 1,249;
- dropout and layer drop are off (inference);
- decoder positions follow HF's ``create_position_ids_from_input_ids``
  (pad tokens take the pad position and do not count); the generator this
  reference checks never emits the pad id, so positions are 0, 1, ... +
  ``pad_token_id + 1``;
- the adaptor's strided convolutions see zeros beyond the row's frames,
  which is what HF computes for a row alone.

Weights are a dict under the program's state-dict names (the benchmark's
layout, ``harness/batch_s2t.py``); the conformer's come from
:mod:`.w2v_bert`'s helpers, which use the same names.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, Iterable, List, Sequence

import torch
import torch.nn.functional as F

from . import w2v_bert as w2v
from .w2v_bert import _PUNCT, _attention, _conv, _ffn, _lin, _ln, no_tf32

ENC = "speech_encoder"
DEC = "text_decoder"
WORD_START = "▁"


def _relu_ffn(w, p, x):
    return _lin(w, f"{p}.output_dense",
                F.relu(_lin(w, f"{p}.intermediate_dense", x)))


def _ln0(w, name, x):
    """An ``nn.LayerNorm(h)`` of the model (default eps 1e-5)."""
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"],
                        w[f"{name}.bias"], 1e-5)


def _heads(x, nh):
    B, L, H = x.shape
    return x.view(B, L, nh, H // nh).transpose(1, 2)


def _adapter(w, p, m, x):
    """One ``SeamlessM4Tv2ConformerAdapterLayer`` over a row that is valid
    at every frame (no mask)."""
    s = m["adaptor_stride"]
    k = m["adaptor_kernel_size"]

    def conv_glu(name, h):
        y = F.conv1d(h.transpose(1, 2), w[f"{name}.weight"],
                     w[f"{name}.bias"], stride=s, padding=s // 2)
        return F.glu(y, dim=1).transpose(1, 2)

    assert k == s
    res = conv_glu(f"{p}.residual_conv", _ln0(w, f"{p}.residual_layer_norm",
                                               x))
    h = conv_glu(f"{p}.self_attn_conv", _ln0(w, f"{p}.self_attn_layer_norm",
                                              x))
    nh = m["num_attention_heads"]
    q, kk, v = (_heads(_lin(w, f"{p}.self_attn.linear_{n}", h), nh)
                for n in ("q", "k", "v"))
    probs = torch.softmax(q @ kk.transpose(-1, -2)
                          / math.sqrt(q.shape[-1]), dim=-1)
    B, _, L, d = q.shape
    att = (probs @ v).transpose(1, 2).reshape(B, L, nh * d)
    h = _lin(w, f"{p}.self_attn.linear_out", att) + res
    return h + _relu_ffn(w, f"{p}.ffn", _ln0(w, f"{p}.ffn_layer_norm", h))


def speech_encoder(w: Dict[str, torch.Tensor], m: Dict,
                   feats: torch.Tensor) -> torch.Tensor:
    """[B, L, 160] features of B rows valid over all L frames -> fp32
    adaptor output [B, L // 8 + 1, hidden]."""
    eps = m["layer_norm_eps"]
    with no_tf32():
        x = _lin(w, f"{ENC}.feature_projection.projection",
                 _ln(w, f"{ENC}.feature_projection.layer_norm",
                     feats.float(), eps))
        for i in range(m["num_hidden_layers"]):
            p = f"{ENC}.layers.{i}"
            x = x + 0.5 * _ffn(w, f"{p}.ffn1",
                               _ln(w, f"{p}.ffn1_layer_norm", x, eps))
            x = x + _attention(w, f"{p}.self_attn", m,
                               _ln(w, f"{p}.self_attn_layer_norm", x, eps))
            x = x + _conv(w, f"{p}.conv_module", m, x, eps)
            x = x + 0.5 * _ffn(w, f"{p}.ffn2",
                               _ln(w, f"{p}.ffn2_layer_norm", x, eps))
            x = _ln(w, f"{p}.final_layer_norm", x, eps)
        x = _ln(w, f"{ENC}.layer_norm", x, eps)
        x = x + 0.5 * _relu_ffn(w, f"{ENC}.intermediate_ffn", x)
        for i in range(m["num_adapter_layers"]):
            x = _adapter(w, f"{ENC}.adapter.{i}", m, x)
        return _ln0(w, f"{ENC}.inner_layer_norm", x)


def sinusoids(n: int, dim: int, padding_idx: int) -> torch.Tensor:
    """``SeamlessM4Tv2SinusoidalPositionalEmbedding.get_embedding``."""
    half = dim // 2
    e = math.log(10000) / (half - 1)
    e = torch.exp(torch.arange(half, dtype=torch.int64).float() * -e)
    e = torch.arange(n, dtype=torch.int64).float()[:, None] * e[None]
    e = torch.cat([torch.sin(e), torch.cos(e)], dim=1).view(n, -1)
    if dim % 2 == 1:
        e = torch.cat([e, torch.zeros(n, 1)], dim=1)
    e[padding_idx, :] = 0
    return e


def _mha(w, p, nh, x, kv, causal):
    """``SeamlessM4Tv2Attention``: q scaled after its projection."""
    d = x.shape[-1] // nh
    q = _heads(_lin(w, f"{p}.q_proj", x), nh) * d ** -0.5
    k = _heads(_lin(w, f"{p}.k_proj", kv), nh)
    v = _heads(_lin(w, f"{p}.v_proj", kv), nh)
    s = q @ k.transpose(-1, -2)
    if causal:
        T = x.shape[1]
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool,
                                     device=x.device).triu(1),
                          torch.finfo(s.dtype).min)
    out = torch.softmax(s, dim=-1) @ v
    B, _, T, _ = out.shape
    return _lin(w, f"{p}.out_proj", out.transpose(1, 2).reshape(B, T, -1))


def decoder_logits(w: Dict[str, torch.Tensor], m: Dict, enc: torch.Tensor,
                   tokens: torch.Tensor,
                   at: Sequence[int] = None) -> torch.Tensor:
    """The decoder's logits over ``tokens`` [B, T] (teacher forced: the
    logits at t predict token t + 1) against enc [B, La, H], all valid:
    fp32 [B, T, vocab], or [B, len(at), vocab] at positions ``at`` only."""
    pad = m["pad_token_id"]
    H = m["hidden_size"]
    nh = m["decoder_attention_heads"]
    with no_tf32():
        emb = w[f"{DEC}.embed_tokens.weight"]
        scale = math.sqrt(H) if m.get("scale_embedding", True) else 1.0
        keep = tokens.ne(pad).long()
        pos = torch.cumsum(keep, dim=1) * keep + pad
        table = sinusoids(int(pos.max()) + 1, H, pad).to(enc.device)
        x = F.embedding(tokens, emb) * scale + table[pos]
        for i in range(m["decoder_layers"]):
            p = f"{DEC}.layers.{i}"
            h = _ln0(w, f"{p}.self_attn_layer_norm", x)
            x = x + _mha(w, f"{p}.self_attn", nh, h, h, True)
            h = _ln0(w, f"{p}.cross_attention_layer_norm", x)
            x = x + _mha(w, f"{p}.cross_attention", nh, h, enc.float(), False)
            h = _ln0(w, f"{p}.ffn_layer_norm", x)
            x = x + _lin(w, f"{p}.ffn.fc2",
                         F.relu(_lin(w, f"{p}.ffn.fc1", h)))
        x = _ln0(w, f"{DEC}.layer_norm", x)
        if at is not None:
            x = x[:, list(at)]
        return x @ emb.T


def encoder_frames(n_samples: int) -> int:
    return w2v.n_frames(n_samples)


def adaptor_frames(frames: int, stride: int = 8) -> int:
    """``_compute_sub_sample_lengths_from_attention_mask``: floor((f + 2
    (k // 2) - k) / s) + 1 with k = s."""
    return (frames + 2 * (stride // 2) - stride) // stride + 1


def cap(frames: int, a: float, b: int, max_new_tokens: int) -> int:
    """min(max_new_tokens, ceil(a * adaptor frames) + b), exactly."""
    f = Fraction(a).limit_denominator(10 ** 6)
    return min(max_new_tokens, math.ceil(f * frames) + int(b))


def detokenize(ids: Iterable[int], pieces: List[str], special) -> str:
    """SentencePiece decoding of the pieces of ``ids`` (special ids give
    nothing, ``▁`` a space), then the pipeline's transcript clean-up:
    lower case, the punctuation set removed."""
    text = "".join(pieces[int(i)] for i in ids
                   if int(i) not in special and 0 <= int(i) < len(pieces))
    return _PUNCT.sub("", text.replace(WORD_START, " ").strip().lower())
