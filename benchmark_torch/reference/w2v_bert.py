"""Plain PyTorch reference of the ASR path: fbank frontend, Wav2Vec2-BERT
conformer encoder, CTC head, greedy decoding and transcript clean-up.

Written from the published descriptions, not from the program: the fbank is
HF ``SeamlessM4TFeatureExtractor`` (Kaldi-compliant log-mel with a Povey
window, DC removal, 0.97 pre-emphasis, 80 mel bins triangular in Kaldi mel
space, per-utterance per-bin normalisation with ddof 1, stride-2 stacking);
the encoder is HF ``Wav2Vec2BertModel`` with ``relative_key`` position
embeddings and a causal depthwise convolution; decoding is
``Wav2Vec2CTCTokenizer`` greedy collapse with ``|`` as the word delimiter,
then the pipeline's documented clean-up (lower case, a fixed set of
punctuation removed).

Each row is computed alone at its own valid length, so no padding and no
attention mask enter it. Everything runs in fp32 with TF32 off (the fbank
in float64); :func:`no_tf32` is the guard. Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SR = 16000
FRAME, HOP, NFFT, NMEL = 400, 160, 512, 80
MEL_FLOOR = 1.192092955078125e-07
PREEMPH = 0.97
STRIDE = 2
_PUNCT = re.compile(r"[\,\?\.\!\-\;:\"%\'\»\«\؟\(\)،\.]")


@contextlib.contextmanager
def no_tf32():
    """fp32 products in true fp32 on the card while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _kaldi_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_bank() -> np.ndarray:
    """[257, 80] triangles in Kaldi mel space between 20 Hz and 8 kHz."""
    pts = np.linspace(_kaldi_mel(20.0), _kaldi_mel(8000.0), NMEL + 2)
    bins = _kaldi_mel(np.arange(NFFT // 2 + 1) * SR / NFFT)
    bank = np.zeros((NFFT // 2 + 1, NMEL))
    for m in range(NMEL):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        bank[:, m] = np.maximum(0.0, np.minimum((bins - lo) / (c - lo),
                                                (hi - bins) / (hi - c)))
    return bank


def n_frames(n_samples: int) -> int:
    """Encoder frames (valid, stacked) of a row of ``n_samples``."""
    full = max(0, 1 + (n_samples - FRAME) // HOP)
    return full // STRIDE


def fbank(wave: torch.Tensor) -> torch.Tensor:
    """One utterance [T] (float, full scale 1.0) -> stacked, normalised
    features [n_frames(T), 160] fp32, computed in float64."""
    x = wave.double() * 32768.0
    nf = 1 + (x.shape[0] - FRAME) // HOP
    fr = x.unfold(0, FRAME, HOP)[:nf].clone()
    fr -= fr.mean(dim=1, keepdim=True)
    fr[:, 1:] = fr[:, 1:] - PREEMPH * fr[:, :-1].clone()
    fr[:, 0] *= 1.0 - PREEMPH
    n = torch.arange(FRAME, dtype=torch.float64, device=x.device)
    win = (0.5 - 0.5 * torch.cos(2 * math.pi * n / (FRAME - 1))) ** 0.85
    spec = torch.fft.rfft(fr * win, n=NFFT)
    power = spec.real ** 2 + spec.imag ** 2
    bank = torch.from_numpy(mel_bank()).to(x.device)
    logmel = torch.log(torch.clamp(power @ bank, min=MEL_FLOOR))
    mean = logmel.mean(dim=0, keepdim=True)
    var = logmel.var(dim=0, unbiased=True, keepdim=True)
    feats = (logmel - mean) / torch.sqrt(var + 1e-7)
    keep = (nf // STRIDE) * STRIDE
    return feats[:keep].reshape(nf // STRIDE, NMEL * STRIDE).float()


def _lin(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor):
    b = w.get(f"{name}.bias")
    return F.linear(x, w[f"{name}.weight"], b)


def _ln(w, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"],
                        w[f"{name}.bias"], eps)


def _ffn(w, p, x):
    return _lin(w, f"{p}.output_dense",
                F.silu(_lin(w, f"{p}.intermediate_dense", x)))


def _attention(w, p, m, x):
    B, L, H = x.shape
    nh = m["num_attention_heads"]
    hd = H // nh

    def heads(name):
        return _lin(w, f"{p}.linear_{name}", x).view(B, L, nh, hd) \
            .transpose(1, 2)

    q, k, v = heads("q"), heads("k"), heads("v")
    left, right = (m["left_max_position_embeddings"],
                   m["right_max_position_embeddings"])
    pos = torch.arange(L, device=x.device)
    dist = (pos[None, :] - pos[:, None]).clamp(-left, right) + left
    emb = w[f"{p}.distance_embedding"][dist]                  # [L, L, hd]
    scores = q @ k.transpose(-1, -2)
    scores = scores + torch.einsum("bhld,lrd->bhlr", q, emb)
    probs = torch.softmax(scores / math.sqrt(hd), dim=-1)
    out = (probs @ v).transpose(1, 2).reshape(B, L, H)
    return _lin(w, f"{p}.linear_out", out)


def _conv(w, p, m, x, eps):
    x = _ln(w, f"{p}.layer_norm", x, eps)
    x = F.glu(_lin(w, f"{p}.pointwise_conv1", x), dim=-1)
    K = m["conv_depthwise_kernel_size"]
    x = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)),
                 w[f"{p}.depthwise_conv.weight"], groups=x.shape[-1])
    x = F.silu(_ln(w, f"{p}.depthwise_layer_norm", x.transpose(1, 2), eps))
    return _lin(w, f"{p}.pointwise_conv2", x)


def logits(w: Dict[str, torch.Tensor], m: Dict, feats: torch.Tensor
           ) -> torch.Tensor:
    """[B, L, 160] features of B rows that are valid over all L frames ->
    fp32 CTC logits [B, L, vocab]."""
    eps = m["layer_norm_eps"]
    with no_tf32():
        x = _lin(w, "feature_projection.projection",
                 _ln(w, "feature_projection.layer_norm", feats.float(), eps))
        for i in range(m["num_hidden_layers"]):
            p = f"layers.{i}"
            x = x + 0.5 * _ffn(w, f"{p}.ffn1",
                               _ln(w, f"{p}.ffn1_layer_norm", x, eps))
            x = x + _attention(w, f"{p}.self_attn", m,
                               _ln(w, f"{p}.self_attn_layer_norm", x, eps))
            x = x + _conv(w, f"{p}.conv_module", m, x, eps)
            x = x + 0.5 * _ffn(w, f"{p}.ffn2",
                               _ln(w, f"{p}.ffn2_layer_norm", x, eps))
            x = _ln(w, f"{p}.final_layer_norm", x, eps)
        return _lin(w, "lm_head", x)


def ctc_text(ids: Sequence[int], vocab: List[str], blank: int = 0) -> str:
    """Greedy CTC text of frame ids: repeats merged, blanks dropped, ``|``
    as a space, stripped; then lower case without the punctuation set."""
    out, prev = [], None
    for i in ids:
        i = int(i)
        if i != prev and i != blank and 0 <= i < len(vocab):
            out.append(" " if vocab[i] == "|" else vocab[i])
        prev = i
    return _PUNCT.sub("", "".join(out).strip().lower())
