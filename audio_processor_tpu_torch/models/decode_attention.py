"""Attention of one query position per row over a K/V cache (CUDA): the
self- and cross-attention of the text decoder's steps
(``models/seamless_s2t.py``), one launch each per layer and step.

Per row and head (head size 64), with every sum in fp32 and the output
written once in q's dtype:

    s_j = scale * (q . k_j) + bias_j
    out = softmax(s) @ v

- self mode (``pos`` given): first writes each row's new key and value
  (``k_new``, ``v_new``) into the caches at ``pos``, a [1] int64 tensor
  on the device (so one captured CUDA graph serves every position), then
  attends over cache positions 0 .. pos only;
- cross mode: attends over every key under an optional additive fp32
  ``bias`` [R, Lk] (finfo.min on padded frames; a row with no valid frame
  gets uniform weights, as softmax gives).

q and the output are [R, H * 64], the layout of the projections around
it; the caches are [R, H, Lk, 64].

Two implementations of one function live here:

- :func:`decode_attention_plain`, in PyTorch: CPU tensors take it. In
  fp32 its ops are HF's (the scaled query's product, the additive bias,
  softmax, the product with v); in bf16 it keeps the scores and the
  probabilities in fp32, as the kernel does.
- the CUDA kernel (``csrc/decode_attention.cu``), launched by
  :func:`decode_attention` for CUDA tensors. A CUDA tensor never falls
  back to the plain version: the wrapper launches the kernel or raises.

``decode_attention.launches`` counts kernel launches; each replay of a
CUDA graph adds the launches its capture recorded.
"""

from __future__ import annotations

from typing import Optional

import torch

from audio_processor_tpu_torch.models import _cuda_call

HEAD_DIM = 64        # the decoder's head size; the kernel's only d
DTYPES = (torch.float32, torch.bfloat16)
NEG = torch.finfo(torch.float32).min


def _check(q, k, v, pos, k_new, v_new, bias, kernel: bool) -> None:
    """Raise ValueError on operands the function does not take; with
    ``kernel``, also on a head size the kernel does not take (the plain
    version takes any)."""
    if q.dim() != 2 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [R, H*d] and k/v one [R, H, Lk, d] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    R, H, Lk, d = k.shape
    if tuple(q.shape) != (R, H * d) or Lk < 1:
        raise ValueError(f"q shape {tuple(q.shape)} != {(R, H * d)} or "
                         f"no keys ({Lk})")
    if kernel and d != HEAD_DIM:
        raise ValueError(f"head dim {d} != {HEAD_DIM}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share dtype float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if pos is None:
        if k_new is not None or v_new is not None:
            raise ValueError("k_new/v_new are written at pos: give pos")
        if bias is not None and (bias.dtype != torch.float32
                                 or tuple(bias.shape) != (R, Lk)):
            raise ValueError(f"bias must be float32 {(R, Lk)}, got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        return
    if bias is not None:
        raise ValueError("self mode (pos given) takes no bias")
    if pos.dtype != torch.int64 or tuple(pos.shape) != (1,):
        raise ValueError(f"pos must be int64 [1], got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t is None or t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's shape and dtype")


def decode_attention_plain(q, k, v, scale: float, *,
                           pos: Optional[torch.Tensor] = None,
                           k_new: Optional[torch.Tensor] = None,
                           v_new: Optional[torch.Tensor] = None,
                           bias: Optional[torch.Tensor] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """The PyTorch version. In self mode it writes the caches at ``pos``
    and attends over their first ``window`` positions (default all) with
    those past ``pos`` masked by finfo.min, which weighs them 0 exactly."""
    R, H, Lk, d = k.shape
    qh = q.view(R, 1, H, d).transpose(1, 2)
    if pos is not None:
        k.index_copy_(2, pos, k_new.view(R, 1, H, d).transpose(1, 2))
        v.index_copy_(2, pos, v_new.view(R, 1, H, d).transpose(1, 2))
        W = Lk if window is None else window
        k, v = k[:, :, :W], v[:, :, :W]
        bias = torch.where(torch.arange(W, device=q.device) <= pos, 0.0, NEG)
    elif bias is not None:
        bias = bias.view(R, 1, 1, Lk)
    s = (qh.float() * scale) @ k.float().transpose(-1, -2)
    if bias is not None:
        s = s + bias
    out = torch.softmax(s, dim=-1) @ v.float()
    return out.to(q.dtype).transpose(1, 2).reshape(R, H * d)


def _launch(q, k, v, scale, pos, k_new, v_new, bias) -> torch.Tensor:
    R, H, Lk, _ = k.shape
    named = [("k", k), ("v", v)] + [
        (n, t) for n, t in (("pos", pos), ("k_new", k_new),
                            ("v_new", v_new), ("bias", bias))
        if t is not None]
    _cuda_call.check_operands(k, [("q", q)] + named)
    out = torch.empty_like(q)
    ptr = (lambda t: None if t is None else t.data_ptr())
    _cuda_call.call(
        "decode_attention", "ppppppppiiifi", q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), ptr(k_new), ptr(v_new), ptr(pos),
        ptr(bias), out.data_ptr(), R, H, Lk, float(scale),
        int(q.dtype == torch.bfloat16))
    _cuda_call.count_launch(decode_attention)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, *, pos: Optional[torch.Tensor] = None,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """softmax(scale * q k^T + bias) @ v -> [R, H * d] in q's dtype.

    q: [R, H * d]; k, v: [R, H, Lk, d]; one dtype, float32 or bfloat16;
    the kernel takes d = 64, the plain version any. Self mode: ``pos`` an
    int64 [1] tensor and ``k_new``, ``v_new`` shaped like q, written into
    k and v at ``pos`` first; only positions 0 .. pos are attended
    (``window``, the positions the plain version reads, must exceed pos;
    the kernel needs none). Cross mode: ``bias`` None or float32 [R, Lk].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise); any other device raises. The kernel has no backward, so
    operands that require grad raise while autograd records, on every
    device.
    """
    _cuda_call.refuse_autograd("decode_attention", q, k, v, k_new, v_new,
                               bias)
    _check(q, k, v, pos, k_new, v_new, bias, q.device.type != "cpu")
    kw = dict(pos=pos, k_new=k_new, v_new=v_new, bias=bias)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, scale, window=window, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu (plain) or cuda "
                         f"(kernel), not {q.device}")
    return _launch(q, k, v, scale, **kw)


decode_attention.launches = 0
