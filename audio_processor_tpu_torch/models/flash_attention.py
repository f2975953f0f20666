"""Flash attention with an optional materialised additive bias (CUDA).

Port of the stock Pallas TPU kernel
``jax.experimental.pallas.ops.tpu.flash_attention`` as the reference
uses it: non-causal, no segment ids, head size 64, computing

    s = (q k^T + ab) * sm_scale           (fp32; ``ab`` optional)
    softmax(s) @ v, with p rounded to v's dtype before the product and
    the row sum taken over the fp32 p; a row whose sum is 0 gives 0.

The model's ``attention_impl="flash"`` feeds it a bias built outside
the kernel: the relative-key logits and the kv mask, materialised to
[B, H, L, L] in bf16 (``models/wav2vec2bert.py``).

Two implementations of one function live here:

- :func:`flash_attention_plain`, the dense PyTorch version chunked over
  batch (fp32 math whatever the input type). CPU tensors take it; the
  CPU tests hold it against the Pallas kernel in interpret mode.
- the CUDA kernel (``csrc/flash_attention.cu``), launched by
  :func:`flash_attention` for CUDA tensors. A CUDA tensor never falls
  back to the plain version: the wrapper launches the kernel or raises.

``flash_attention.launches`` counts kernel launches, so a run can show
that it went through the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from audio_processor_tpu_torch.models import _cuda_call

HEAD_DIM = 64        # the conformer head size; the kernel's only d
L_MULTIPLE = 64      # the kernel's q and kv tile
DTYPES = (torch.float32, torch.bfloat16)
_AB_KIND = {None: 0, torch.bfloat16: 1, torch.float32: 2}


def _check(q, k, v, ab) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, H, L, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, L, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d} != {HEAD_DIM}")
    if L % L_MULTIPLE:
        raise ValueError(f"L={L} must be a multiple of {L_MULTIPLE}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share dtype float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if ab is not None:
        if tuple(ab.shape) != (B, H, L, L):
            raise ValueError(f"ab shape {tuple(ab.shape)} != "
                             f"{(B, H, L, L)}")
        if ab.dtype not in DTYPES:
            raise ValueError(f"ab must be float32 or bfloat16, got "
                             f"{ab.dtype}")


def flash_attention_plain(q, k, v, ab: Optional[torch.Tensor] = None,
                          sm_scale: float = 1.0) -> torch.Tensor:
    """Dense reference, chunked over batch so a chunk's [b, H, L, L]
    scores stay near 256 MB. The math is fp32; the output has q's
    dtype."""
    B, H, L, _ = q.shape
    out = torch.empty_like(q)
    chunk = max(1, (256 << 20) // (H * L * L * 4))
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        s = q[sl].float() @ k[sl].float().transpose(-1, -2)
        if ab is not None:
            s = s + ab[sl].float()
        s = s * sm_scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        rowsum = p.sum(dim=-1, keepdim=True)
        o = p.to(v.dtype).float() @ v[sl].float()
        out[sl] = (o / torch.where(rowsum == 0, 1.0, rowsum)).to(q.dtype)
    return out


def _launch(q, k, v, ab, sm_scale: float) -> torch.Tensor:
    dev = q.device
    _cuda_call.check_operands(q, [("q", q), ("k", k), ("v", v)]
                              + ([] if ab is None else [("ab", ab)]))
    B, H, L, _ = q.shape
    out = torch.empty_like(q)
    _cuda_call.call(
        "flash_attention", "ppppipiiifi", dev, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if ab is None else ab.data_ptr(),
        _AB_KIND[None if ab is None else ab.dtype], out.data_ptr(), B, H,
        L, float(sm_scale), int(q.dtype == torch.bfloat16))
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ab: Optional[torch.Tensor] = None,
                    sm_scale: float = 1.0) -> torch.Tensor:
    """softmax((q k^T + ab) * sm_scale) @ v.

    q/k/v: [B, H, L, 64] float32 or bfloat16 (one dtype); ab: None or
    [B, H, L, L] float32 or bfloat16; L a multiple of 64.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise); any other device raises.
    """
    _check(q, k, v, ab)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, ab, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu (plain) or cuda "
                         f"(kernel), not {q.device}")
    return _launch(q, k, v, ab, sm_scale)


flash_attention.launches = 0
