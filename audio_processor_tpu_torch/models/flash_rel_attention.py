"""Flash attention with in-kernel relative-key position bias (CUDA).

Port of ``audio_processor_tpu/models/flash_rel_attention.py``. The
conformer's relative_key attention is

    softmax((q k^T + rel(q, E)) * sm_scale + (kv_mask - 1) * 1e9) @ v,
    rel[l, m] = q_l . E[clip(m - l, -left, right) + left]

with right = P - 1 - left. Expanding ``rel`` to a [B, H, L, L] tensor
costs gigabytes of HBM traffic per layer at production geometry, so the
kernel (``csrc/flash_rel_attention.cu``) builds the bias from the
[P, d] table inside each block and never writes it out. The source
says what bounds it and how it is laid out.

Two implementations of one function live here:

- :func:`flash_rel_attention_plain`, the dense PyTorch version chunked
  over batch (fp32 math whatever the input type). CPU tensors take it;
  the CPU tests hold it against the JAX kernels.
- the CUDA kernel, launched by :func:`flash_rel_attention` for CUDA
  tensors. A CUDA tensor never falls back to the plain version: the
  wrapper launches the kernel or raises.

``flash_rel_attention.launches`` counts kernel launches, so a run can
show that it went through the kernel; each replay of a CUDA graph adds
the launches its capture recorded.
"""

from __future__ import annotations

import torch

from audio_processor_tpu_torch.models import _cuda_call

HEAD_DIM = 64        # the conformer head size; the kernel's only d
MAX_BUCKETS = 128    # the bucket table must fit the kernel's s_rel tile
L_MULTIPLE = 64      # the kernel's q and kv tile
VARIANTS = ("auto", "onepass", "stream")


def _check(q, k, v, E, kv_mask, left: int, num_buckets: int,
           variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, H, L, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, L, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d} != {HEAD_DIM}")
    if L % L_MULTIPLE:
        raise ValueError(f"L={L} must be a multiple of {L_MULTIPLE}")
    if not 1 <= num_buckets <= MAX_BUCKETS:
        raise ValueError(f"num_buckets={num_buckets} not in "
                         f"[1, {MAX_BUCKETS}]")
    if not 0 <= left < num_buckets:
        raise ValueError(f"left={left} outside [0, {num_buckets})")
    if tuple(E.shape) != (num_buckets, d):
        raise ValueError(f"E shape {tuple(E.shape)} != "
                         f"({num_buckets}, {d})")
    if tuple(kv_mask.shape) != (B, L):
        raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != "
                         f"({B}, {L})")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share dtype float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_rel_attention_plain(q, k, v, E, kv_mask, sm_scale: float,
                              left: int, num_buckets: int) -> torch.Tensor:
    """Dense reference, chunked over batch so a chunk's [b, H, L, L]
    scores stay near 256 MB. E is rounded to q's dtype first (as the
    JAX wrapper does); the math is fp32; the output has q's dtype. As in
    both JAX kernels, p = exp(s - max) is rounded to v's dtype before
    p @ v, the row sum adds the rounded p, and the sum is floored at
    1e-37 (for fp32 inputs the rounding is the identity)."""
    B, H, L, _ = q.shape
    right = num_buckets - 1 - left
    pos = torch.arange(L, device=q.device)
    bucket = (pos[None, :] - pos[:, None]).clamp(-left, right) + left
    rows = pos[:, None]
    Ef = E.to(q.dtype).float()
    out = torch.empty_like(q)
    chunk = max(1, (256 << 20) // (H * L * L * 4))
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        qf, kf, vf = q[sl].float(), k[sl].float(), v[sl].float()
        srel = qf @ Ef.T                                   # [b, H, L, P]
        s = qf @ kf.transpose(-1, -2) + srel[:, :, rows, bucket]
        s = s * sm_scale + (kv_mask[sl, None, None, :].float() - 1.0) * 1e9
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(v.dtype).float()
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
        out[sl] = ((p @ vf) / denom).to(q.dtype)
    return out


def _launch(q, k, v, E, kv_mask, sm_scale: float, left: int,
            num_buckets: int) -> torch.Tensor:
    dev = q.device
    E = E.to(q.dtype)
    _cuda_call.check_operands(q, (("q", q), ("k", k), ("v", v), ("E", E),
                                  ("kv_mask", kv_mask)))
    if kv_mask.dtype != torch.float32:
        raise ValueError(f"kv_mask must be float32, got {kv_mask.dtype}")
    B, H, L, _ = q.shape
    out = torch.empty_like(q)
    _cuda_call.call(
        "flash_rel_attention", "ppppppiiiiifi", dev, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), E.data_ptr(), kv_mask.data_ptr(),
        out.data_ptr(), B, H, L, num_buckets, left, float(sm_scale),
        int(q.dtype == torch.bfloat16))
    _cuda_call.count_launch(flash_rel_attention)
    return out


def flash_rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        E: torch.Tensor, kv_mask: torch.Tensor,
                        sm_scale: float, left: int, num_buckets: int,
                        variant: str = "auto") -> torch.Tensor:
    """softmax((q k^T + rel(q, E)) * sm_scale + mask) @ v.

    q/k/v: [B, H, L, 64] float32 or bfloat16; E: [P, 64] distance table
    (P = num_buckets <= 128); kv_mask: [B, L] float32 {0, 1}; L a
    multiple of 64. ``variant`` names the JAX kernel being matched
    ("onepass", "stream" or "auto"): both compute one function, and
    one CUDA kernel computes it for all three.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise); any other device raises. The kernel has no backward, so
    operands that require grad raise while autograd records, on every
    device.
    """
    _cuda_call.refuse_autograd("flash_rel_attention", q, k, v, E, kv_mask)
    _check(q, k, v, E, kv_mask, left, num_buckets, variant)
    if q.device.type == "cpu":
        return flash_rel_attention_plain(q, k, v, E, kv_mask, sm_scale,
                                         left, num_buckets)
    if q.device.type != "cuda":
        raise ValueError(f"flash_rel_attention runs on cpu (plain) or "
                         f"cuda (kernel), not {q.device}")
    return _launch(q, k, v, E, kv_mask, sm_scale, left, num_buckets)


flash_rel_attention.launches = 0
