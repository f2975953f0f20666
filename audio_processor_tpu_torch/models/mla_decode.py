"""The absorbed multi-head latent attention of one decode step of the topic
LM (``models/moe_lm.py``) between its projections, as two CUDA launches a
layer (``csrc/mla_decode.cu``).

- :func:`mla_decode_prep` takes the q projection's output q [R, H *
  (nope + rope)] and the latent projection's kv [R, lora + rope] and
  returns q_nope head-major [H, R, nope] and q_pe [R, H, rope] rotated in
  DeepSeek-V3's pairing; it writes each row's latent (c under the latent
  RMSNorm, then k_pe rotated) into ``cache`` at ``pos``. With ``rotate``
  False (Kimi-Linear's ``mla_use_nope``) q_pe and k_pe pass unrotated.
- :func:`mla_decode_attention` takes q_lat = q_nope·W_kvb,k [H, R, lora]
  and q_pe and returns o_lat [H, R, lora]: per row and head, softmax over
  the positions ``visible`` marks of scale · (q_lat·c_j + q_pe·k_pe_j),
  times c_j. ``visible`` is honoured as given: nothing is derived from
  ``pos``.

Scores, softmax, RoPE and the RMSNorm statistics in fp32; every product
summed in fp32; outputs and the cache in the inputs' dtype.

Two implementations of each live here:

- :func:`mla_decode_prep_plain` and :func:`mla_decode_attention_plain`,
  in PyTorch, for any widths: CPU tensors take them. The prep rotates as
  ``moe_lm.apply_rope`` does, bit for bit, and normalises with
  ``F.rms_norm``; the attention keeps scores and probabilities in fp32 (in
  fp32 it runs the ops the decode ran before the kernels: the concatenated
  query's product with the cache, the scale, the mask, the softmax, P·c).
- the kernels, launched by :func:`mla_decode_prep` and
  :func:`mla_decode_attention` for CUDA tensors: bf16 only, at
  Moonlight-16B-A3B's widths (nope 128, rope 64, lora 512), at most 16
  heads or 32 (Kimi-Linear's: the attention runs them as two groups of
  16, each its own clusters), a capacity that is a multiple of 64 up to
  8,192. The attention
  kernel rounds the probabilities to bf16 before P·c (fp32 sums), where
  the plain version keeps them in fp32. A CUDA tensor never falls back to
  the plain version: the wrappers launch the kernels or raise, so a model
  the kernels do not take (fp32, other widths, more heads) raises on the
  card at its first decode step.

The wrappers alone choose between the two, by the operands' device; the
decode always calls them.

``mla_decode_prep.launches`` and ``mla_decode_attention.launches`` count
kernel launches; each replay of a CUDA graph adds the launches its capture
recorded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audio_processor_tpu_torch.models import _cuda_call

NOPE, ROPE, LORA = 128, 64, 512    # the kernels' widths (Moonlight's)
GROUP = 16                         # the MMA's 16 rows: heads a cluster
HEAD_COUNTS = set(range(1, GROUP + 1)) | {2 * GROUP}   # the kernels' H
TILE = 64                          # the attention kernel's positions a tile
MAX_CAPACITY = 8192                # 8 blocks x 16 tiles of 64 positions


def _rope(x: torch.Tensor, cos: torch.Tensor,
          sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotation of x [..., d] as the kernel computes it:
    pair i (x[2i], x[2i+1]) gives x[2i]·cos_i − x[2i+1]·sin_i and
    x[2i+1]·cos_{i+d/2} + x[2i]·sin_{i+d/2}, in fp32, rounded to x's
    dtype; ``moe_lm.apply_rope`` bit for bit."""
    xf = x.float()
    even, odd = xf[..., 0::2], xf[..., 1::2]
    h = x.shape[-1] // 2
    return torch.cat([even * cos[..., :h] - odd * sin[..., :h],
                      odd * cos[..., h:] + even * sin[..., h:]],
                     dim=-1).to(x.dtype)


def mla_decode_prep_plain(q, kv, cos, sin, gain, eps: float, cache, pos,
                          heads: int, rotate: bool = True):
    """The PyTorch version of :func:`mla_decode_prep`."""
    R = q.shape[0]
    rope, lora = kv.shape[-1] - gain.shape[0], gain.shape[0]
    qh = q.view(R, heads, -1)
    q_nope = qh[..., :-rope].transpose(0, 1).contiguous()
    q_pe = qh[..., -rope:]
    c, k_pe = kv.split([lora, rope], dim=-1)
    if rotate:
        q_pe = _rope(q_pe, cos[:, None], sin[:, None])
        k_pe = _rope(k_pe, cos, sin)
    else:
        q_pe = q_pe.contiguous()
    latent = torch.cat([F.rms_norm(c, (lora,), gain, eps), k_pe], dim=-1)
    cache.scatter_(1, pos[:, None, None].expand(-1, 1, latent.shape[-1]),
                   latent[:, None])
    return q_nope, q_pe


def mla_decode_attention_plain(q_lat, q_pe, cache, visible,
                               scale: float) -> torch.Tensor:
    """The PyTorch version of :func:`mla_decode_attention`; in fp32 the ops
    the decode ran before the kernels."""
    lora = q_lat.shape[-1]
    q = torch.cat([q_lat.transpose(0, 1), q_pe], dim=-1).float()
    s = torch.bmm(q, cache.float().transpose(1, 2)) * scale
    p = s.masked_fill(~visible[:, None], float("-inf")).softmax(dim=-1)
    o = torch.bmm(p, cache[..., :lora].float())
    return o.to(q_lat.dtype).transpose(0, 1).contiguous()


def _check_cache(cache, R: int, device: torch.device) -> None:
    if cache.dim() != 3 or cache.shape[0] != R or cache.shape[2] != \
            LORA + ROPE:
        raise ValueError(f"cache must be [{R}, C, {LORA + ROPE}], got "
                         f"{tuple(cache.shape)}")
    C = cache.shape[1]
    if C % TILE or not TILE <= C <= MAX_CAPACITY:
        raise ValueError(f"cache capacity {C} must be a multiple of {TILE} "
                         f"in [{TILE}, {MAX_CAPACITY}]")
    if cache.stride(2) != 1 or cache.stride(1) != LORA + ROPE:
        raise ValueError("each cache row's positions must be dense")
    _cuda_call.check_tensors(device, [("cache", cache[0])])
    if (cache.stride(0) * cache.element_size()) % 16:
        raise ValueError("the cache's row stride must keep 16-byte "
                         "alignment")


def _check_prep(q, kv, cos, sin, gain, cache, pos, heads: int) -> None:
    """Raise ValueError on operands the prep kernel does not take."""
    R = q.shape[0] if q.dim() == 2 else -1
    if heads not in HEAD_COUNTS or tuple(q.shape) != (
            R, heads * (NOPE + ROPE)):
        raise ValueError(f"q must be [R, heads * {NOPE + ROPE}] with 1 <= "
                         f"heads <= {GROUP} or heads = {2 * GROUP}, got "
                         f"{tuple(q.shape)}, heads {heads}")
    if tuple(kv.shape) != (R, LORA + ROPE):
        raise ValueError(f"kv must be [{R}, {LORA + ROPE}], got "
                         f"{tuple(kv.shape)}")
    for name, t in (("q", q), ("kv", kv), ("gain", gain), ("cache", cache)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if tuple(gain.shape) != (LORA,):
        raise ValueError(f"gain must be ({LORA},), got {tuple(gain.shape)}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (R, ROPE):
            raise ValueError(f"{name} must be float32 {(R, ROPE)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if pos.dtype != torch.int64 or tuple(pos.shape) != (R,):
        raise ValueError(f"pos must be int64 ({R},), got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    _check_cache(cache, R, q.device)
    _cuda_call.check_tensors(q.device, [("q", q), ("kv", kv), ("cos", cos),
                                        ("sin", sin), ("gain", gain),
                                        ("pos", pos)])


def _check_attention(q_lat, q_pe, cache, visible) -> None:
    """Raise ValueError on operands the attention kernel does not take."""
    if q_lat.dim() != 3 or q_lat.shape[2] != LORA or \
            q_lat.shape[0] not in HEAD_COUNTS:
        raise ValueError(f"q_lat must be [H, R, {LORA}] with H <= {GROUP} "
                         f"or H = {2 * GROUP}, got {tuple(q_lat.shape)}")
    H, R, _ = q_lat.shape
    if tuple(q_pe.shape) != (R, H, ROPE):
        raise ValueError(f"q_pe must be {(R, H, ROPE)}, got "
                         f"{tuple(q_pe.shape)}")
    for name, t in (("q_lat", q_lat), ("q_pe", q_pe), ("cache", cache)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    _check_cache(cache, R, q_lat.device)
    if visible.dtype != torch.bool or tuple(visible.shape) != (
            R, cache.shape[1]):
        raise ValueError(f"visible must be bool {(R, cache.shape[1])}, got "
                         f"{visible.dtype} {tuple(visible.shape)}")
    _cuda_call.check_tensors(q_lat.device, [("q_lat", q_lat),
                                            ("q_pe", q_pe),
                                            ("visible", visible)])


def _on(device: torch.device, name: str) -> bool:
    """True for the plain version (CPU), False for the kernel (CUDA)."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu (plain) or cuda (kernel), "
                         f"not {device}")
    return False


def mla_decode_prep(q: torch.Tensor, kv: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor, gain: torch.Tensor, eps: float,
                    cache: torch.Tensor, pos: torch.Tensor, heads: int,
                    rotate: bool = True):
    """(q_nope [H, R, nope], rotated q_pe [R, H, rope]) from q [R, H *
    (nope + rope)] and kv [R, lora + rope]; writes each row's latent into
    ``cache`` [R, C, lora + rope] (rows may be strided) at ``pos`` (int64
    [R] on the device; a position outside the cache writes nothing on the
    card). cos, sin: fp32 [R, rope] at each row's position; gain: the
    latent RMSNorm's [lora]. ``rotate`` False leaves q_pe and k_pe as
    projected (cos and sin are then not read). CPU tensors take the plain
    version, CUDA tensors the kernel (or raise); autograd recording a
    gradient of an operand raises on every device."""
    _cuda_call.refuse_autograd("mla_decode_prep", q, kv, gain, cache)
    if _on(q.device, "mla_decode_prep"):
        return mla_decode_prep_plain(q, kv, cos, sin, gain, eps, cache, pos,
                                     heads, rotate)
    _check_prep(q, kv, cos, sin, gain, cache, pos, heads)
    R = q.shape[0]
    q_nope = torch.empty(heads, R, NOPE, dtype=q.dtype, device=q.device)
    q_pe = torch.empty(R, heads, ROPE, dtype=q.dtype, device=q.device)
    _cuda_call.call(
        "mla_decode", "pppppfppliiiipp", q.device,
        q.data_ptr(), kv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        gain.data_ptr(), float(eps), pos.data_ptr(), cache.data_ptr(),
        cache.stride(0), cache.shape[1], R, heads, int(rotate),
        q_nope.data_ptr(), q_pe.data_ptr(), entry="mla_decode_prep")
    _cuda_call.count_launch(mla_decode_prep)
    return q_nope, q_pe


def mla_decode_attention(q_lat: torch.Tensor, q_pe: torch.Tensor,
                         cache: torch.Tensor, visible: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """o_lat [H, R, lora]: per row r and head h, softmax over the positions
    j that ``visible`` [R, C] marks of scale · (q_lat[h, r]·c_j +
    q_pe[r, h]·k_pe_j), times c_j, where ``cache`` [R, C, lora + rope]
    holds [c_j, k_pe_j] (rows may be strided). CPU tensors take the plain
    version, CUDA tensors the kernel (or raise); autograd recording a
    gradient of an operand raises on every device."""
    _cuda_call.refuse_autograd("mla_decode_attention", q_lat, q_pe, cache)
    if _on(q_lat.device, "mla_decode_attention"):
        return mla_decode_attention_plain(q_lat, q_pe, cache, visible, scale)
    _check_attention(q_lat, q_pe, cache, visible)
    H, R, _ = q_lat.shape
    out = torch.empty_like(q_lat)
    _cuda_call.call(
        "mla_decode", "ppplppiiif", q_lat.device, q_lat.data_ptr(),
        q_pe.data_ptr(), cache.data_ptr(), cache.stride(0),
        visible.data_ptr(), out.data_ptr(), R, H, cache.shape[1],
        float(scale), entry="mla_decode_attention")
    _cuda_call.count_launch(mla_decode_attention)
    return out


mla_decode_prep.launches = 0
mla_decode_attention.launches = 0
