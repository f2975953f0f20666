"""The flash-rel ablation kernels (CUDA) and their plain twins.

Port of the three Pallas kernels of ``tools/profile_kernel_parts.py``,
which take flash-rel attention apart to price its pieces: the bias
gather, the softmax and the two products. All run on the tool's inputs
``(q, k, v, s_rel, kv_mask)``: q/k/v [B, H, L, 64] bf16, precomputed
bucket logits s_rel [B, H, L, 128] fp32, kv_mask [B, L] fp32 {0, 1}.

- :func:`variant` (``_kernel_variant``), one mode of
  ``full``      s = (q k^T + s_rel[l, clip(m - l, -left, right) + left])
                * scale + (kv_mask - 1) * 1e9, online softmax;
  ``noselect``  the bias read from a 256-wide wrapped table
                u[l, (m - l + left) mod 256], u = [s_rel | 0], with no
                saturation selects (wrong outside the band, by design);
  ``norel``     no bias;
  ``nomax``     no bias, p = exp(s) with no running max;
  ``nosoftmax`` no bias, p = s (inf by design where a row sum is not
                positive);
  ``noexp``     no bias, exp(x) replaced by x * 0.5 (NaN by design);
  each in 256-column kv steps, the row sum over bf16(p).
- :func:`kb640` (``_kb640_kernel``): ``full`` in two 640-column steps.
- :func:`bare` (``_bare_kernel``): softmax(q k^T * scale) @ v with no
  bias and no mask; ``rowsum="ones"`` sums bf16(p), ``"reduce"`` the
  fp32 p.

Each step runs the recurrence l = alpha l + rowsum, o = alpha o +
bf16(p) v (alpha = 1 without a running max) and the output is
o / max(l, 1e-37). The wrapped table is 256 wide, the width the tool was
written for: the tool now reads W = 128 from the flash-rel module, at
which its ``full``, ``noselect`` and ``kb640`` kernels no longer trace.

CPU tensors take the plain twins (:func:`plain`: the same step
recurrence in fp32 PyTorch, chunked over batch); CUDA tensors launch
``csrc/flash_rel_parts.cu`` or raise; on either device, operands that
require grad raise while autograd records (the kernels have no
backward). That kernel has the design of the
main path's bf16 flash_rel kernel (tensor cores, ``csrc/attention_tc.cuh``:
wgmma for both products, p in registers, a cp.async ring), with each
mode's step of 256 or 640 columns, so the differences between configs
price the parts of the kernel the main path runs. ``variant.launches``,
``kb640.launches`` and ``bare.launches`` count kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from audio_processor_tpu_torch.models import _cuda_call

HEAD_DIM = 64
TABLE = 128          # s_rel columns
WRAP = 256           # the wrapped table width of "noselect"
SCALE = 0.125        # 1 / sqrt(64), the tool's sm_scale
LEFT, NUM_BUCKETS = 64, 73


class Mode(NamedTuple):
    bias: str        # "sat" | "wrap" | "none"
    softmax: str     # "online" | "nomax" | "nosoftmax" | "noexp"
    step: int        # kv columns per softmax step
    rowsum: str      # "ones" (sum of bf16 p) | "reduce" (sum of fp32 p)
    masked: bool     # adds (kv_mask - 1) * 1e9


# Index = the kernel's config number in csrc/flash_rel_parts.cu.
MODES = {
    "full": Mode("sat", "online", 256, "ones", True),
    "noselect": Mode("wrap", "online", 256, "ones", True),
    "norel": Mode("none", "online", 256, "ones", True),
    "nomax": Mode("none", "nomax", 256, "ones", True),
    "nosoftmax": Mode("none", "nosoftmax", 256, "ones", True),
    "noexp": Mode("none", "noexp", 256, "ones", True),
    "kb640": Mode("sat", "online", 640, "ones", True),
    "bare:ones": Mode("none", "online", 256, "ones", False),
    "bare:reduce": Mode("none", "online", 256, "reduce", False),
}
VARIANT_MODES = tuple(list(MODES)[:6])
CONFIG = {name: i for i, name in enumerate(MODES)}


def _check(q, k, v, s_rel, kv_mask, mode: Mode, left: int,
           num_buckets: int) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, H, L, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, L, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d} != {HEAD_DIM}")
    if L % mode.step:
        raise ValueError(f"L={L} must be a multiple of the kv step "
                         f"{mode.step}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"q/k/v must be bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if mode.bias != "none":
        if not 1 <= num_buckets <= TABLE or not 0 <= left < num_buckets:
            raise ValueError(f"need 1 <= num_buckets <= {TABLE} and "
                             f"0 <= left < num_buckets, got {num_buckets}, "
                             f"{left}")
        if tuple(s_rel.shape) != (B, H, L, TABLE) \
                or s_rel.dtype != torch.float32:
            raise ValueError(f"s_rel must be float32 {(B, H, L, TABLE)}, "
                             f"got {s_rel.dtype} {tuple(s_rel.shape)}")
    if mode.masked and (tuple(kv_mask.shape) != (B, L)
                        or kv_mask.dtype != torch.float32):
        raise ValueError(f"kv_mask must be float32 {(B, L)}, got "
                         f"{kv_mask.dtype} {tuple(kv_mask.shape)}")


def _plain(q, k, v, s_rel, kv_mask, mode: Mode, sm_scale: float,
           left: int, num_buckets: int) -> torch.Tensor:
    """The mode's formula in fp32 PyTorch, step by step, chunked over
    batch so a chunk's [b, H, L, L] scores stay near 256 MB."""
    B, H, L, _ = q.shape
    pos = torch.arange(L, device=q.device)
    dist = pos[None, :] - pos[:, None]                     # m - l
    if mode.bias == "sat":
        idx = dist.clamp(-left, num_buckets - 1 - left) + left
    elif mode.bias == "wrap":
        wrapped = (dist + left) % WRAP
        idx, in_table = wrapped.clamp(max=TABLE - 1), wrapped < TABLE
    out = torch.empty_like(q)
    chunk = max(1, (256 << 20) // (H * L * L * 4))
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        s = q[sl].float() @ k[sl].float().transpose(-1, -2)
        if mode.bias != "none":
            rel = s_rel[sl].float().gather(-1, idx.expand(s.shape))
            if mode.bias == "wrap":
                rel = torch.where(in_table, rel, 0.0)
            s = s + rel
        s = s * sm_scale
        if mode.masked:
            s = s + (kv_mask[sl, None, None, :].float() - 1.0) * 1e9
        vf = v[sl].float()
        m = torch.full(s.shape[:-1] + (1,), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(vf.shape, device=q.device)
        for st in range(0, L, mode.step):
            x = s[..., st:st + mode.step]
            alpha = 1.0
            if mode.softmax in ("online", "noexp"):
                f = torch.exp if mode.softmax == "online" else (
                    lambda t: t * 0.5)
                m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
                p, alpha, m = f(x - m_new), f(m - m_new), m_new
            else:
                p = torch.exp(x) if mode.softmax == "nomax" else x
            pr = p.to(torch.bfloat16).float()
            rs = (pr if mode.rowsum == "ones" else p).sum(-1, keepdim=True)
            l = alpha * l + rs
            acc = alpha * acc + pr @ vf[..., st:st + mode.step, :]
        out[sl] = (acc / torch.clamp_min(l, 1e-37)).to(q.dtype)
    return out


def _launch(name: str, counter, q, k, v, s_rel, kv_mask,
            sm_scale: float, left: int, num_buckets: int) -> torch.Tensor:
    mode = MODES[name]
    dev = q.device
    named = [("q", q), ("k", k), ("v", v)]
    if mode.bias != "none":
        named.append(("s_rel", s_rel))
    if mode.masked:
        named.append(("kv_mask", kv_mask))
    _cuda_call.check_operands(q, named)
    B, H, L, _ = q.shape
    out = torch.empty_like(q)
    _cuda_call.call(
        "flash_rel_parts", "ppppppiiiiifi", dev, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), s_rel.data_ptr() if mode.bias != "none" else None,
        kv_mask.data_ptr() if mode.masked else None, out.data_ptr(), B, H,
        L, num_buckets, left, float(sm_scale), CONFIG[name],
        label=f"flash_rel_parts {name}")
    counter.launches += 1
    return out


def _run(name: str, q, k, v, s_rel, kv_mask, sm_scale: float, left: int,
         num_buckets: int, counter) -> torch.Tensor:
    mode = MODES[name]
    _cuda_call.refuse_autograd(f"flash_rel_parts {name}", q, k, v, s_rel,
                               kv_mask)
    _check(q, k, v, s_rel, kv_mask, mode, left, num_buckets)
    if q.device.type == "cpu":
        return _plain(q, k, v, s_rel, kv_mask, mode, sm_scale, left,
                      num_buckets)
    if q.device.type != "cuda":
        raise ValueError(f"flash_rel_parts runs on cpu (plain) or cuda "
                         f"(kernel), not {q.device}")
    return _launch(name, counter, q, k, v, s_rel, kv_mask, sm_scale, left,
                   num_buckets)


def variant(q, k, v, s_rel, kv_mask, mode: str = "full",
            sm_scale: float = SCALE, left: int = LEFT,
            num_buckets: int = NUM_BUCKETS) -> torch.Tensor:
    """``_kernel_variant`` in one of :data:`VARIANT_MODES`."""
    if mode not in VARIANT_MODES:
        raise ValueError(f"mode {mode!r} not in {VARIANT_MODES}")
    return _run(mode, q, k, v, s_rel, kv_mask, sm_scale, left,
                num_buckets, variant)


def kb640(q, k, v, s_rel, kv_mask, sm_scale: float = SCALE,
          left: int = LEFT, num_buckets: int = NUM_BUCKETS) -> torch.Tensor:
    """``_kb640_kernel``: ``full`` in 640-column kv steps."""
    return _run("kb640", q, k, v, s_rel, kv_mask, sm_scale, left,
                num_buckets, kb640)


def bare(q, k, v, rowsum: str = "ones",
         sm_scale: float = SCALE) -> torch.Tensor:
    """``_bare_kernel``: no bias, no mask; ``rowsum`` "ones" or
    "reduce"."""
    name = f"bare:{rowsum}"
    if name not in MODES:
        raise ValueError(f"rowsum {rowsum!r} not in ('ones', 'reduce')")
    return _run(name, q, k, v, None, None, sm_scale, LEFT, NUM_BUCKETS,
                bare)


def plain(name: str, q, k, v, s_rel=None, kv_mask=None,
          sm_scale: float = SCALE, left: int = LEFT,
          num_buckets: int = NUM_BUCKETS) -> torch.Tensor:
    """The plain twin of the kernel config ``name`` (a key of
    :data:`MODES`), on any device."""
    mode = MODES[name]
    _check(q, k, v, s_rel, kv_mask, mode, left, num_buckets)
    return _plain(q, k, v, s_rel, kv_mask, mode, sm_scale, left,
                  num_buckets)


variant.launches = 0
kb640.launches = 0
bare.launches = 0
