"""Kimi Delta Attention (KDA): the gated delta-rule linear attention with a
per-channel decay of Kimi-Linear-48B-A3B (HF ``model_type: kimi_linear``;
the layer of flash-linear-attention's ``fla/layers/kda.py``), the token
mixer of the topic LM's ``linear_attn_config`` layers (``models/moe_lm.py``).

Per token x (after the layer's input RMSNorm), per head h of H (32), with
d_k = d_v = D (128) and W = H·D:

- q, k, v = SiLU(causal depthwise conv_K(W_q x, W_k x, W_v x)), no bias, K
  = ``short_conv_kernel_size`` (4); each projection hidden → W;
- q and k L2-normalised per head (x / sqrt(Σx² + 1e-6)), q times D^-½;
- g = −exp(A_log[h]) · softplus(W_fb W_fa x + dt_bias), a log-decay per
  key channel [W] (W_fa: H → D, W_fb: D → W);
- β = sigmoid(W_b x), one per head;
- the state S [D_k, D_v] (fp32): S ← diag(exp g_t) S, then S ← S + β_t
  k_t (v_t − Sᵀk_t)ᵀ; the output o_t = Sᵀq_t;
- out = W_o · concat_h(RMSNorm(o_h) · w_norm · sigmoid(W_gb W_ga x +
  b_gb)), the RMSNorm's eps ``rms_norm_eps`` and w_norm [D] shared by the
  heads.

Parameters (the program's layout): ``in_proj`` [3W + 2D + H, hidden] holds
W_q, W_k, W_v, W_fa, W_ga and W_b as one product; ``conv_weight`` [3W, K]
the depthwise kernels of q, k and v (tap K−1 multiplies the newest input);
``fg_b`` [2, W, D] W_fb then W_gb; ``g_bias`` [W] W_gb's bias; ``A_log``
[H] and ``dt_bias`` [W] (fp32 in every dtype); ``o_norm`` [D]; ``o_proj``
[hidden, W].

Prefill (:meth:`KimiDeltaAttention.prefill`): ragged packed rows, each
from a zero state; between the projections one call of
:func:`kda_prefill`, which applies the conv and SiLU, normalises q and k,
computes the gate and β, runs the recurrence chunk by chunk (chunks of
64) in fp32, writes each row's final state and its last K−1 conv inputs
into the decode state and gives the gated RMSNorm's output: one launch of
``csrc/kda_prefill.cu`` for CUDA tensors (bf16 at D = 128 and K = 4; any
other CUDA model raises there: no fallback), the plain twin
:func:`kda_prefill_plain` for CPU tensors, which runs the
chunkwise-parallel form :func:`chunk_kda` (the intra-chunk parts batched
over rows, heads and chunks, the state pass :func:`state_pass` a loop over
the chunks). ``kda_prefill.launches`` counts the kernel's launches. Span
``topics.kda_prefill``: ``layer``, ``rows``, ``tokens``, ``chunks`` and
``kernel_launches`` (the kernel's launches inside it).

Decode (:meth:`KimiDeltaAttention.decode`): between the projections one
call of :func:`kda_decode`, which shifts the conv state, applies the conv
and SiLU, normalises q and k, computes the gate and β, updates the fp32
state in place and gives the gated RMSNorm's output: one launch of
``csrc/kda_decode.cu`` for CUDA tensors (bf16 at D = 128 and K = 4; any
other CUDA model raises there: no fallback), the plain twin
:func:`kda_decode_plain` for CPU tensors. ``kda_decode.launches`` counts
the kernel's launches (a replayed CUDA graph adds its capture's).

Everything after the projections runs in fp32: the conv, the norms, the
gate, the state and its products; the output is rounded once to the
inputs' dtype.
"""

from __future__ import annotations

import math
from itertools import accumulate
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_processor_tpu_torch.models import _cuda_call
from audio_processor_tpu_torch.obs import profiler

CHUNK = 64            # the prefill's chunk (a power of two)
L2_EPS = 1e-6
HEAD_DIM = 128        # the kernel's d_k = d_v
CONV = 4              # the kernel's conv width


class KimiDeltaAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.H, self.D = cfg.kda_num_heads, cfg.kda_head_dim
        self.K = cfg.kda_conv_size
        self.W = W = self.H * self.D
        h = cfg.hidden_size
        self.eps = cfg.rms_norm_eps
        self.in_proj = nn.Linear(h, 3 * W + 2 * self.D + self.H, bias=False)
        self.conv_weight = nn.Parameter(torch.empty(3 * W, self.K))
        self.fg_b = nn.Parameter(torch.empty(2, W, self.D))
        self.g_bias = nn.Parameter(torch.zeros(W))
        self.A_log = nn.Parameter(torch.zeros(self.H))
        self.dt_bias = nn.Parameter(torch.zeros(W))
        self.o_norm = nn.Parameter(torch.ones(self.D))
        self.o_proj = nn.Linear(W, h, bias=False)

    def _split(self, p: torch.Tensor):
        """in_proj's output [T, 3W + 2D + H] -> (raw q|k|v [T, 3W], [2, T,
        W]: f by W_fb and the gate's logits by W_gb without its bias, in the
        product's dtype, β's logits [T, H])."""
        W, D = self.W, self.D
        fg = torch.bmm(p[:, 3 * W:3 * W + 2 * D].unflatten(1, (2, D))
                       .transpose(0, 1), self.fg_b.transpose(1, 2))
        return p[:, :3 * W], fg, p[:, 3 * W + 2 * D:]

    def prefill(self, x: torch.Tensor, rows: Sequence[tuple],
                state: torch.Tensor, conv_state: torch.Tensor,
                layer: int = -1) -> torch.Tensor:
        """Packed tokens x [N, hidden] of ragged rows ((start, length) each,
        in order), each from a zero state -> the layer's output [N, hidden];
        writes each row's final state into ``state`` [R, H, D, D] (fp32)
        and its last K−1 conv inputs into ``conv_state`` [R, K−1, 3W]
        (:func:`kda_prefill`)."""
        chunks = sum(-(-n // CHUNK) for _, n in rows)
        with profiler.span("topics.kda_prefill", layer=layer, rows=len(rows),
                           tokens=x.shape[0], chunks=chunks) as sp:
            p = F.linear(x, self.in_proj.weight)
            _, fg, _ = self._split(p)
            o, launched = _cuda_call.counted(
                kda_prefill, p, fg, self.conv_weight, self.A_log,
                self.dt_bias, self.g_bias, self.o_norm, self.eps, rows,
                state, conv_state)
            if sp is not None:
                sp.attrs["kernel_launches"] = launched.get(kda_prefill, 0)
            return F.linear(o, self.o_proj.weight)

    def decode(self, x: torch.Tensor, state: torch.Tensor,
               conv_state: torch.Tensor) -> torch.Tensor:
        """One token of every row x [R, hidden] -> [R, hidden]; updates
        ``state`` and ``conv_state`` in place (:func:`kda_decode`)."""
        p = F.linear(x, self.in_proj.weight)
        _, fg, _ = self._split(p)
        o = kda_decode(p, fg, self.conv_weight, self.A_log, self.dt_bias,
                       self.g_bias, self.o_norm, self.eps, state, conv_state)
        return F.linear(o, self.o_proj.weight)


def stand_in(name: str, p: torch.Tensor, gen: torch.Generator) -> None:
    """Draw the stand-in value of the KDA parameter ``name`` (relative to
    the layer) into ``p``: A_log = log U(1, 16) and dt_bias the inverse
    softplus of dt ~ logU(1e-3, 1e-1) (flash-linear-attention's inits),
    the conv kernels U(−½, ½) (PyTorch's for a fan-in of 4), w_norm 1,
    W_gb's bias 0, every product N(0, 0.02)."""
    if name == "A_log":
        p.uniform_(1.0, 16.0, generator=gen).log_()
    elif name == "dt_bias":
        dt = p.uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
        p.copy_(dt + torch.log(-torch.expm1(-dt)))
    elif name == "conv_weight":
        p.uniform_(-0.5, 0.5, generator=gen)
    elif name == "o_norm":
        p.fill_(1.0)
    elif name == "g_bias":
        p.zero_()
    else:
        p.normal_(0.0, 0.02, generator=gen)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def pairs(q: torch.Tensor, k: torch.Tensor, gc: torch.Tensor):
    """Within each chunk of n (a power of two) positions, q, k, gc [..., n,
    d] -> (A [..., n, n], L [..., n, n]): A[c, j] = Σ_d q[c, d] k[j, d]
    exp(gc[c, d] − gc[j, d]) for j ≤ c and L[c, j] the same with k in
    place of q for j < c, 0 above.

    Exact without overflow: the lower-left quarter of every aligned block
    of s positions (s = n, n/2, ..., 2) is one product of the rows scaled
    by exp(gc − r) and k's columns by exp(r − gc), r = gc at the last
    position of the block's first half; gc falls along a chunk (a
    cumulative sum of log-decays ≤ 0), so both exponents are ≤ 0. The
    columns' factor is shared by the two products."""
    n = q.shape[-2]
    a = q.new_zeros(*q.shape[:-1], n)
    lk = q.new_zeros(*q.shape[:-1], n)
    dev = q.device
    s = n
    while s > 1:
        h, nb = s // 2, n // s
        shp = (*q.shape[:-2], nb, 2, h, q.shape[-1])
        qv, kv, gv = q.view(shp), k.view(shp), gc.view(shp)
        ref = gv[..., 0, h - 1:h, :]
        cols = (ref - gv[..., 0, :, :]).exp_().mul_(kv[..., 0, :, :]) \
            .transpose(-1, -2)
        later = (gv[..., 1, :, :] - ref).exp_()
        blk = torch.arange(nb, device=dev)[:, None, None] * s
        at = (blk + h + torch.arange(h, device=dev)[:, None],
              blk + torch.arange(h, device=dev))
        a[..., at[0], at[1]] = (later * qv[..., 1, :, :]) @ cols
        lk[..., at[0], at[1]] = later.mul_(kv[..., 1, :, :]) @ cols
        s = h
    a.diagonal(dim1=-2, dim2=-1).copy_((q * k).sum(-1))
    return a, lk


def state_pass(u, w, qg, aqk, kd, decay):
    """The sequential part of :func:`chunk_kda`, over the chunks in order
    from a zero state (all chunk-major [C, R, H, ...] fp32): per chunk c,
    v_new = u − w·S, o = qg·S + aqk·v_new, then S ← diag(decay) S +
    kdᵀ·v_new. -> (o [C, R, H, n, D_v], the final state [R, H, D_k,
    D_v])."""
    C, R, H = u.shape[:3]
    S = u.new_zeros(R * H, kd.shape[-1], u.shape[-1])
    o = torch.empty_like(u)
    for c in range(C):      # [R·H, n, ·] views; products accumulate in place
        vn = torch.baddbmm(u[c].flatten(0, 1), w[c].flatten(0, 1), S,
                           alpha=-1)
        oc = o[c].flatten(0, 1)
        torch.bmm(qg[c].flatten(0, 1), S, out=oc)
        oc.baddbmm_(aqk[c].flatten(0, 1), vn)
        S.mul_(decay[c].flatten(0, 1)[..., None]).baddbmm_(
            kd[c].flatten(0, 1).transpose(-1, -2), vn)
    return o, S.view(R, H, *S.shape[1:])


def chunk_kda(q, k, v, g, beta, lengths: Sequence[int], chunk: int = CHUNK):
    """The recurrence over ragged packed rows, chunkwise: q, k [N, H, D_k]
    (q already scaled), v [N, H, D_v], g [N, H, D_k] log-decays, beta [N,
    H], rows of ``lengths`` in order, each from a zero state -> (o [N, H,
    D_v], each row's final state [R, H, D_k, D_v]), fp32.

    Each row is padded to whole chunks of ``chunk`` with k = v = q = 0, g =
    0 and β = 0, which leave the state as it is, into chunk-major [C, R, H,
    n, ·] tensors (each chunk's slice dense for the state pass). Per chunk
    (the UT form of the delta rule): gc = cumsum g; L[c, j] = β_c Σ k_c
    k_j exp(gc_c − gc_j) (j < c); T = (I + L)^-1 diag β; w = T (exp(gc) ⊙
    k), u = T v; A[c, j] = Σ q_c k_j exp(gc_c − gc_j) (j ≤ c); then
    :func:`state_pass`."""
    R, dev = len(lengths), q.device
    H = q.shape[1]
    C = -(-max(lengths) // chunk)
    lens = torch.tensor(lengths)
    starts = torch.cumsum(lens, 0) - lens
    t_in = torch.arange(int(lens.sum())) - torch.repeat_interleave(starts,
                                                                   lens)
    at = ((t_in // chunk).to(dev),
          torch.repeat_interleave(torch.arange(R), lens).to(dev),
          (t_in % chunk).to(dev))

    def pad(t):
        out = t.new_zeros(C, R, H, chunk, *t.shape[2:], dtype=torch.float32)
        out[at[0], at[1], :, at[2]] = t.float()
        return out

    q, k, v, gc = pad(q), pad(k), pad(v), pad(g).cumsum_(-2)
    beta = pad(beta)                                    # [C, R, H, n]
    aqk, t = pairs(q, k, gc)
    t.mul_(beta[..., None])
    eye = torch.eye(chunk, device=dev).expand_as(t)
    t = torch.linalg.solve_triangular(t + eye, eye, upper=False,
                                      unitriangular=True)
    t.mul_(beta[..., None, :])
    eg = gc.exp()
    w = t @ (eg * k)
    u = t @ v
    del t, v
    qg = q.mul_(eg)
    del eg
    decay = gc[..., -1, :]
    kd = (decay[..., None, :] - gc).exp_().mul_(k)
    del k
    o, S = state_pass(u, w, qg, aqk, kd, decay.exp())
    return o[at[0], at[1], :, at[2]], S


# ---- the prefill between the projections ----------------------------

def _conv(raw: torch.Tensor, conv_weight: torch.Tensor, t_in: torch.Tensor,
          i: int) -> torch.Tensor:
    """SiLU of the causal depthwise conv of projection ``i`` (q, k, v) of
    packed rows' raw [N, 3W], in fp32; ``t_in`` [N] each token's position
    in its row."""
    W, K = raw.shape[1] // 3, conv_weight.shape[1]
    r32 = raw[:, i * W:(i + 1) * W].float()
    w = conv_weight[i * W:(i + 1) * W].float()
    y = r32 * w[:, K - 1]
    for m in range(1, K):           # the input m tokens back, in-row
        back = torch.zeros_like(r32)
        back[m:] = r32[:-m]
        y += back.masked_fill_((t_in < m)[:, None], 0.0) * w[:, K - 1 - m]
    return F.silu(y)


def _gated_norm(o, gate, g_bias, o_norm, eps: float, dtype) -> torch.Tensor:
    """o [T, H, D] fp32, gate logits [T, W] -> RMSNorm(o) · w_norm ·
    sigmoid(gate + g_bias) [T, W] in ``dtype``."""
    y = F.rms_norm(o, (o.shape[-1],), o_norm.float(), eps) * torch.sigmoid(
        gate.float() + g_bias.float()).view(o.shape)
    return y.flatten(1).to(dtype)


def kda_prefill_plain(p, fg, conv_weight, A_log, dt_bias, g_bias, o_norm,
                      eps: float, rows: Sequence[tuple], state, conv_state):
    """The PyTorch version of :func:`kda_prefill`: the chunkwise form
    (:func:`chunk_kda`)."""
    N = p.shape[0]
    W, K = conv_weight.shape[0] // 3, conv_weight.shape[1]
    H, D = A_log.shape[0], o_norm.shape[0]
    raw = p[:, :3 * W]
    starts = torch.tensor([s for s, _ in rows], dtype=torch.long)
    lens = torch.tensor([n for _, n in rows], dtype=torch.long)
    t_in = torch.arange(N) - torch.repeat_interleave(starts, lens)
    t_in = t_in.to(p.device)
    q, k, v = (_conv(raw, conv_weight, t_in, i).view(N, H, D)
               for i in range(3))
    q = _l2(q) * D ** -0.5
    k = _l2(k)
    g = -A_log.float().exp()[:, None] * F.softplus(
        fg[0].float() + dt_bias.float()).unflatten(-1, (H, D))
    beta = torch.sigmoid(p[:, -H:].float())
    o, final = chunk_kda(q, k, v, g, beta, [n for _, n in rows])
    state.copy_(final)
    # the last K-1 inputs of each row, oldest first, 0 before it
    j = torch.arange(K - 1) - (K - 1)
    at = (starts + lens)[:, None] + j[None]
    ok = (lens[:, None] + j[None]) >= 0
    last = raw[at.clamp(min=0).to(p.device)]
    conv_state.copy_(last.masked_fill_(~ok.to(p.device)[..., None], 0))
    return _gated_norm(o, fg[1], g_bias, o_norm, eps, p.dtype)


def _check_rows(rows: Sequence[tuple], N: int) -> None:
    """Raise ValueError unless ``rows`` packs [0, N) in order."""
    lens = [n for _, n in rows]
    if (not rows or min(lens) < 0
            or [s for s, _ in rows] != list(accumulate([0] + lens[:-1]))
            or sum(lens) != N):
        raise ValueError(f"rows {list(rows)} must pack [0, {N}) in order")


def kda_prefill(p: torch.Tensor, fg: torch.Tensor, conv_weight: torch.Tensor,
                A_log: torch.Tensor, dt_bias: torch.Tensor,
                g_bias: torch.Tensor, o_norm: torch.Tensor, eps: float,
                rows: Sequence[tuple], state: torch.Tensor,
                conv_state: torch.Tensor) -> torch.Tensor:
    """The KDA prefill of ragged packed rows ((start, length) each, packing
    [0, N) in order), each from a zero state, after the projections -> the
    gated RMSNorm's output [N, W] in p's dtype. p [N, 3W + 2D + H] and fg
    [2, N, W] as for :func:`kda_decode`; writes each row's final state
    into ``state`` [R, H, D, D] (fp32) and its last K−1 raw inputs (oldest
    first, 0 before the row) into ``conv_state`` [R, K−1, 3W]. CPU tensors
    take the plain version, CUDA tensors the kernel (or raise); autograd
    recording a gradient of an operand raises on every device."""
    _cuda_call.refuse_autograd("kda_prefill", p, fg, conv_weight, A_log,
                               dt_bias, g_bias, o_norm)
    if p.device.type == "cpu":
        return kda_prefill_plain(p, fg, conv_weight, A_log, dt_bias, g_bias,
                                 o_norm, eps, rows, state, conv_state)
    if p.device.type != "cuda":
        raise ValueError(f"kda_prefill runs on cpu (plain) or cuda (kernel), "
                         f"not {p.device}")
    _check(p, fg, conv_weight, A_log, dt_bias, g_bias, o_norm, state,
           conv_state, rows=len(rows))
    N, R, H = p.shape[0], len(rows), A_log.shape[0]
    _check_rows(rows, N)
    # (row, start, length), longest first: the long rows' blocks start first
    order = sorted(range(R), key=lambda r: -rows[r][1])
    info = torch.tensor([[r, *rows[r]] for r in order], dtype=torch.int32
                        ).to(p.device, non_blocking=True)
    out = torch.empty(N, H * HEAD_DIM, dtype=p.dtype, device=p.device)
    _cuda_call.call(
        "kda_prefill", "plppppppfppppiii", p.device, p.data_ptr(),
        p.stride(0), fg.data_ptr(), conv_weight.data_ptr(), A_log.data_ptr(),
        dt_bias.data_ptr(), g_bias.data_ptr(), o_norm.data_ptr(), float(eps),
        info.data_ptr(), state.data_ptr(), conv_state.data_ptr(),
        out.data_ptr(), R, N, H)
    _cuda_call.count_launch(kda_prefill)
    return out


kda_prefill.launches = 0


# ---- the decode step -------------------------------------------------

def kda_decode_plain(p, fg, conv_weight, A_log, dt_bias, g_bias, o_norm,
                     eps: float, state, conv_state):
    """The PyTorch version of :func:`kda_decode`."""
    R = p.shape[0]
    W, K = conv_weight.shape[0] // 3, conv_weight.shape[1]
    H, D = A_log.shape[0], o_norm.shape[0]
    raw = p[:, :3 * W]
    hist = torch.cat([conv_state, raw[:, None]], dim=1).float()  # [R, K, 3W]
    y = F.silu((hist * conv_weight.float().t()[None]).sum(1))
    conv_state.copy_(torch.cat([conv_state[:, 1:], raw[:, None]], dim=1))
    q, k, v = y.view(R, 3, H, D).unbind(1)
    q = _l2(q) * D ** -0.5
    k = _l2(k)
    a = torch.exp(-A_log.float().exp()[:, None] * F.softplus(
        fg[0].float() + dt_bias.float()).view(R, H, D))
    beta = torch.sigmoid(p[:, -H:].float())
    S = state * a[..., None]
    u = beta[..., None] * (v - torch.einsum("rhk,rhkv->rhv", k, S))
    S = S + k[..., None] * u[..., None, :]
    state.copy_(S)
    o = torch.einsum("rhk,rhkv->rhv", q, S)
    return _gated_norm(o, fg[1], g_bias, o_norm, eps, p.dtype)


def _check(p, fg, conv_weight, A_log, dt_bias, g_bias, o_norm, state,
           conv_state, rows: Optional[int] = None) -> None:
    """Raise ValueError on operands the kernels do not take: the decode
    kernel's (one token a row), or with ``rows`` the prefill kernel's
    (p's and fg's N tokens of that many rows)."""
    H = A_log.shape[0] if A_log.dim() == 1 else -1
    W = H * HEAD_DIM
    N = p.shape[0] if p.dim() == 2 else -1
    R = N if rows is None else rows
    want = {"p": (p, (N, 3 * W + 2 * HEAD_DIM + H), torch.bfloat16),
            "fg": (fg, (2, N, W), torch.bfloat16),
            "conv_weight": (conv_weight, (3 * W, CONV), torch.bfloat16),
            "A_log": (A_log, (H,), torch.float32),
            "dt_bias": (dt_bias, (W,), torch.float32),
            "g_bias": (g_bias, (W,), torch.bfloat16),
            "o_norm": (o_norm, (HEAD_DIM,), torch.bfloat16),
            "state": (state, (R, H, HEAD_DIM, HEAD_DIM), torch.float32),
            "conv_state": (conv_state, (R, CONV - 1, 3 * W),
                           torch.bfloat16)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {dtype} {shape} (head size {HEAD_DIM}, conv "
                f"{CONV}), got {t.dtype} {tuple(t.shape)}")
    if p.stride(1) != 1 or p.device != state.device:
        raise ValueError(f"p's rows must be dense, on {state.device}")
    _cuda_call.check_tensors(p.device, [
        (n, t) for n, (t, _, _) in want.items() if n != "p"])
    if (R > 65535 or H > 65535) if rows is None else R * H >= 2 ** 31:
        raise ValueError(f"{R} rows x {H} heads exceed the launch grid")


def kda_decode(p: torch.Tensor, fg: torch.Tensor, conv_weight: torch.Tensor,
               A_log: torch.Tensor, dt_bias: torch.Tensor,
               g_bias: torch.Tensor, o_norm: torch.Tensor, eps: float,
               state: torch.Tensor, conv_state: torch.Tensor
               ) -> torch.Tensor:
    """One KDA decode step of R rows after the projections -> the gated
    RMSNorm's output [R, W] in p's dtype. p [R, 3W + 2D + H]: in_proj's
    output (raw q, k, v in the first 3W columns, β's logits in the last
    H); fg [2, R, W]: W_fb's and W_gb's outputs; ``state`` [R, H, D, D]
    (fp32) and ``conv_state`` [R, K−1, 3W] (the last K−1 raw inputs,
    oldest first) are updated in place. CPU tensors take the plain
    version, CUDA tensors the kernel (or raise); autograd recording a
    gradient of an operand raises on every device."""
    _cuda_call.refuse_autograd("kda_decode", p, fg, conv_weight, A_log,
                               dt_bias, g_bias, o_norm)
    if p.device.type == "cpu":
        return kda_decode_plain(p, fg, conv_weight, A_log, dt_bias, g_bias,
                                o_norm, eps, state, conv_state)
    if p.device.type != "cuda":
        raise ValueError(f"kda_decode runs on cpu (plain) or cuda (kernel), "
                         f"not {p.device}")
    _check(p, fg, conv_weight, A_log, dt_bias, g_bias, o_norm, state,
           conv_state)
    R, H = p.shape[0], A_log.shape[0]
    out = torch.empty(R, H * HEAD_DIM, dtype=p.dtype, device=p.device)
    _cuda_call.call(
        "kda_decode", "plppppppfpppii", p.device, p.data_ptr(), p.stride(0),
        fg.data_ptr(), conv_weight.data_ptr(), A_log.data_ptr(),
        dt_bias.data_ptr(), g_bias.data_ptr(), o_norm.data_ptr(), float(eps),
        state.data_ptr(), conv_state.data_ptr(), out.data_ptr(), R, H)
    _cuda_call.count_launch(kda_decode)
    return out


kda_decode.launches = 0
