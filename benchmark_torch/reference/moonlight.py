"""Plain fp32 reference of Moonlight-16B-A3B's forward pass (the DeepSeek-V3
block, HF ``modeling_deepseek.py`` / ``DeepseekV3ForCausalLM``): full
causal attention over the whole sequence, no cache, no batching, every
expert as its own product. Imports nothing of the program under test.

Parameters come from ``get(name) -> tensor`` by the names of HF's modules
without the ``model.`` prefix, with two layout differences the program's
state dict has: each SiLU-gated MLP holds gate and up as one
``gate_up_proj`` [2F, H] (gate rows first), and a layer's routed experts
are stacked (``mlp.experts.gate_up_proj`` [E, 2F, H],
``mlp.experts.down_proj`` [E, H, F]). Every tensor is upcast to fp32 as it
is read, one layer at a time, so the reference fits beside a bf16 program.

Departures from DeepSeek-V3's modelling code, each noted where it is made:
the group-limited choice (``n_group`` = ``topk_group`` = 1) is the
identity and is not computed; the head runs only at the positions asked
for; the softmax, every product and RoPE run in fp32 with TF32 off (the
published model runs bf16); and, for the comparison, the routing may take
a hint (:func:`route`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Get = Callable[[str], torch.Tensor]


@contextlib.contextmanager
def no_tf32():
    """fp32 products in true fp32 inside the block."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x, w, eps):
    var = x.pow(2).mean(-1, keepdim=True)
    return w * (x * torch.rsqrt(var + eps))


def rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat((-x[..., d:], x[..., :d]), dim=-1)


def apply_rotary(x, cos, sin):
    """``apply_rotary_pos_emb`` of DeepSeek-V3's modelling code on x [...,
    T, d]: the interleaved pairs gathered into halves, then rotate_half."""
    *lead, t, d = x.shape
    x = x.reshape(*lead, t, d // 2, 2).transpose(-1, -2).reshape(*lead, t, d)
    return x * cos + rotate_half(x) * sin


def rope(cfg: Dict, t: int, device):
    d = cfg["qk_rope_head_dim"]
    inv = 1.0 / (float(cfg["rope_theta"]) ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=device),
                        inv)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def attention(get: Get, p: str, cfg: Dict, x, cos, sin):
    """``DeepseekV3Attention`` without a q LoRA over one whole sequence x
    [T, H] with a causal mask."""
    T = x.shape[0]
    nh = cfg["num_attention_heads"]
    nope, rd, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    q = (x @ get(f"{p}.q_proj.weight").T).view(T, nh, nope + rd) \
        .transpose(0, 1)
    q_nope, q_pe = q.split([nope, rd], dim=-1)
    ckv = x @ get(f"{p}.kv_a_proj_with_mqa.weight").T
    c, k_pe = ckv.split([r, rd], dim=-1)
    c = rms_norm(c, get(f"{p}.kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    kv = (c @ get(f"{p}.kv_b_proj.weight").T).view(T, nh, nope + vd) \
        .transpose(0, 1)
    k_nope, v = kv.split([nope, vd], dim=-1)
    q_pe = apply_rotary(q_pe, cos, sin)
    k_pe = apply_rotary(k_pe[None], cos, sin)
    qs = torch.cat([q_nope, q_pe], dim=-1)
    ks = torch.cat([k_nope, k_pe.expand(nh, -1, -1)], dim=-1)
    s = (qs @ ks.transpose(1, 2)) * (nope + rd) ** -0.5
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    s = s.masked_fill(mask, float("-inf")).softmax(dim=-1)
    o = (s @ v).transpose(0, 1).reshape(T, nh * vd)
    return o @ get(f"{p}.o_proj.weight").T


def mlp(x, gate_up, down):
    g, u = (x @ gate_up.T).chunk(2, dim=-1)
    return (F.silu(g) * u) @ down.T


def route(cfg: Dict, s_biased, hint=None, tie_tol: float = 0.0,
          gaps: Optional[list] = None):
    """The chosen experts [T, k] by the biased scores [T, E], and the
    counts (ties, mismatches) against the program's choice ``hint`` [T, k]
    (a departure for the comparison): where the two sets differ, the
    program's choice is taken as a tie when the reference's own k-th
    biased score exceeds the program's lowest chosen one by at most
    ``tie_tol``, and counted a mismatch otherwise (the reference then
    keeps its own choice). ``gaps`` gets that excess at every
    disagreement."""
    k = cfg["num_experts_per_tok"]
    own = torch.topk(s_biased, k, dim=-1)
    if hint is None:
        return own.indices, 0, 0
    hint = hint.to(own.indices.device).long()
    same = (own.indices.sort(-1).values == hint.sort(-1).values).all(-1)
    gap = own.values[:, -1] - s_biased.gather(1, hint).min(-1).values
    tie = ~same & (gap <= tie_tol)
    bad = ~same & ~tie
    if gaps is not None:
        gaps.append(gap[~same].cpu())
    idx = torch.where(tie[:, None], hint, own.indices)
    return idx, int(tie.sum()), int(bad.sum())


def moe(get: Get, p: str, cfg: Dict, x, hint=None, tie_tol=0.0, gaps=None):
    """``DeepseekV3MoE`` on x [T, H]: sigmoid scores, top-k on the biased
    scores, weights from the unbiased ones, renormalised and scaled, each
    expert on its own tokens, plus the shared experts."""
    s = (x @ get(f"{p}.gate.weight").T).sigmoid()
    biased = s + get(f"{p}.gate.e_score_correction_bias")
    # n_group = topk_group = 1: the group limit keeps every expert
    idx, ties, bad = route(cfg, biased, hint, tie_tol, gaps)
    w = s.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    gate_up = get(f"{p}.experts.gate_up_proj")
    down = get(f"{p}.experts.down_proj")
    y = torch.zeros_like(x)
    for e in range(gate_up.shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, mlp(x[tok], gate_up[e], down[e])
                         * w[tok, slot, None])
    y = y + mlp(x, get(f"{p}.shared_experts.gate_up_proj.weight"),
                get(f"{p}.shared_experts.down_proj.weight"))
    return y, ties, bad


def forward(get: Get, cfg: Dict, seqs: Sequence[Sequence[int]],
            at: Sequence[Sequence[int]],
            hints: Optional[Sequence[Optional[Dict[int, torch.Tensor]]]]
            = None, tie_tol: float = 0.0, device=None) -> Dict:
    """Each sequence of token ids alone through the whole model; the logits
    [len(at[i]), V] at its positions ``at[i]``. Layers run outermost, so
    each layer's parameters are read once for every sequence; no product
    mixes two sequences. ``hints[i]`` maps a MoE layer to the program's
    chosen experts [T, k] of sequence i (:func:`route`). -> {"logits":
    [...], "route_ties": n, "route_mismatch": n, "route_gaps": the
    reference's margin at every disagreement}."""
    n_layers = cfg["num_hidden_layers"]
    eps = cfg["rms_norm_eps"]
    emb = get("embed_tokens.weight")
    device = device or emb.device
    xs = [emb[torch.as_tensor(list(s), device=device)] for s in seqs]
    del emb
    T = max(len(s) for s in seqs)
    cos_all, sin_all = rope(cfg, T, device)
    ties = bad = 0
    gaps: list = []
    with no_tf32():
        for i in range(n_layers):
            p = f"layers.{i}"
            moe_layer = i >= cfg["first_k_dense_replace"]
            for j, x in enumerate(xs):
                t = x.shape[0]
                h = rms_norm(x, get(f"{p}.input_layernorm.weight"), eps)
                x = x + attention(get, f"{p}.self_attn", cfg, h,
                                  cos_all[:t], sin_all[:t])
                h = rms_norm(x, get(f"{p}.post_attention_layernorm.weight"),
                             eps)
                if moe_layer:
                    hint = (hints[j] or {}).get(i) if hints else None
                    y, a, b = moe(get, f"{p}.mlp", cfg, h, hint, tie_tol,
                                  gaps)
                    ties, bad = ties + a, bad + b
                else:
                    y = mlp(h, get(f"{p}.mlp.gate_up_proj.weight"),
                            get(f"{p}.mlp.down_proj.weight"))
                xs[j] = x + y
        norm = get("norm.weight")
        head = get("lm_head.weight")
        logits = [rms_norm(x[torch.as_tensor(list(a), device=device)], norm,
                           eps) @ head.T for x, a in zip(xs, at)]
    return {"logits": logits, "route_ties": ties, "route_mismatch": bad,
            "route_gaps": torch.cat(gaps) if gaps else torch.zeros(0)}


def layer_params(state: Dict[str, torch.Tensor], device=None) -> Get:
    """``get`` over a state dict (any dtype, any device), upcasting each
    tensor to fp32 on ``device`` when read, and keeping only the layer last
    read, so that at most one layer is held in fp32."""
    held: Dict[str, torch.Tensor] = {}
    layer: List[Optional[str]] = [None]

    def get(name: str) -> torch.Tensor:
        prefix = ".".join(name.split(".")[:2]) \
            if name.startswith("layers.") else None
        if prefix != layer[0] and prefix is not None:
            held.clear()
            layer[0] = prefix
        t = held.get(name)
        if t is None:
            src = state[name]
            t = src.to(device or src.device, torch.float32)
            if prefix is not None:
                held[name] = t
        return t

    return get
