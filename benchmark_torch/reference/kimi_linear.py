"""Plain fp32 reference of Kimi-Linear-48B-A3B's forward pass (HF
``model_type: kimi_linear``; the KDA layer as flash-linear-attention's
``fla/layers/kda.py`` and ``fla/ops/kda/naive.py`` define it): every layer
over the whole sequence, no cache, no batching. Imports nothing of the
program under test; it shares the plain helpers of :mod:`.moonlight`.

The configuration is read by Kimi's own key names (``linear_attn_config``,
``num_experts``, ``num_experts_per_token``, ``moe_renormalize``,
``mla_use_nope``, ...). Each layer's token mixer is:

- at the 1-based ``linear_attn_config.kda_layers``, Kimi Delta Attention
  as the token-by-token recurrence (``naive_recurrent_kda``): q, k, v =
  SiLU(causal depthwise conv of the projections), q and k L2-normalised (x
  / sqrt(Σx² + 1e-6)), q times d_k^-½, g = −exp(A_log) · softplus(f +
  dt_bias) per key channel, β = sigmoid(W_b x); per token S ← diag(exp g)
  S, S ← S + β k (v − Sᵀk)ᵀ, o = Sᵀq; then RMSNorm(o) · w_norm ·
  sigmoid(W_gb W_ga x + b_gb) per head and W_o;
- elsewhere MLA without a q LoRA in its expanded form (k_nope and v from
  the normalised latent, one causal softmax over the sequence) with no
  rotation (``mla_use_nope``).

The FFN is a SiLU-gated MLP in the first ``first_k_dense_replace`` layers
and the MoE after: sigmoid scores over the router's experts, the top
``num_experts_per_token`` by score + correction bias, weights from the
unbiased scores renormalised over all k and times
``routed_scaling_factor``, each held expert its own product, plus the
shared expert.

Parameters come from ``get(name)`` by the program's names, in the
program's layout (a departure from HF's module names): a KDA layer's
``self_attn.in_proj.weight`` holds W_q, W_k, W_v, W_fa, W_ga and W_b as
rows in that order; ``conv_weight`` [3W, 4] the depthwise kernels of q, k
and v (the last tap multiplies the newest input); ``fg_b`` [2, W, 128]
W_fb then W_gb; ``g_bias`` W_gb's bias; ``A_log``, ``dt_bias``,
``o_norm``, ``o_proj.weight``. The MLPs hold gate and up as one
``gate_up_proj`` and a layer's experts are stacked, as in
:mod:`.moonlight`.

Other departures, each for the comparison: the expert share is the
program's (``num_experts`` experts held, from
``expert_parallel.first_expert``, of ``expert_parallel.router_experts``:
the copies routed to experts held elsewhere are dropped, and their
exchange is left out, as in the program); the head runs only at the
positions asked for; every product, the recurrence, the softmax and the
norms run in fp32 with TF32 off (the published model runs bf16); the
routing may take the program's choice as a hint (``moonlight.route``);
each KDA layer's state may be kept after a given position; and, for the
state check alone, :func:`kda` may hold its projections' outputs in the
program's dtype.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .moonlight import Get, layer_params, mlp, no_tf32, rms_norm, route

__all__ = ["forward", "layer_params", "kda", "attention", "moe"]

L2_EPS = 1e-6


def _l2(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def kda(get: Get, p: str, cfg: Dict, x, keep_at: Optional[int] = None,
        held=None):
    """Kimi Delta Attention over one whole sequence x [T, H] from a zero
    state, token by token -> (output [T, H], the state [heads, d_k, d_v]
    after position ``keep_at`` or None). ``held`` (a dtype) rounds the
    projections' outputs to it, as a program holds them in its compute
    dtype (a departure for the state check: everything after the
    projections stays fp32)."""
    lin = cfg["linear_attn_config"]
    H, D, K = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    W, T = H * D, x.shape[0]

    def out(t):
        return t if held is None else t.to(held).float()

    proj = out(x @ get(f"{p}.in_proj.weight").T)
    raw, fa, ga, b = proj.split([3 * W, D, D, H], dim=-1)
    fg_b = get(f"{p}.fg_b")
    f = out(fa @ fg_b[0].T)
    gate = out(ga @ fg_b[1].T) + get(f"{p}.g_bias")
    conv = F.conv1d(raw.T[None], get(f"{p}.conv_weight")[:, None, :],
                    padding=K - 1, groups=3 * W)[0, :, :T].T
    q, k, v = F.silu(conv).view(T, 3, H, D).unbind(1)
    q = _l2(q) * D ** -0.5
    k = _l2(k)
    g = -get(f"{p}.A_log").exp()[:, None] * F.softplus(
        f + get(f"{p}.dt_bias")).view(T, H, D)
    beta = torch.sigmoid(b)
    a = g.exp()
    S = x.new_zeros(H, D, D)
    o = x.new_empty(T, H, D)
    kept = None
    for t in range(T):
        S = S * a[t][..., None]
        u = beta[t][:, None] * (v[t] - torch.einsum("hk,hkv->hv", k[t], S))
        S = S + k[t][..., None] * u[:, None, :]
        o[t] = torch.einsum("hk,hkv->hv", q[t], S)
        if t == keep_at:
            kept = S.clone()
    y = rms_norm(o, get(f"{p}.o_norm"), cfg["rms_norm_eps"]) \
        * torch.sigmoid(gate).view(T, H, D)
    return y.reshape(T, W) @ get(f"{p}.o_proj.weight").T, kept


def attention(get: Get, p: str, cfg: Dict, x):
    """MLA without a q LoRA over one whole sequence x [T, H], causal, the
    expanded form; q_pe and k_pe rotated by nothing (``mla_use_nope``)."""
    assert cfg.get("mla_use_nope"), "this reference runs NoPE MLA"
    T = x.shape[0]
    nh = cfg["num_attention_heads"]
    nope, rd, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    q = (x @ get(f"{p}.q_proj.weight").T).view(T, nh, nope + rd) \
        .transpose(0, 1)
    ckv = x @ get(f"{p}.kv_a_proj_with_mqa.weight").T
    c, k_pe = ckv.split([r, rd], dim=-1)
    c = rms_norm(c, get(f"{p}.kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    kv = (c @ get(f"{p}.kv_b_proj.weight").T).view(T, nh, nope + vd) \
        .transpose(0, 1)
    k_nope, v = kv.split([nope, vd], dim=-1)
    ks = torch.cat([k_nope, k_pe[None].expand(nh, -1, -1)], dim=-1)
    s = (q @ ks.transpose(1, 2)) * (nope + rd) ** -0.5
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    s = s.masked_fill(mask, float("-inf")).softmax(dim=-1)
    o = (s @ v).transpose(0, 1).reshape(T, nh * vd)
    return o @ get(f"{p}.o_proj.weight").T


def moe(get: Get, p: str, cfg: Dict, x, hint=None, tie_tol=0.0, gaps=None):
    """The MoE on x [T, H] with this chip's share of the experts: sigmoid
    scores over the router's experts, top k on the biased scores, weights
    from the unbiased ones renormalised over all k and scaled, each held
    expert on its own tokens (a copy routed elsewhere dropped), plus the
    shared expert. -> (y, ties, mismatches)."""
    share = cfg.get("expert_parallel") or {}
    first = int(share.get("first_expert", 0))
    s = (x @ get(f"{p}.gate.weight").T).sigmoid()
    biased = s + get(f"{p}.gate.e_score_correction_bias")
    # num_expert_group = 1: the group limit keeps every expert
    idx, ties, bad = route({"num_experts_per_tok":
                            cfg["num_experts_per_token"]}, biased, hint,
                           tie_tol, gaps)
    w = s.gather(1, idx)
    if cfg["moe_renormalize"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    gate_up = get(f"{p}.experts.gate_up_proj")
    down = get(f"{p}.experts.down_proj")
    y = torch.zeros_like(x)
    for e in range(gate_up.shape[0]):
        tok, slot = (idx == first + e).nonzero(as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, mlp(x[tok], gate_up[e], down[e])
                         * w[tok, slot, None])
    y = y + mlp(x, get(f"{p}.shared_experts.gate_up_proj.weight"),
                get(f"{p}.shared_experts.down_proj.weight"))
    return y, ties, bad


def forward(get: Get, cfg: Dict, seqs: Sequence[Sequence[int]],
            at: Sequence[Sequence[int]],
            hints: Optional[Sequence[Optional[Dict[int, torch.Tensor]]]]
            = None, tie_tol: float = 0.0, device=None,
            keep_at: Optional[Sequence[Optional[int]]] = None) -> Dict:
    """Each sequence of token ids alone through the whole model; the logits
    [len(at[i]), V] at its positions ``at[i]``. Layers run outermost, so
    each layer's parameters are read once for every sequence; no product
    mixes two sequences. ``hints[i]`` maps a MoE layer to the program's
    chosen experts [T, k] of sequence i (``moonlight.route``);
    ``keep_at[i]`` keeps each KDA layer's state after that position of
    sequence i. -> {"logits": [...], "kda_states": per sequence [n_kda,
    heads, d_k, d_v] or None, "route_ties", "route_mismatch",
    "route_gaps"}."""
    n_layers = cfg["num_hidden_layers"]
    kda_layers = {int(i) - 1 for i in cfg["linear_attn_config"]
                  ["kda_layers"]}
    eps = cfg["rms_norm_eps"]
    emb = get("embed_tokens.weight")
    device = device or emb.device
    xs = [emb[torch.as_tensor(list(s), device=device)] for s in seqs]
    del emb
    keep_at = list(keep_at) if keep_at is not None else [None] * len(seqs)
    kept: List[List[torch.Tensor]] = [[] for _ in seqs]
    ties = bad = 0
    gaps: list = []
    with no_tf32():
        for i in range(n_layers):
            p = f"layers.{i}"
            for j, x in enumerate(xs):
                h = rms_norm(x, get(f"{p}.input_layernorm.weight"), eps)
                if i in kda_layers:
                    a, S = kda(get, f"{p}.self_attn", cfg, h, keep_at[j])
                    if S is not None:
                        kept[j].append(S)
                else:
                    a = attention(get, f"{p}.self_attn", cfg, h)
                x = x + a
                h = rms_norm(x, get(f"{p}.post_attention_layernorm.weight"),
                             eps)
                if i >= cfg["first_k_dense_replace"]:
                    hint = (hints[j] or {}).get(i) if hints else None
                    y, a_, b_ = moe(get, f"{p}.mlp", cfg, h, hint, tie_tol,
                                    gaps)
                    ties, bad = ties + a_, bad + b_
                else:
                    y = mlp(h, get(f"{p}.mlp.gate_up_proj.weight"),
                            get(f"{p}.mlp.down_proj.weight"))
                xs[j] = x + y
        norm = get("norm.weight")
        head = get("lm_head.weight")
        logits = [rms_norm(x[torch.as_tensor(list(a), device=device)], norm,
                           eps) @ head.T for x, a in zip(xs, at)]
    return {"logits": logits,
            "kda_states": [torch.stack(k) if k else None for k in kept],
            "route_ties": ties, "route_mismatch": bad,
            "route_gaps": torch.cat(gaps) if gaps else torch.zeros(0)}
