"""Operations and bytes of the Kimi-Linear topic LM (the configuration's
top-level keys by Kimi's names: ``linear_attn_config``, ``num_experts``
held of ``expert_parallel.router_experts``, ``num_experts_per_token``, the
MLA widths), from shapes and the program's spans, and the card time of the
work launched inside those spans (``_topics_counts.py``'s readers).

Counts follow real tokens and each row's own length, never the padded
chunks or capacity shapes the program runs; a multiply-add is two
operations. Peaks: ``_counts.py`` (989 TFLOP/s bf16, 3.35 TB/s).

- Prefill: per token the products of every layer (a KDA layer's in_proj,
  W_fb, W_gb and W_o; an MLA layer's q, kv_a, kv_b and o; the dense FFN;
  a MoE layer's router, shared expert and k · held / router_experts
  routed experts, the expected share of a token's k copies held here) and
  the KDA conv; per row, each KDA layer's chunkwise form over chunks of 64
  (:func:`kda_chunk_flops`) and each MLA layer's causal score and value
  products over the row's L(L + 1) / 2 pairs; the head at each row's last
  position.
- Decode (:func:`decode_bound_s`): each step reads every weight outside
  the routed experts once, the routed experts its rows touched (the span's
  ``experts_touched``, held experts only, each 3 x H x F bf16), each row's
  MLA latent cache up to its position at the 7 MLA layers, and reads and
  writes every KDA layer's fp32 state and bf16 conv inputs of each row.
- One launch of the KDA decode kernel (:func:`kda_launch_bound_s`): the
  state of its rows read and written in fp32, their raw q, k, v, beta, f
  and gate logits read, the conv inputs read and written, the layer's
  small parameters read, the output written.
"""

import importlib.util
from pathlib import Path

_here = Path(__file__).parent


def _load(name, file):
    spec = importlib.util.spec_from_file_location(name, _here / file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_counts = _load("bench_counts", "_counts.py")
_tc = _load("bench_topics_counts", "_topics_counts.py")
spans, device_s = _tc.spans, _tc.device_s

ELEM = 2          # bf16
CHUNK = 64


def widths(m):
    lin = m["linear_attn_config"]
    H, D, K = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    W = H * D
    h, nh = m["hidden_size"], m["num_attention_heads"]
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    lora = m["kv_lora_rank"]
    lat = lora + m["qk_rope_head_dim"]
    mla = (h * nh * qk + h * lat + lora * nh * (m["qk_nope_head_dim"]
                                                + m["v_head_dim"])
           + nh * m["v_head_dim"] * h)
    kda = h * (3 * W + 2 * D + H) + 2 * W * D + W * h
    n_kda = len(lin["kda_layers"])
    n_dense = m["first_k_dense_replace"]
    total = int((m.get("expert_parallel") or {}).get("router_experts",
                                                     m["num_experts"]))
    f = m["moe_intermediate_size"]
    return dict(
        h=h, nh=nh, qk=qk, v=m["v_head_dim"], lora=lora, lat=lat, mla=mla,
        kda=kda, kda_small=3 * W * K + W + D, kda_fp32=H + W, H=H, D=D, K=K,
        W=W, n_kda=n_kda, n_mla=m["num_hidden_layers"] - n_kda,
        n_dense=n_dense, n_moe=m["num_hidden_layers"] - n_dense,
        expert=3 * h * f, shared=3 * h * f * m["num_shared_experts"],
        dense=3 * h * m["intermediate_size"], router=h * total,
        total=total, held=int(m["num_experts"]),
        k=m["num_experts_per_token"], vocab=m["vocab_size"],
        layers=m["num_hidden_layers"])


def token_flops(m):
    """Operations of one token through every layer's products and the KDA
    conv (no attention core, no chunkwise KDA, no head); the routed
    experts at the expected share of the k copies that are held."""
    w = widths(m)
    routed = w["k"] * w["held"] / w["total"] * w["expert"]
    return 2 * (w["n_mla"] * w["mla"]
                + w["n_kda"] * (w["kda"] + w["K"] * 3 * w["W"])
                + w["n_dense"] * w["dense"]
                + w["n_moe"] * (routed + w["shared"] + w["router"]))


def kda_chunk_flops(m, L):
    """Operations of one KDA layer's chunkwise form over a row of L tokens
    (every head): per chunk of n tokens the decayed q·k and k·k pairs, the
    triangular solve, w and u, and the state pass (w·S, q·S, A·v_new,
    k_dᵀ·v_new)."""
    w = widths(m)
    D = w["D"]
    full, rem = divmod(int(L), CHUNK)
    total = 0
    for n in [CHUNK] * full + ([rem] if rem else []):
        incl, strict = n * (n + 1) // 2, n * (n - 1) // 2
        total += (2 * D * (incl + strict) + n ** 3 + 2 * 2 * D * incl
                  + 3 * 2 * n * D * D + 2 * D * incl)
    return w["H"] * total


def prefill_flops(m, lengths):
    """Operations of the ragged prefill of rows of these prompt lengths."""
    w = widths(m)
    out = token_flops(m) * sum(lengths)
    for L in lengths:
        pairs = L * (L + 1) // 2
        out += w["n_mla"] * 2 * w["nh"] * (w["qk"] + w["v"]) * pairs
        out += w["n_kda"] * kda_chunk_flops(m, L)
        out += 2 * w["h"] * w["vocab"]
    return out


def kda_launch_bound_s(m, rows):
    """Least card time of one launch of the KDA decode kernel over
    ``rows`` rows."""
    w = widths(m)
    H, D, W, K = w["H"], w["D"], w["W"], w["K"]
    nbytes = (2 * 4 * rows * H * D * D
              + ELEM * rows * (3 * W + H + 2 * W + W)
              + 2 * ELEM * rows * (K - 1) * 3 * W
              + ELEM * (3 * W * K + W + D) + 4 * (H + W))
    ops = rows * (7 * H * D * D + 2 * K * 3 * W)
    return max(ops / _counts.BF16_FLOPS, nbytes / _counts.HBM_BYTES_S)


def decode_bound_s(m, steps, lengths, experts_touched):
    """Least card time of one decode loop of ``steps`` steps over rows of
    these prompt lengths, whose rows touched ``experts_touched`` held
    experts over all MoE layers and steps."""
    w = widths(m)
    R = len(lengths)
    weights = (w["n_mla"] * w["mla"] + w["n_kda"] * (w["kda"]
                                                     + w["kda_small"])
               + w["n_dense"] * w["dense"]
               + w["n_moe"] * (w["shared"] + w["router"])
               + w["h"] * w["vocab"])
    per_step = (ELEM * weights + 4 * (w["n_kda"] * w["kda_fp32"]
                                      + w["n_moe"] * w["total"])
                + ELEM * R * (w["vocab"] + w["h"])
                + w["n_kda"] * R * (2 * 4 * w["H"] * w["D"] * w["D"]
                                    + 2 * ELEM * (w["K"] - 1) * 3 * w["W"]))
    nbytes = steps * per_step + ELEM * w["expert"] * experts_touched
    positions = sum(L + s for L in lengths for s in range(1, steps + 1))
    nbytes += ELEM * w["n_mla"] * w["lat"] * positions
    ops = steps * R * (token_flops(m) + 2 * w["h"] * w["vocab"]
                       + w["n_kda"] * 7 * w["H"] * w["D"] * w["D"])
    ops += 2 * w["n_mla"] * w["nh"] * (w["lat"] + w["lora"]) * positions
    return max(ops / _counts.BF16_FLOPS, nbytes / _counts.HBM_BYTES_S)
