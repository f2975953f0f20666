"""Operations and bytes of the topic LM (Moonlight-16B-A3B's block, the
configuration's top-level keys), from shapes and the program's spans, and
the card time of the work launched inside those spans.

Counts follow real tokens and each row's own length, never the padded or
capacity shapes the program runs; a multiply-add is two operations.
Peaks: ``_counts.py`` (989 TFLOP/s bf16, 3.35 TB/s).

- Prefill (``topics.prefill``, attribute ``lengths``): per token and layer
  the MLA products (q, kv_a, kv_b, o), the dense FFN or the MoE (the
  ``num_experts_per_tok`` routed experts, the shared experts, the router),
  per row the causal score and value products over its own pairs
  L(L + 1) / 2, and per row the head at its last position.
- Decode (``topics.decode``, attributes ``steps``, ``lengths``,
  ``experts_touched``): each step reads every weight outside the routed
  experts once (bf16; the routers fp32), the routed experts its rows chose
  (``experts_touched`` over the steps, each 3 x H x F bf16), and each
  row's latent cache up to its position (``kv_lora_rank`` +
  ``qk_rope_head_dim`` bf16 per token and layer), and writes its logits;
  the bound sums bytes and operations over the steps and takes the larger
  time, which is at most the sum of the steps' own bounds.
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
_ps = _load("bench_program_spans", "_program_spans.py")

ELEM = 2          # bf16


def spans(run, name):
    """The program's spans named ``name`` in the traced window, or []."""
    return [s for s in _ps.spans(run) or () if s.name == name]


def _launched(run, name):
    """(correlation ids of the launches, graph launches included, that
    each span ``name``'s thread made inside it, number of spans), or None
    without a trace or such spans."""
    got = spans(run, name)
    if run.trace is None or not got:
        return None
    by_tid = {}
    for s in got:
        lo, hi = _ps.on_trace(run, s)
        for tid in _ps.trace_tids(s):
            by_tid.setdefault(tid, []).append((lo, hi))
    corr = set()
    for e in run.trace.launches:
        iv = by_tid.get(e["tid"])
        c = (e.get("args") or {}).get("correlation")
        if iv is None or c is None:
            continue
        ts = float(e["ts"])
        if any(lo <= ts <= hi for lo, hi in iv):
            corr.add(c)
    return corr, len(got)


def device_s(run, name):
    """(card seconds of the kernels, copies and sets that each span
    ``name``'s thread launched inside it, number of spans), or None
    without a trace or such spans."""
    got = _launched(run, name)
    if got is None:
        return None
    corr, n = got
    dev = sum(float(e["dur"]) for e in run.trace.device
              if (e.get("args") or {}).get("correlation") in corr)
    return dev / 1e6, n


def kernels(run, name):
    """Kernels the card ran for the launches made inside the spans
    ``name`` (each node of a replayed CUDA graph is one), or None without
    a trace or such spans."""
    got = _launched(run, name)
    if got is None:
        return None
    return sum(1 for e in run.trace.device if e.get("cat") == "kernel"
               and (e.get("args") or {}).get("correlation") in got[0])


def _widths(m):
    h, nh = m["hidden_size"], m["num_attention_heads"]
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    lat = m["kv_lora_rank"] + m["qk_rope_head_dim"]
    attn = (h * nh * qk + h * lat
            + m["kv_lora_rank"] * nh * (m["qk_nope_head_dim"]
                                        + m["v_head_dim"])
            + nh * m["v_head_dim"] * h)
    expert = 3 * h * m["moe_intermediate_size"]
    shared = 3 * h * m["moe_intermediate_size"] * m["n_shared_experts"]
    dense = 3 * h * m["intermediate_size"]
    router = h * m["n_routed_experts"]
    n_dense = m["first_k_dense_replace"]
    n_moe = m["num_hidden_layers"] - n_dense
    return dict(h=h, nh=nh, qk=qk, lat=lat, attn=attn, expert=expert,
                shared=shared, dense=dense, router=router, n_dense=n_dense,
                n_moe=n_moe, layers=m["num_hidden_layers"],
                vocab=m["vocab_size"], k=m["num_experts_per_tok"],
                v=m["v_head_dim"])


def token_flops(m):
    """Operations of one token through every layer's products (no
    attention core, no head)."""
    w = _widths(m)
    per_moe = w["attn"] + w["k"] * w["expert"] + w["shared"] + w["router"]
    return 2 * (w["n_dense"] * (w["attn"] + w["dense"])
                + w["n_moe"] * per_moe)


def prefill_flops(m, lengths):
    """Operations of the ragged prefill of rows of these prompt lengths."""
    w = _widths(m)
    core = 0
    for L in lengths:
        pairs = L * (L + 1) // 2
        core += 2 * w["nh"] * (w["qk"] + w["v"]) * pairs
    return (token_flops(m) * sum(lengths) + w["layers"] * core
            + 2 * w["h"] * w["vocab"] * len(lengths))


def decode_bound_s(m, steps, lengths, experts_touched):
    """Least card time of one decode loop of ``steps`` steps over rows of
    these prompt lengths, whose rows touched ``experts_touched`` experts
    over all MoE layers and steps."""
    w = _widths(m)
    R = len(lengths)
    weights = (w["layers"] * w["attn"] + w["n_dense"] * w["dense"]
               + w["n_moe"] * w["shared"] + w["h"] * w["vocab"])
    nbytes = steps * (ELEM * weights + 4 * w["n_moe"] * w["router"]
                      + ELEM * R * (w["vocab"] + w["h"]
                                    + w["layers"] * w["lat"]))
    nbytes += ELEM * w["expert"] * experts_touched
    positions = sum(L + s for L in lengths for s in range(1, steps + 1))
    nbytes += ELEM * w["layers"] * w["lat"] * positions
    ops = steps * R * (token_flops(m) + 2 * w["h"] * w["vocab"])
    ops += 2 * w["layers"] * w["nh"] * (w["lat"] + m["kv_lora_rank"]) \
        * positions
    return max(ops / _counts.BF16_FLOPS, nbytes / _counts.HBM_BYTES_S)
