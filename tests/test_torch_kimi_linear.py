"""The topic LM's Kimi-Linear hybrid (``models/moe_lm.py`` with
``models/kda.py``: KDA, KDA, KDA, then NoPE MLA, the first layer dense, 8
of 16 experts held) at tiny widths against the plain fp32 reference
``benchmark_torch/reference/kimi_linear.py`` on seeded weights: prefill
logits, prefill then decode through the KDA states and the latent cache
at every position with ragged rows across chunk boundaries, the chunked
prefill and the decode step's plain twin against the recurrence, the NoPE
MLA, the expert share, Kimi's configuration keys, and the local topic
backend selected by ``topic_model`` alone. CPU; the card-only test is
marked ``cuda`` and skips here.

Tolerances: fp32 program against fp32 reference within 1e-5 relative (the
chunked form and the batched products sum in other orders); the chunked
form against the recurrence within 1e-4 absolute under decays of up to
e^-2 a token.
"""

import copy
import dataclasses

import pytest
import torch

from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.host import topics as topics_mod
from audio_processor_tpu_torch.models import kda, moe_lm
from audio_processor_tpu_torch.obs import profiler
from benchmark_torch.reference import kimi_linear as ref

# Kimi's key names at tiny widths: 4 layers, KDA at 1-based 1-3, MLA at 4
KIMI = {
    "model_type": "kimi_linear", "vocab_size": 640, "hidden_size": 64,
    "intermediate_size": 128, "moe_intermediate_size": 32,
    "num_hidden_layers": 4, "num_attention_heads": 4,
    "num_key_value_heads": 4, "kv_lora_rank": 32, "q_lora_rank": None,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "num_experts": 8, "expert_parallel": {"router_experts": 16,
                                          "first_expert": 0},
    "num_experts_per_token": 4, "num_shared_experts": 1,
    "moe_router_activation_func": "sigmoid", "moe_renormalize": True,
    "routed_scaling_factor": 2.446, "first_k_dense_replace": 1,
    "num_expert_group": 1, "topk_group": 1, "use_grouped_topk": True,
    "linear_attn_config": {"kda_layers": [1, 2, 3], "full_attn_layers": [4],
                           "num_heads": 2, "head_dim": 16,
                           "short_conv_kernel_size": 4},
    "mla_use_nope": True, "rms_norm_eps": 1e-5, "rope_theta": 10000,
    "model_max_length": 1048576, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 600, "eos_token_id": 601}
TINY = moe_lm.MoELMConfig.from_dict(KIMI)


def _share(first):
    d = copy.deepcopy(KIMI)
    d["expert_parallel"]["first_expert"] = first
    return d


@pytest.fixture(scope="module")
def model():
    return moe_lm.build_synthetic(TINY, "cpu", seed=3)


def _prompts(lengths, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 600, (n,), generator=g).tolist()
            for n in lengths]


def _generate(model, prompts, max_new, taps=()):
    model.tap = lambda kind, rows, steps: taps
    try:
        with torch.inference_mode():
            out = model.generate(prompts, max_new, "summary")
        return out, model.tapped["summary"]
    finally:
        model.tap = None
        model.tapped = {}


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _reference(model, seqs, at, cfg=KIMI, **kw):
    return ref.forward(ref.layer_params(model.state_dict()), cfg, seqs, at,
                       **kw)


def test_config_reads_kimis_keys_and_caps_the_positions():
    c = TINY
    assert (c.n_routed_experts, c.held_experts, c.first_held_expert) == \
        (16, 8, 0)
    assert c.kda_layers == (0, 1, 2) and c.mla_layers == [3]
    assert (c.num_experts_per_tok, c.n_shared_experts, c.norm_topk_prob,
            c.scoring_func, c.mla_use_nope) == (4, 1, True, "sigmoid", True)
    assert c.max_position_embeddings == 1048576
    assert c.positions == moe_lm.MAX_POSITIONS == 8192
    whole = moe_lm.MoELMConfig.from_dict(
        {k: v for k, v in KIMI.items() if k != "expert_parallel"})
    assert whole.held_experts == whole.n_routed_experts == 8
    with pytest.raises(ValueError, match="experts held"):
        moe_lm.MoELMConfig.from_dict(_share(9))


def test_published_widths_count_49_b_and_the_half_25_6_b():
    """Kimi-Linear-48B-A3B's parameters at its published widths (counted on
    the meta device): ≈ 49.1 B whole, ≈ 25.6 B with 128 of 256 experts."""
    pub = {"vocab_size": 163840, "hidden_size": 2304,
           "intermediate_size": 9216, "moe_intermediate_size": 1024,
           "num_hidden_layers": 27, "num_attention_heads": 32,
           "num_key_value_heads": 32, "kv_lora_rank": 512,
           "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
           "v_head_dim": 128, "num_experts": 256, "num_experts_per_token": 8,
           "num_shared_experts": 1, "first_k_dense_replace": 1,
           "mla_use_nope": True, "linear_attn_config": {
               "kda_layers": [i for i in range(1, 28) if i % 4 and i != 27],
               "num_heads": 32, "head_dim": 128, "short_conv_kernel_size": 4}}
    counts = []
    for extra in ({}, {"expert_parallel": {"router_experts": 256}}):
        d = dict(pub, **extra)
        if extra:
            d["num_experts"] = 128
        with torch.device("meta"):
            m = moe_lm.MoELM(moe_lm.MoELMConfig.from_dict(d))
        counts.append(sum(p.numel() for p in m.parameters()))
        assert len(m.cfg.kda_layers) == 20
    assert abs(counts[0] - 49.1e9) < 0.2e9, counts
    assert abs(counts[1] - 25.6e9) < 0.1e9, counts


def test_prefill_logits_match_reference(model):
    prompts = _prompts([5, 70, 130])
    out, tapped = _generate(model, prompts, 2, taps={1})
    r = _reference(model, prompts, [[len(p) - 1] for p in prompts])
    for i in range(3):
        assert _rel(tapped["first_logits"][i], r["logits"][i][0]) < 1e-5
        assert int(out["ids"][i, 0]) == int(r["logits"][i][0].argmax())


def test_prefill_then_decode_through_states_matches_full_forward(model):
    """Ragged rows across the 64-token chunks' boundaries: greedy tokens
    fed back through the KDA states, the conv states and the latent cache
    give at every decode step the full forward's logits, and each row's
    KDA states after the prefill equal the recurrence's."""
    prompts = _prompts([63, 9, 129, 64], seed=1)
    n = 7
    out, tapped = _generate(model, prompts, n, taps=set(range(1, n)))
    seqs = [p + out["ids"][r, :n - 1].tolist()
            for r, p in enumerate(prompts)]
    at = [[len(p) - 1 + j for j in range(n)] for p in prompts]
    r = _reference(model, seqs, at, keep_at=[len(p) - 1 for p in prompts])
    for i in range(len(prompts)):
        prog = torch.stack([tapped["first_logits"][i]]
                           + [tapped["steps"][s][i] for s in range(1, n)])
        assert _rel(prog, r["logits"][i]) < 1e-5
        assert prog.argmax(-1).tolist() == out["ids"][i].tolist()
        assert _rel(tapped["kda_state"][:, i], r["kda_states"][i]) < 1e-5


def test_chunked_prefill_equals_the_recurrence():
    """``chunk_kda`` over ragged packed rows (chunks of 16 and 64, rows of
    1 .. 130 tokens) against the token-by-token recurrence, outputs and
    final states, under decays of up to e^-2 a token per channel."""
    H, D = 2, 16
    lengths = [1, 17, 64, 130, 33]
    g = torch.Generator().manual_seed(7)
    n = sum(lengths)
    q = kda._l2(torch.randn(n, H, D, generator=g)) * D ** -0.5
    k = kda._l2(torch.randn(n, H, D, generator=g))
    v = torch.randn(n, H, D, generator=g)
    lg = -2 * torch.rand(n, H, D, generator=g)
    beta = torch.rand(n, H, generator=g)
    want_o, want_s, s0 = torch.empty_like(v), [], 0
    for L in lengths:
        S = torch.zeros(H, D, D)
        for t in range(s0, s0 + L):
            S = S * lg[t].exp()[..., None]
            u = beta[t][:, None] * (v[t] - torch.einsum("hk,hkv->hv", k[t],
                                                        S))
            S = S + k[t][..., None] * u[:, None]
            want_o[t] = torch.einsum("hk,hkv->hv", q[t], S)
        want_s.append(S)
        s0 += L
    for chunk in (16, 64):
        o, S = kda.chunk_kda(q, k, v, lg, beta, lengths, chunk)
        torch.testing.assert_close(o, want_o, atol=1e-4, rtol=0)
        torch.testing.assert_close(S, torch.stack(want_s), atol=1e-4, rtol=0)


def test_layer_prefill_and_decode_twin_equal_the_reference_recurrence(
        model):
    """One KDA layer: its prefill over two ragged rows and then the plain
    decode twin, token by token from the states it wrote, against
    ``reference.kda`` over each whole row (outputs, states and conv
    states)."""
    attn = model.layers[1].self_attn
    get = ref.layer_params(model.state_dict())
    g = torch.Generator().manual_seed(9)
    lengths, extra = [70, 5], 4
    xs = [torch.randn(L + extra, TINY.hidden_size, generator=g)
          for L in lengths]
    R, W = len(lengths), attn.W
    state = torch.zeros(R, attn.H, attn.D, attn.D)
    conv = torch.zeros(R, attn.K - 1, 3 * W)
    rows = [(0, lengths[0]), (lengths[0], lengths[1])]
    with torch.inference_mode():
        pre = attn.prefill(torch.cat([x[:L] for x, L in zip(xs, lengths)]),
                           rows, state, conv)
        steps = [attn.decode(torch.stack([x[L + j] for x, L in
                                          zip(xs, lengths)]), state, conv)
                 for j in range(extra)]
    with ref.no_tf32():
        for r, (x, L) in enumerate(zip(xs, lengths)):
            want, S = ref.kda(get, "layers.1.self_attn", KIMI, x,
                              keep_at=L + extra - 1)
            got = torch.cat([pre[rows[r][0]:rows[r][0] + L]]
                            + [s[r:r + 1] for s in steps])
            assert _rel(got, want) < 1e-5
            assert _rel(state[r], S) < 1e-5
            proj = x @ attn.in_proj.weight.T
            torch.testing.assert_close(conv[r], proj[-3:, :3 * W])


def test_decode_twin_updates_in_place_and_checks_refuse_the_rest():
    """The wrapper on CPU tensors runs the twin in place; the kernel's
    operand checks refuse fp32, other head sizes and other conv widths;
    an operand requiring grad raises while autograd records."""
    R, H, D = 2, 2, kda.HEAD_DIM
    W = H * D
    bf = dict(dtype=torch.bfloat16)
    ok = dict(p=torch.randn(R, 3 * W + 2 * D + H, **bf),
              fg=torch.randn(2, R, W, **bf),
              conv_weight=torch.randn(3 * W, 4, **bf),
              A_log=torch.zeros(H), dt_bias=torch.zeros(W),
              g_bias=torch.zeros(W, **bf), o_norm=torch.ones(D, **bf),
              state=torch.randn(R, H, D, D),
              conv_state=torch.randn(R, 3, 3 * W, **bf))
    kda._check(**ok)
    before = ok["state"].clone()
    out = kda.kda_decode(*(ok[k] for k in ("p", "fg", "conv_weight",
                                           "A_log", "dt_bias", "g_bias",
                                           "o_norm")), 1e-5, ok["state"],
                         ok["conv_state"])
    assert out.shape == (R, W) and out.dtype == torch.bfloat16
    assert not torch.equal(before, ok["state"])
    for bad in (dict(state=ok["state"].double()),
                dict(p=ok["p"].float()), dict(o_norm=torch.ones(64, **bf)),
                dict(conv_weight=torch.randn(3 * W, 3, **bf)),
                dict(conv_state=torch.randn(R, 2, 3 * W, **bf))):
        with pytest.raises(ValueError):
            kda._check(**dict(ok, **bad))
    with pytest.raises(RuntimeError, match="no backward"):
        kda.kda_decode(ok["p"].float().requires_grad_(), *(
            ok[k] for k in ("fg", "conv_weight", "A_log", "dt_bias",
                            "g_bias", "o_norm")), 1e-5, ok["state"],
            ok["conv_state"])


def test_nope_mla_prefill_and_decode_equal_the_expanded_reference(model):
    """The MLA layer with ``mla_use_nope``: the prefill equals the
    reference's expanded NoPE attention, its cached k_pe is the projection
    unrotated, and the absorbed decode over the cache equals the
    prefill's last row."""
    attn = model.layers[3].self_attn
    assert not attn.rotate
    T = 21
    x = torch.randn(T, TINY.hidden_size,
                    generator=torch.Generator().manual_seed(5))
    cos_t, sin_t = moe_lm.rope_tables(TINY, torch.device("cpu"))
    with torch.inference_mode():
        full, latent = attn.prefill(x, cos_t[:T], sin_t[:T], [(0, T)])
        with ref.no_tf32():
            want = ref.attention(ref.layer_params(model.state_dict()),
                                 "layers.3.self_attn", KIMI, x)
        k_pe = (x @ attn.kv_a_proj_with_mqa.weight.T)[:, -8:]
        cache = torch.zeros(1, 64, TINY.latent_dim)
        cache[0, :T - 1] = latent[:T - 1]
        pos = torch.tensor([T - 1])
        step = attn.decode(x[T - 1:], cos_t[pos], sin_t[pos], cache, pos,
                           torch.arange(64)[None] <= pos[:, None])
    assert _rel(full, want) < 1e-5
    torch.testing.assert_close(latent[:, -8:], k_pe, atol=1e-6, rtol=0)
    assert _rel(step[0], full[T - 1]) < 1e-5


def test_two_expert_shares_sum_to_the_whole_layer():
    """Shares 0 (experts 0-7) and 1 (8-15) of one MoE layer on the same
    weights, summed with the shared expert counted once, equal the uncut
    reference layer; each share equals the reference given that share."""
    whole = moe_lm.build_synthetic(moe_lm.MoELMConfig.from_dict(
        dict(KIMI, num_experts=16)), "cpu", seed=4)
    sd = whole.state_dict()
    p = "layers.1.mlp"
    x = torch.randn(50, TINY.hidden_size,
                    generator=torch.Generator().manual_seed(2))
    get = ref.layer_params(sd)
    with torch.inference_mode(), ref.no_tf32():
        want, _, _ = ref.moe(get, p, dict(KIMI, num_experts=16,
                                          expert_parallel={}), x)
        shared = whole.layers[1].mlp.shared_experts(x)
        parts = []
        for first in (0, 8):
            cfg = moe_lm.MoELMConfig.from_dict(_share(first))
            m = moe_lm.MoE(cfg)
            m.load_state_dict({
                k[len(p) + 1:]: (v[first:first + 8] if ".experts." in k
                                 else v)
                for k, v in sd.items() if k.startswith(p + ".")})
            got = m(x)
            part_sd = {k: (v[first:first + 8] if k.startswith(p + ".experts.")
                           else v) for k, v in sd.items()
                       if k.startswith(p)}
            mine, _, _ = ref.moe(ref.layer_params(part_sd), p, _share(first),
                                 x)
            assert _rel(got, mine) < 1e-5
            parts.append(got)
    assert _rel(parts[0] + parts[1] - shared, want) < 1e-5


def test_spans_count_the_kda_prefill_state_and_held_experts(model):
    prompts = _prompts([6, 70], seed=7)
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        out, tapped = _generate(model, prompts, 6, taps={1})
        got = [s for s in profiler.spans() if s.id not in seen]
    pre = [s.attrs for s in got if s.name == "topics.kda_prefill"]
    assert pre == [{"layer": i, "rows": 2, "tokens": 76, "chunks": 3,
                    "kernel_launches": 0} for i in (0, 1, 2)]
    dec = next(s for s in got if s.name == "topics.decode")
    assert dec.attrs["experts_held"] == 8
    assert dec.attrs["state_bytes"] == 3 * 2 * 2 * 16 * 16 * 4
    routes = tapped["decode_routes"]           # [steps, n_moe, R, k]
    want = sum(len({e for e in routes[s, layer].flatten().tolist() if e < 8})
               for s in range(routes.shape[0])
               for layer in range(routes.shape[1]))
    assert dec.attrs["experts_touched"] == out["experts_touched"] == want


def test_local_backend_selects_kimi_by_topic_model_alone(tmp_path,
                                                         monkeypatch):
    """``topic_backend: local`` with a ``kimi_linear`` ``topic_model``
    builds the hybrid and answers a batch through ``infer_batch``."""
    from tests.xlsx_writer import write_xlsx

    monkeypatch.setattr(topics_mod.TopicClassifier, "_invoke_model",
                        lambda *a, **k: pytest.fail("Bedrock called"))
    gloss = tmp_path / "g.xlsx"
    write_xlsx(gloss, {"explication": [
        ["Catégorie", "Type de spécialité", "Explication"],
        ["Facturation", "Litige", "Contestations de factures"]]})
    cfg = PipelineConfig.from_dict({
        "output_folder": str(tmp_path), "topic_backend": "local",
        "topics_glossary_b2c": str(gloss), "max_tokens_summary": 4,
        "max_tokens_class": 2, "topic_vocab_seed": 1,
        "topic_model": dict(KIMI, user_token_id=603,
                            assistant_token_id=604)})
    tc = topics_mod.TopicClassifier(cfg, device="cpu")
    lm = tc.local.model
    assert lm.cfg == TINY and [layer.kda for layer in lm.layers] == [
        True, True, True, False]
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        rows = tc.infer_batch(["salam 3la lfactura", "bghit nfsekh"],
                              ["B2C", "B2C"])
        names = [s.name for s in profiler.spans() if s.id not in seen]
    assert len(rows) == 2 and names.count("topics.kda_prefill") == 6


@pytest.mark.parametrize("control", [None, "bf16_state", "skip_decay"])
def test_the_state_check_passes_the_program_and_catches_both_controls(
        control):
    """The cell's ``kda_state_rel_mse`` (``harness/batch_kimi.py``: a bf16
    KDA layer's state after the prefill of a 300-token row against the
    reference's layer on the same input, its projections held in bf16)
    lies below the cell's limit for the program and above it with the KDA
    state held in bf16 between chunks, or with the decay of the row's
    last chunk skipped (2 heads of 128, as the kernel's)."""
    import json
    from pathlib import Path

    from benchmark_torch.harness import batch_kimi

    limit = json.loads((Path(__file__).resolve().parents[1] /
                        "benchmark_torch" / "limits" /
                        "kimi.calls3m-pcm16k.json").read_text()
                       )["kda_state_rel_mse"]
    cfg = dict(KIMI, hidden_size=256, linear_attn_config=dict(
        KIMI["linear_attn_config"], num_heads=2, head_dim=128))
    layer = kda.KimiDeltaAttention(moe_lm.MoELMConfig.from_dict(cfg))
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            kda.stand_in(name, p, g)
    layer = layer.to(torch.bfloat16)
    for name in ("A_log", "dt_bias"):
        getattr(layer, name).data = getattr(layer, name).data.float()
    L = 300
    x = torch.randn(L, 256, generator=g).to(torch.bfloat16)
    get = ref.layer_params({f"l.{k}": v for k, v in
                            layer.state_dict().items()})
    with torch.inference_mode(), ref.no_tf32():
        _, want = ref.kda(get, "l", cfg, x.float(), keep_at=L - 1,
                          held=torch.bfloat16)
    orig = kda.state_pass
    if control:
        kda.state_pass = batch_kimi.state_pass_control(
            bf16_state=control == "bf16_state",
            skip_last=control == "skip_decay")
    try:
        state = torch.zeros(1, 2, 128, 128)
        conv = torch.zeros(1, 3, 3 * 256, dtype=torch.bfloat16)
        with torch.inference_mode():
            layer.prefill(x, [(0, L)], state, conv)
    finally:
        kda.state_pass = orig
    err = batch_kimi._rel_mse([state[0]], [want])
    assert (err > limit) == (control is not None), (control, err, limit)


@pytest.mark.cuda
def test_kernel_matches_the_twin_on_the_card():
    """On the card: the KDA decode kernel against its plain twin at 32
    heads of 128 over 3 and 8 rows, 5 steps from a random state: outputs
    within one bf16 step, states within 1e-5, conv states bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    H, D = 32, kda.HEAD_DIM
    W = H * D
    g = torch.Generator(device=dev).manual_seed(1)
    for R in (3, 8):
        def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
            return (torch.randn(*shape, device=dev, generator=g)
                    * scale).to(dtype)
        w = dict(conv_weight=rnd(3 * W, 4, scale=0.5),
                 A_log=torch.rand(H, device=dev, generator=g) * 2.7,
                 dt_bias=rnd(W, dtype=torch.float32) - 4,
                 g_bias=rnd(W, scale=0.1), o_norm=1 + rnd(D, scale=0.1))
        state = rnd(R, H, D, D, dtype=torch.float32, scale=0.1)
        conv = rnd(R, 3, 3 * W)
        s2, c2 = state.clone(), conv.clone()
        for _ in range(5):
            p, fg = rnd(R, 3 * W + 2 * D + H), rnd(2, R, W, scale=0.3)
            args = (p, fg, w["conv_weight"], w["A_log"], w["dt_bias"],
                    w["g_bias"], w["o_norm"], 1e-5)
            o = kda.kda_decode(*args, state, conv)
            o2 = kda.kda_decode_plain(*args, s2, c2)
            torch.testing.assert_close(o.float(), o2.float(), atol=2e-2,
                                       rtol=1e-2)
            torch.testing.assert_close(state, s2, atol=1e-5, rtol=1e-5)
            assert torch.equal(conv, c2)


def test_dataclass_round_trip_keeps_the_hybrid():
    """``MoELMConfig.from_dict(vars(cfg))`` (what the benchmark hands
    ``LocalLM``) gives the same configuration."""
    assert moe_lm.MoELMConfig.from_dict(dataclasses.asdict(TINY)) == TINY
