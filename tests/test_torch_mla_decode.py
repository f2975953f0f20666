"""The topic LM's MLA decode (models/mla_decode.py): its plain versions,
which the CPU runs, against the absorbed composition the decode ran before
the kernels (``chip_smoke._mla_old_decode``, which times it on the card
beside them) and against the
expanded form with causal attention, the prep's RoPE pairing and latent
norm against ``moe_lm.apply_rope`` and ``RMSNorm``, the ``visible`` mask,
what the wrappers refuse, their launch counters and the decode's rule for
taking the kernels.

The CUDA kernels run only on the card. The tests marked ``cuda`` hold them
against the plain versions there and skip without a card; this file
imports no JAX, so on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mla_decode.py

Tolerances. fp32: the plain decode against the old composition within
2e-6 (the same products, one of them batched over heads in another
layout), the cache bit for bit; against the expanded form 1e-5 relative
(another order of sums). bf16: the plain version keeps scores and
probabilities in fp32 where the old composition rounded both to bf16, so
it must lie nearer the fp32 result. On the card: the prep's q_nope and
q_pe bit for bit, the cached latent within one bf16 step (the RMSNorm's
sum runs in another order); the attention within 1e-2 (the kernel rounds
the unnormalised probabilities to bf16 before P·c, ~2^-9 of each weight,
and its output to bf16).
"""

import dataclasses

import pytest
import torch

from audio_processor_tpu_torch.models import _cuda_call
from audio_processor_tpu_torch.models import mla_decode as md
from audio_processor_tpu_torch.models import moe_lm
from chip_smoke import _mla_old_decode as _old_decode

SMALL = moe_lm.MoELMConfig(
    vocab_size=64, hidden_size=48, intermediate_size=64,
    moe_intermediate_size=16, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=4,
    n_shared_experts=1, num_experts_per_tok=2, max_position_embeddings=256,
    bos_token_id=60, eos_token_id=61)
# Moonlight-16B-A3B's attention widths (the kernels'), in a narrow model
WIDE = dataclasses.replace(
    SMALL, hidden_size=256, num_attention_heads=16, num_key_value_heads=16,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, max_position_embeddings=8192)


def _attn(cfg, seed, dtype=torch.float32):
    """A LatentAttention with drawn weights and latent-norm gain; q and
    W_kvb wide enough that the scores are peaked."""
    a = moe_lm.LatentAttention(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in a.named_parameters():
            if "layernorm" in name:
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=g))
            else:
                std = 3.0 / p.shape[1] ** 0.5 if "q_proj" in name \
                    or "kv_b" in name else p.shape[1] ** -0.5
                p.normal_(0.0, std, generator=g)
    return a.to(dtype).eval()


def _step(cfg, R, cap, seed, dtype=torch.float32, device="cpu"):
    """x [R, hidden], cos/sin at each row's position, a cache whose rows
    are strided (a [R, 2 * cap] buffer's first ``cap`` positions, as the
    decode state's), ragged positions (the first and last included from
    3 rows on) and the causal ``visible``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(R, cfg.hidden_size, generator=g)
    buf = torch.randn(R, 2 * cap, cfg.latent_dim, generator=g)
    pos = torch.randint(0, cap, (R,), generator=g)
    if R >= 3:
        pos[:2] = torch.tensor([0, cap - 1])
    dev = torch.device(device)
    cos_t, sin_t = moe_lm.rope_tables(cfg, dev)
    pos = pos.to(dev)
    visible = torch.arange(cap, device=dev)[None] <= pos[:, None]
    cache = buf.to(device=dev, dtype=dtype)[:, :cap]
    return (x.to(device=dev, dtype=dtype), cos_t[pos], sin_t[pos], cache,
            pos, visible)


def test_prep_rotates_as_apply_rope_and_normalises_as_rmsnorm():
    """q_nope head-major as q_proj gives it; q_pe and k_pe rotated as
    ``apply_rope`` rotates them and c normalised as the module's RMSNorm
    does, bit for bit, fp32 and bf16; the cache written at each row's
    position and nowhere else."""
    for dtype in (torch.float32, torch.bfloat16):
        attn = _attn(SMALL, 1, dtype)
        x, cos, sin, cache, pos, _ = _step(SMALL, 5, 40, 2, dtype)
        before = cache.clone()
        q = attn.q_proj(x)
        kv = attn.kv_a_proj_with_mqa(x)
        norm = attn.kv_a_layernorm
        with torch.no_grad():
            q_nope, q_pe = md.mla_decode_prep(q, kv, cos, sin, norm.weight,
                                              norm.eps, cache, pos, attn.nh)
            nope, rope = SMALL.qk_nope_head_dim, SMALL.qk_rope_head_dim
            qh = q.view(5, attn.nh, -1)
            assert torch.equal(q_nope, qh[..., :nope].transpose(0, 1))
            assert torch.equal(q_pe, moe_lm.apply_rope(
                qh[..., nope:], cos[:, None], sin[:, None]))
            c, k_pe = kv.split([SMALL.kv_lora_rank, rope], dim=-1)
            want = torch.cat([norm(c), moe_lm.apply_rope(k_pe, cos, sin)],
                             dim=-1)
        rows = torch.arange(5)
        assert torch.equal(cache[rows, pos], want)
        keep = torch.ones_like(cache[..., 0], dtype=torch.bool)
        keep[rows, pos] = False
        assert torch.equal(cache[keep], before[keep])


@pytest.mark.parametrize("R", [1, 3, 8])
def test_plain_decode_is_the_old_composition_in_fp32(R):
    """The decode through the plain versions against the old absorbed
    composition at several capacities and ragged positions: outputs within
    2e-6, caches bit for bit, and the attention's o_lat bit for bit when
    both are handed the same query."""
    attn = _attn(SMALL, 3)
    for cap in (32, 96, 160):
        x, cos, sin, cache, pos, visible = _step(SMALL, R, cap, cap + R)
        old_cache = cache.clone()
        with torch.no_grad():
            got = attn.decode(x, cos, sin, cache, pos, visible)
            want = _old_decode(attn, x, cos, sin, old_cache, pos, visible)
            torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
            assert torch.equal(cache, old_cache)
            q_lat = torch.randn(attn.nh, R, SMALL.kv_lora_rank)
            q_pe = torch.randn(R, attn.nh, SMALL.qk_rope_head_dim)
            s = torch.bmm(torch.cat([q_lat.transpose(0, 1), q_pe], -1),
                          cache.transpose(1, 2)) * attn.scale
            p = s.masked_fill(~visible[:, None], float("-inf")).softmax(-1)
            o_old = torch.bmm(p, cache[..., :SMALL.kv_lora_rank])
            assert torch.equal(
                md.mla_decode_attention(q_lat, q_pe, cache, visible,
                                        attn.scale),
                o_old.transpose(0, 1))


def test_decode_equals_expanded_causal_attention():
    """Each of R ragged rows (R = 1, 3, 8) decoding its last token over
    its cached prompt gives the expanded form's causal attention output
    at that token (``LatentAttention.prefill``, k and v from the latent,
    one SDPA per row), and caches the prefill's latent there."""
    attn = _attn(SMALL, 4)
    cos_t, sin_t = moe_lm.rope_tables(SMALL, torch.device("cpu"))
    g = torch.Generator().manual_seed(5)
    for R in (1, 3, 8):
        lengths = torch.randint(1, 60, (R,), generator=g).tolist()
        lengths[0] = 60 if R > 1 else lengths[0]
        cap = 64
        cache = torch.zeros(R, cap, SMALL.latent_dim)
        xs, want = [], []
        with torch.no_grad():
            for r, T in enumerate(lengths):
                x = torch.randn(T, SMALL.hidden_size, generator=g)
                out, latent = attn.prefill(x, cos_t[:T], sin_t[:T], [(0, T)])
                cache[r, :T - 1] = latent[:T - 1]
                xs.append(x[T - 1])
                want.append((out[T - 1], latent[T - 1]))
            pos = torch.tensor(lengths) - 1
            visible = torch.arange(cap)[None] <= pos[:, None]
            got = attn.decode(torch.stack(xs), cos_t[pos], sin_t[pos], cache,
                              pos, visible)
        for r in range(R):
            rel = (got[r] - want[r][0]).norm() / want[r][0].norm()
            assert rel < 1e-5, (R, r, float(rel))
            torch.testing.assert_close(cache[r, pos[r]], want[r][1],
                                       atol=1e-6, rtol=1e-6)


def test_bf16_plain_lies_nearer_fp32_than_the_old_bf16_composition():
    """bf16 weights and inputs: the plain versions (fp32 scores and
    probabilities) against the fp32 decode of the same values, nearer than
    the old composition (scores and probabilities rounded to bf16)."""
    attn = _attn(SMALL, 6, torch.bfloat16)
    exact = _attn(SMALL, 6, torch.bfloat16).float()
    err_new = err_old = 0.0
    for R, cap in ((3, 96), (8, 160)):
        x, cos, sin, cache, pos, visible = _step(SMALL, R, cap, 7 * R,
                                                 torch.bfloat16)
        caches = [cache.clone(), cache.clone(), cache.float()]
        with torch.no_grad():
            new = attn.decode(x, cos, sin, caches[0], pos, visible)
            old = _old_decode(attn, x, cos, sin, caches[1], pos, visible)
            ref = exact.decode(x.float(), cos, sin, caches[2], pos, visible)
        assert new.dtype == torch.bfloat16
        err_new += float((new.float() - ref).norm() / ref.norm())
        err_old += float((old.float() - ref).norm() / ref.norm())
    assert err_new < err_old and err_new < 2e-2, (err_new, err_old)


def test_the_attention_honours_visible_as_given():
    """A mask one position short of each row's position changes o_lat;
    what the cache holds at positions the mask leaves out does not."""
    attn = _attn(SMALL, 8)
    x, cos, sin, cache, pos, visible = _step(SMALL, 6, 96, 9)
    q_lat = torch.randn(attn.nh, 6, SMALL.kv_lora_rank)
    q_pe = torch.randn(6, attn.nh, SMALL.qk_rope_head_dim)
    o = md.mla_decode_attention(q_lat, q_pe, cache, visible, attn.scale)
    short = visible & (torch.arange(96)[None] < pos[:, None])
    o_short = md.mla_decode_attention(q_lat, q_pe, cache, short, attn.scale)
    moved = (o_short - o).abs().amax(dim=(0, 2))
    assert bool((moved[pos > 0] > 1e-3).all()), moved
    assert bool(o_short[:, pos == 0].isnan().all())     # nothing visible
    hidden = cache.clone()
    hidden[~visible] = 1e4
    torch.testing.assert_close(
        md.mla_decode_attention(q_lat, q_pe, hidden, visible, attn.scale), o,
        atol=0, rtol=0)


def _kernel_operands(R=2, cap=128, H=16):
    """Operands at the kernels' widths, on the CPU."""
    bf = dict(dtype=torch.bfloat16)
    return dict(
        q=torch.zeros(R, H * (md.NOPE + md.ROPE), **bf),
        kv=torch.zeros(R, md.LORA + md.ROPE, **bf),
        cos=torch.zeros(R, md.ROPE), sin=torch.zeros(R, md.ROPE),
        gain=torch.ones(md.LORA, **bf),
        cache=torch.zeros(R, 2 * cap, md.LORA + md.ROPE, **bf)[:, :cap],
        pos=torch.zeros(R, dtype=torch.long),
        q_lat=torch.zeros(H, R, md.LORA, **bf),
        q_pe=torch.zeros(R, H, md.ROPE, **bf),
        visible=torch.ones(R, cap, dtype=torch.bool))


def test_operand_checks_refuse_what_the_kernels_do_not_take():
    """Wrong dtypes, shapes, capacities, layouts and devices raise
    ValueError before any launch; an operand that requires grad raises
    while autograd records, on every device."""
    ok = _kernel_operands()
    prep = ("q", "kv", "cos", "sin", "gain", "cache", "pos")
    attn = ("q_lat", "q_pe", "cache", "visible")
    md._check_prep(*(ok[k] for k in prep), 16)
    md._check_attention(*(ok[k] for k in attn))
    bad_cache = ok["cache"].clone()
    bad = [
        dict(q=ok["q"].float()), dict(q=ok["q"][:, :-192]),
        dict(kv=ok["kv"][:, :-8]), dict(gain=ok["gain"][:-1]),
        dict(cos=ok["cos"].double()), dict(pos=ok["pos"].int()),
        dict(cache=bad_cache[:, :100]),                  # not x 64
        dict(cache=torch.zeros(2, 8256, 576, dtype=torch.bfloat16)),
        dict(cache=bad_cache.transpose(0, 1).contiguous().transpose(0, 1)),
        dict(q_lat=ok["q_lat"][:, :, :256]),
        dict(q_lat=torch.zeros(17, 2, md.LORA, dtype=torch.bfloat16)),
        dict(q_pe=ok["q_pe"][:1]), dict(q_pe=ok["q_pe"].float()),
        dict(visible=ok["visible"].to(torch.uint8)),
        dict(visible=ok["visible"][:, :64]),
    ]
    for case in bad:
        args = dict(ok, **case)
        with pytest.raises(ValueError):
            if set(case) & set(prep):
                md._check_prep(*(args[k] for k in prep), 16)
            if set(case) & set(attn):
                md._check_attention(*(args[k] for k in attn))
    with pytest.raises(ValueError, match="heads"):
        md._check_prep(*(ok[k] for k in prep), 17)
    with pytest.raises(ValueError, match="not on meta"):
        md._check_cache(ok["cache"], 2, torch.device("meta"))
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        md.mla_decode_attention(*(ok[k].to("meta") for k in attn), 0.1)
    with pytest.raises(RuntimeError, match="no backward"):
        md.mla_decode_attention(ok["q_lat"].float().requires_grad_(),
                                *(ok[k] for k in attn[1:]), 0.1)


def test_launch_counters_and_the_rule_for_the_kernels(monkeypatch):
    """With the launch replaced by a spy, each wrapper on a (pretend) card
    makes one call of its entry with one argument per letter of its
    signature and counts one launch, or, inside a capture's tally, tallies
    it there. On the card the decode always takes the kernels: a model at
    their widths in bf16 launches both, one in fp32, at other widths or
    with autograd recording its weights raises, and none falls back."""
    calls = []
    monkeypatch.setattr(md, "_on", lambda device, name: False)
    monkeypatch.setattr(
        _cuda_call, "call",
        lambda name, sig, dev, *args, entry="", label="": calls.append(
            (name, entry, len(sig) == len(args))))
    ok = _kernel_operands()
    before = (md.mla_decode_prep.launches, md.mla_decode_attention.launches)
    md.mla_decode_prep(*(ok[k] for k in ("q", "kv", "cos", "sin", "gain")),
                       1e-5, ok["cache"], ok["pos"], 16)
    md.mla_decode_attention(ok["q_lat"], ok["q_pe"], ok["cache"],
                            ok["visible"], 0.1)
    assert calls == [("mla_decode", "mla_decode_prep", True),
                     ("mla_decode", "mla_decode_attention", True)]
    assert (md.mla_decode_prep.launches - before[0],
            md.mla_decode_attention.launches - before[1]) == (1, 1)
    with _cuda_call.tally_launches() as tally:
        md.mla_decode_attention(ok["q_lat"], ok["q_pe"], ok["cache"],
                                ok["visible"], 0.1)
    assert tally == {md.mla_decode_attention: 1}
    assert md.mla_decode_attention.launches - before[1] == 1

    calls.clear()
    wide, small = _attn(WIDE, 1, torch.bfloat16), _attn(SMALL, 1,
                                                        torch.bfloat16)
    step = _step(WIDE, 2, 128, 3, torch.bfloat16)
    with torch.no_grad():
        wide.decode(*step)
        assert [c[1] for c in calls] == ["mla_decode_prep",
                                         "mla_decode_attention"]
        with pytest.raises(ValueError, match="bfloat16"):
            wide.float().decode(step[0].float(), *step[1:3],
                                step[3].float(), *step[4:])
        with pytest.raises(ValueError, match="heads"):
            small.decode(*_step(SMALL, 2, 128, 3, torch.bfloat16))
    with pytest.raises(RuntimeError, match="no backward"):
        _attn(WIDE, 1, torch.bfloat16).decode(*step)
    assert len(calls) == 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card(card):
    """At the kernels' widths, R = 1, 3, 8, capacities 64, 1,536 and 4,096
    in an 8,192-position buffer, ragged positions: the prep's q_nope and
    q_pe bit for bit and the cached latent within a bf16 step; the
    attention within 1e-2 under the causal mask, a mask with holes, a mask
    one position short, and NaN for a row with nothing visible."""
    attn = _attn(WIDE, 2, torch.bfloat16).to(card)
    norm = attn.kv_a_layernorm
    for R in (1, 3, 8):
        for cap in (64, 1536, 4096):
            x, cos, sin, _, pos, visible = _step(WIDE, R, cap, R * cap,
                                                 torch.bfloat16, "cuda")
            buf = torch.randn(R, 8192, WIDE.latent_dim, device=card,
                              dtype=torch.bfloat16)
            cache, plain_cache = buf[:, :cap], buf.clone()[:, :cap]
            with torch.no_grad():
                q, kv = attn.q_proj(x), attn.kv_a_proj_with_mqa(x)
                args = (q, kv, cos, sin, norm.weight, norm.eps)
                got = md.mla_decode_prep(*args, cache, pos, attn.nh)
                want = md.mla_decode_prep_plain(*args, plain_cache, pos,
                                                attn.nh)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            rows = torch.arange(R, device=card)
            a, b = cache[rows, pos].float(), plain_cache[rows, pos].float()
            assert bool(((a - b).abs() <= b.abs() * 2 ** -7 + 1e-6).all())
            cache.copy_(plain_cache)
            q_lat = torch.randn(attn.nh, R, md.LORA, device=card) \
                .to(torch.bfloat16)
            holes = visible & (torch.rand(R, cap, device=card) > 0.3)
            holes[:, 0] = True
            short = visible & (torch.arange(cap, device=card)[None]
                               < pos[:, None])
            for mask in (visible, holes, short):
                o = md.mla_decode_attention(q_lat, got[1], cache, mask,
                                            attn.scale)
                p = md.mla_decode_attention_plain(q_lat, got[1], cache, mask,
                                                  attn.scale)
                empty = ~mask.any(dim=1)
                assert bool(o[:, empty].float().isnan().all())
                torch.testing.assert_close(o[:, ~empty].float(),
                                           p[:, ~empty].float(), atol=1e-2,
                                           rtol=1e-2)


@pytest.mark.cuda
def test_decode_graph_spans_count_one_attention_launch_per_layer(card,
                                                                 monkeypatch):
    """A narrow model at Moonlight's attention widths on the card: every
    ``topics.graph`` span's ``mla_launches`` is layers x its steps, as the
    wrapper's count grows; the replayed steps equal the eager kernel
    steps bit for bit and the plain versions' within bf16 rounding."""
    from audio_processor_tpu_torch.obs import profiler

    m = moe_lm.build_synthetic(WIDE, card, seed=4, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 60, (n,), generator=g).tolist()
               for n in (70, 530, 9)]
    m.tap = lambda kind, rows, steps: {2, 7}

    def run():
        with torch.inference_mode():
            out = m.generate(prompts, 9)
        return out["ids"], m.tapped["summary"]["steps"]

    before = md.mla_decode_attention.launches
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        graphed = [run() for _ in range(2)]         # capture, then replay
        spans = [s for s in profiler.spans() if s.id not in seen
                 and s.name == "topics.graph"]
    assert [s.attrs["mode"] for s in spans] == ["capture", "replay"]
    layers = WIDE.num_hidden_layers
    assert all(s.attrs["mla_launches"] == layers * s.attrs["steps"]
               for s in spans)
    assert md.mla_decode_attention.launches - before == layers * 16
    m.requires_grad_(False)
    with torch.enable_grad():                       # the eager loop
        eager = run()
    for ids, steps in graphed:
        assert torch.equal(ids, eager[0])
        assert all(torch.equal(steps[s], eager[1][s]) for s in (2, 7))
    monkeypatch.setattr(md, "mla_decode_prep", md.mla_decode_prep_plain)
    monkeypatch.setattr(md, "mla_decode_attention",
                        md.mla_decode_attention_plain)
    with torch.enable_grad():                       # eager, plain versions
        plain = run()
    for s in (2, 7):
        a, b = eager[1][s].float(), plain[1][s].float()
        assert float((a - b).norm() / b.norm()) < 2e-2
