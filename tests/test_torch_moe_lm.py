"""The topic LM (``models/moe_lm.py``, the DeepSeek-V3 block at tiny
widths) against the plain fp32 reference ``benchmark_torch/reference/
moonlight.py`` on seeded weights, its piece table's encoder, and the local
topic backend through ``SentimentAnalyzer`` into SQLite. CPU; the one
card-only test (the decode step's graph replay against eager steps) is
marked ``cuda`` and skips here."""

import dataclasses

import pytest
import torch

from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.host import topics as topics_mod
from audio_processor_tpu_torch.models import moe_lm
from audio_processor_tpu_torch.models.pieces import PieceVocab
from audio_processor_tpu_torch.obs import profiler
from benchmark_torch.reference import moonlight as ref

TINY = moe_lm.MoELMConfig(
    vocab_size=640, hidden_size=64, intermediate_size=128,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
    n_shared_experts=2, num_experts_per_tok=3, max_position_embeddings=96,
    bos_token_id=600, eos_token_id=601)
SPECIAL = {600: "[BOS]", 601: "[EOS]", 603: "<|im_user|>",
           604: "<|im_assistant|>"}


@pytest.fixture(scope="module")
def model():
    return moe_lm.build_synthetic(TINY, "cpu", seed=3)


def _prompts(lengths, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 600, (n,), generator=g).tolist()
            for n in lengths]


def _reference(model, seqs, at, **kw):
    return ref.forward(ref.layer_params(model.state_dict()),
                       dataclasses.asdict(model.cfg), seqs, at, **kw)


def _generate(model, prompts, max_new, taps=()):
    model.tap = (lambda kind, rows, steps: taps) if taps else None
    try:
        with torch.inference_mode():
            out = model.generate(prompts, max_new, "summary")
        return out, model.tapped.get("summary") if taps else None
    finally:
        model.tap = None
        model.tapped = {}


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_prefill_logits_match_reference(model):
    """The ragged prefill's logits at each prompt's last position, and the
    full forward's at every position, against the reference."""
    prompts = _prompts([5, 23, 11])
    out, tapped = _generate(model, prompts, 2, taps={1})
    r = _reference(model, prompts, [[len(p) - 1] for p in prompts])
    for i in range(3):
        assert _rel(tapped["first_logits"][i], r["logits"][i][0]) < 1e-5
        assert int(out["ids"][i, 0]) == int(r["logits"][i][0].argmax())


def test_prefill_then_decode_through_the_cache_matches_full_forward(model):
    """Greedy tokens fed back through the latent cache give, at every
    decode step, the logits of a full causal forward over prompt +
    emitted tokens, and each step's token is their argmax."""
    prompts = _prompts([9, 17], seed=1)
    n = 7
    out, tapped = _generate(model, prompts, n, taps=set(range(1, n)))
    seqs = [p + out["ids"][r, :n - 1].tolist()
            for r, p in enumerate(prompts)]
    at = [[len(p) - 1 + j for j in range(n)] for p in prompts]
    r = _reference(model, seqs, at)
    for i in range(2):
        prog = torch.stack([tapped["first_logits"][i]]
                           + [tapped["steps"][s][i] for s in range(1, n)])
        assert _rel(prog, r["logits"][i]) < 1e-5
        assert prog.argmax(-1).tolist() == out["ids"][i].tolist()


def test_absorbed_decode_equals_expanded_attention(model):
    """One row's decode at position t (q̃ = q_nope·W_kvb,k over the latent
    cache, o = W_kvb,v·P·c) equals the expanded attention's row t."""
    attn = model.layers[1].self_attn
    T = 13
    x = torch.randn(T, TINY.hidden_size, generator=torch.Generator()
                    .manual_seed(5))
    cos_t, sin_t = moe_lm.rope_tables(TINY, torch.device("cpu"))
    with torch.inference_mode():
        full, latent = attn.prefill(x, cos_t[:T], sin_t[:T], [(0, T)])
        cache = torch.zeros(1, 32, TINY.latent_dim)
        cache[0, :T - 1] = latent[:T - 1]
        pos = torch.tensor([T - 1])
        visible = torch.arange(32)[None] <= pos[:, None]
        step = attn.decode(x[T - 1:], cos_t[pos], sin_t[pos], cache, pos,
                           visible)
    assert torch.allclose(cache[0, T - 1], latent[T - 1], atol=1e-6)
    assert _rel(step[0], full[T - 1]) < 1e-5


def test_moe_layer_matches_reference(model):
    """Sigmoid scores, the top k on score + bias (nonzero), weights from
    the unbiased scores renormalised and scaled, the shared experts: the
    grouped-GEMM layer against the reference's expert loop."""
    moe = model.layers[2].mlp
    assert moe.gate.e_score_correction_bias.abs().min() > 0
    x = torch.randn(40, TINY.hidden_size,
                    generator=torch.Generator().manual_seed(6))
    get = ref.layer_params(model.state_dict())
    with torch.inference_mode():
        idx, w = moe.route(x)
        y = moe(x)
        y_ref, _, _ = ref.moe(get, "layers.2.mlp", dataclasses.asdict(TINY),
                              x)
        s = torch.sigmoid(x @ moe.gate.weight.T)
    assert _rel(y, y_ref) < 1e-5
    unbiased = torch.topk(s, TINY.num_experts_per_tok).indices
    assert (unbiased.sort(-1).values != idx.sort(-1).values).any()
    want = s.gather(1, idx)
    want = want / want.sum(-1, keepdim=True) * TINY.routed_scaling_factor
    assert torch.allclose(w, want, atol=1e-6)


def test_ragged_rows_equal_each_row_alone(model):
    """A batch of ragged prompts gives each row the tokens and logits it
    gets alone."""
    prompts = _prompts([4, 19, 9], seed=2)
    out, tapped = _generate(model, prompts, 5, taps={2, 4})
    for i, p in enumerate(prompts):
        one, t1 = _generate(model, [p], 5, taps={2, 4})
        assert one["ids"][0].tolist() == out["ids"][i].tolist()
        for s in (2, 4):
            assert _rel(tapped["steps"][s][i], t1["steps"][s][0]) < 1e-5


def test_bf16_program_is_near_the_reference_and_a_cache_fault_is_not(model):
    """The bf16 model against the fp32 reference: logits within bf16
    rounding; the same model with each row's cache read one position off
    is far outside it (the seeded attention is peaked enough to show
    it)."""
    bf = moe_lm.build_synthetic(TINY, "cpu", seed=3, dtype=torch.bfloat16)
    prompts = _prompts([30, 21], seed=4)
    n = 6

    def err(m):
        out, tapped = _generate(m, prompts, n, taps=set(range(1, n)))
        seqs = [p + out["ids"][r, :n - 1].tolist()
                for r, p in enumerate(prompts)]
        r = _reference(m, seqs, [[len(p) - 1 + j for j in range(n)]
                                 for p in prompts])
        return max(_rel(torch.stack([tapped["first_logits"][i]] + [
            tapped["steps"][s][i] for s in range(1, n)]), r["logits"][i])
            for i in range(2))

    sound = err(bf)
    orig = moe_lm.LatentAttention.decode

    def off_by_one(self, x, cos, sin, cache, pos, visible):
        return orig(self, x, cos, sin, cache, pos,
                    visible & (torch.arange(visible.shape[1])[None]
                               < pos[:, None]))

    moe_lm.LatentAttention.decode = off_by_one
    try:
        faulty = err(bf)
    finally:
        moe_lm.LatentAttention.decode = orig
    assert sound < 2e-2
    assert faulty > 5 * sound


def test_decode_spans_and_experts_touched(model):
    """``topics.prefill`` and ``topics.decode`` carry their attributes;
    ``experts_touched`` is the distinct experts per MoE layer and step,
    summed, as the recorded choices give it."""
    prompts = _prompts([6, 10], seed=7)
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        out, tapped = _generate(model, prompts, 6, taps={1})
        got = [s for s in profiler.spans() if s.id not in seen]
    pre = [s for s in got if s.name == "topics.prefill"]
    dec = [s for s in got if s.name == "topics.decode"]
    assert len(pre) == len(dec) == 1
    assert pre[0].attrs == {"kind": "summary", "rows": 2, "tokens": 16,
                            "padded": 16, "lengths": [6, 10]}
    routes = tapped["decode_routes"]               # [steps, n_moe, R, k]
    want = sum(len(set(routes[s, layer].flatten().tolist()))
               for s in range(routes.shape[0])
               for layer in range(routes.shape[1]))
    assert dec[0].attrs["experts_touched"] == out["experts_touched"] == want
    assert dec[0].attrs["steps"] == 5 and dec[0].attrs["tokens"] == 12


def test_refuses_a_prompt_beyond_its_positions(model):
    with pytest.raises(ValueError, match="positions"):
        model.generate(_prompts([90]), 8)


def test_published_widths_have_moonlights_parameter_count():
    """15.96 B parameters at Moonlight-16B-A3B's published widths (counted
    on the meta device)."""
    with torch.device("meta"):
        n = sum(p.numel() for p in moe_lm.MoELM(moe_lm.MoELMConfig())
                .parameters())
    assert abs(n - 15.96e9) < 0.01e9, n


def test_encode_decode_round_trip_on_the_seeded_table():
    vocab = PieceVocab.synthetic_bytes(640, 11, SPECIAL)
    texts = ["salam alikoum ana kan3ayet 3la lfactura",
             "Résumé : le client — 120 mots • ✓ ليس\nNuméro :", "", "  a  b "]
    for t in texts:
        ids = vocab.encode(t)
        assert all(0 <= i < 600 for i in ids)
        assert vocab.decode(ids) == t.strip()
    assert vocab.decode([600, 601] + vocab.encode("ok") + [604]) == "ok"


def _glossary(tmp_path):
    from tests.xlsx_writer import write_xlsx

    p = tmp_path / "glossaire.xlsx"
    write_xlsx(p, {"explication": [
        ["Catégorie", "Type de spécialité", "Explication"],
        ["Facturation", "Litige", "Contestations de factures"],
        ["Recharge", "Recharge mobile", "Demandes de recharge"]]})
    return str(p)


def _local_analyzer(tmp_path, monkeypatch):
    """A SentimentAnalyzer over SQLite with the local topic backend on the
    tiny model, three calls of two chunks each inserted -> (analyzer,
    database, chunks); Bedrock fails the test if asked."""
    from audio_processor_tpu_torch.host.db import DatabaseManager
    from audio_processor_tpu_torch.pipeline.sentiment import (
        SentimentAnalyzer,
    )

    monkeypatch.setattr(topics_mod.TopicClassifier, "_invoke_model",
                        lambda *a, **k: pytest.fail("Bedrock called"))
    gloss = _glossary(tmp_path)
    cfg = PipelineConfig.from_dict({
        "database_type": "sqlite", "db_path": str(tmp_path / "calls.db"),
        "output_folder": str(tmp_path), "topic_backend": "local",
        "topics_glossary_b2c": gloss, "topics_glossary_b2b": gloss,
        "max_tokens_summary": 6, "max_tokens_class": 3,
        "topic_model": dict(dataclasses.asdict(TINY),
                            max_position_embeddings=4096,
                            user_token_id=603, assistant_token_id=604),
        "topic_vocab_seed": 1})
    tc = topics_mod.TopicClassifier(cfg, device="cpu")
    assert tc.enabled and tc.batched
    db = DatabaseManager(cfg)
    sa = SentimentAnalyzer(cfg, db_manager=db, topic_classifier=tc,
                           device="cpu")
    chunks = [{"file_name": f"call{c}.wav", "chunk_idx": k,
               "transcription_chunk": f"salam {c} chunk {k} ",
               "agent_transcription": "", "client_transcription": ""}
              for c in range(3) for k in range(2)]
    for c in range(3):
        db.insert_call({"id_enregistrement": f"call{c}", "topics": "",
                        "duration_seconds": 10.0,
                        "emotion_client_globale": "",
                        "ton_agent_global": ""})
    return sa, db, chunks


def test_local_backend_writes_topics_through_sentiment_into_sqlite(
        tmp_path, monkeypatch):
    """``topic_backend: local``: one batched pass (span ``topics.batch``,
    one summary and one class prefill) over the batch's calls, before and
    outside ``engine.persist``, and every call's ``topics`` in SQLite;
    Bedrock is never asked."""
    sa, db, chunks = _local_analyzer(tmp_path, monkeypatch)
    monkeypatch.setattr(topics_mod, "_category",
                        lambda topics, idx: ("Recharge", idx or "vide"))
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        sa.analyze_batch_sentiment(chunks)
        got = [s for s in profiler.spans() if s.id not in seen]
    names = [s.name for s in got]
    assert names.count("topics.batch") == 1
    assert names.count("topics.prefill") == 2
    batch = next(s for s in got if s.name == "topics.batch")
    assert batch.attrs["calls"] == 3
    for s in got:
        if s.name == "engine.persist":
            assert s.t0 >= batch.t1
    rows = db._execute("SELECT id_enregistrement, topics FROM call", (),
                       fetch="all")
    assert len(rows) == 3
    assert all(r["topics"].startswith("Recharge - ") for r in rows)
    db.close()


def test_a_failing_local_lm_leaves_topics_empty(tmp_path, monkeypatch):
    """When the local LM raises (here in the class pass, after the
    summaries), ``infer_batch`` raises too, and every call of the batch is
    persisted with empty ``topics``: no stand-in answer such as
    ``FAILED`` is written where nothing was computed."""
    sa, db, chunks = _local_analyzer(tmp_path, monkeypatch)
    lm = sa.topic_classifier.local
    generate = lm.generate

    def failing(prompts, max_new, kind):
        if kind == "class":
            raise RuntimeError("CUDA out of memory")
        return generate(prompts, max_new, kind)

    monkeypatch.setattr(lm, "generate", failing)
    db._execute("UPDATE call SET topics = ?", ("before",))
    with pytest.raises(RuntimeError, match="out of memory"):
        sa.topic_classifier.infer_batch(["salam"], ["B2C"])
    sa.analyze_batch_sentiment(chunks)
    rows = db._execute("SELECT id_enregistrement, topics FROM call", (),
                       fetch="all")
    assert len(rows) == 3 and all(r["topics"] == "" for r in rows), rows
    db.close()


@pytest.mark.cuda
def test_step_graph_replay_equals_eager():
    """On the card: the decode loop replaying its step graph gives the
    eager steps' tokens and logits bit for bit, one capture per key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    m = moe_lm.build_synthetic(TINY, dev, seed=3, dtype=torch.bfloat16)
    prompts = _prompts([7, 20, 13], seed=8)
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        graphed = [_generate(m, prompts, 9, taps={3, 8}) for _ in range(2)]
        modes = [s.attrs["mode"] for s in profiler.spans()
                 if s.id not in seen and s.name == "topics.graph"]
    assert modes == ["capture", "replay"]
    with torch.enable_grad():       # autograd on: the eager loop
        eager = _generate(m, prompts, 9, taps={3, 8})
    for out, tapped in graphed:
        assert torch.equal(out["ids"], eager[0]["ids"])
        for s in (3, 8):
            assert torch.equal(tapped["steps"][s], eager[1]["steps"][s])
