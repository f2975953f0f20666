"""SeamlessM4T v2 speech-to-text in the port (models/seamless_s2t.py) on
the CPU at a tiny size (2 + 2 layers, hidden 64, vocabulary 512, seeded
weights): against the benchmark's plain reference
(benchmark_torch/reference/seamless_s2t.py), the reference against
transformers' ``SeamlessM4Tv2ForSpeechToText`` on the same weights, the
``</s>``/cap rule, the loop's states dropped with new weight storage, the
batch pipeline writing detokenized rows, the CTC
model unchanged by the encoder's split into body and head, int8 reaching
the adaptor and decoder, and the configurations it refuses."""

import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch import cli
from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.models import cuda_graphs
from audio_processor_tpu_torch.models import seamless_s2t as s2t
from audio_processor_tpu_torch.models import wav2vec2bert as w2v
from audio_processor_tpu_torch.models.pieces import PieceVocab
from audio_processor_tpu_torch.models.quant import QuantLinear
from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark_torch.reference import seamless_s2t as ref  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, conv_depthwise_kernel_size=7,
            decoder_layers=2, decoder_attention_heads=4, decoder_ffn_dim=128,
            vocab_size=512)
RULE = s2t.DecodeRule(max_new_tokens=40, a=0.6, b=8)
LANG = 511
# fp32 on both sides: the port and the reference differ only in the order
# of their sums (the adaptor's convolution as one product, the relative
# bias gathered, the cache against a full causal forward), ~1e-7
# relative; 1e-5 leaves two orders of room and still fails any wrong
# term (a position off by one reads ~1e-1).
FP32_REL = 1e-5


def _model(seed=0, rule=RULE):
    """Tiny seeded model with every tensor random, LayerNorms included
    (weights near 1), so a swapped or skipped term shows."""
    m = s2t.build_synthetic(s2t.S2TConfig(**TINY), CPU, seed=seed,
                            rule=rule)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if "layer_norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.05 * noise)
    return m.eval()


def _weights(model):
    return {k: v.detach().float() for k, v in model.state_dict().items()}


def _m(rule=RULE):
    return dict(TINY, feature_projection_input_dim=160,
                left_max_position_embeddings=64,
                right_max_position_embeddings=8, layer_norm_eps=1e-5,
                adaptor_kernel_size=8, adaptor_stride=8,
                num_adapter_layers=1, pad_token_id=0,
                max_new_tokens=rule.max_new_tokens)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _batch(seed=3, lens=(64, 50, 21)):
    gen = torch.Generator().manual_seed(seed)
    L = max(lens)
    feats = torch.randn(len(lens), L, 160, generator=gen)
    mask = torch.arange(L)[None] < torch.tensor(lens)[:, None]
    return feats * mask[..., None], mask, lens


def test_adaptor_output_matches_reference():
    """A padded batch through the port against each row alone."""
    model = _model()
    feats, mask, lens = _batch()
    with torch.inference_mode():
        out = model.speech_encoder(feats, mask)
        omask = model.speech_encoder.output_mask(mask)
    w = _weights(model)
    for r, n in enumerate(lens):
        want = ref.speech_encoder(w, _m(), feats[r:r + 1, :n])[0]
        assert int(omask[r].sum()) == want.shape[0] == \
            ref.adaptor_frames(n)
        assert _rel(out[r, :want.shape[0]], want) < FP32_REL


def test_decoder_logits_through_the_cache_match_a_full_forward():
    """Every step's logits of the cached loop against the
    reference's causal forward over the tokens the loop emitted."""
    model = _model()
    feats, mask, lens = _batch()
    caps = torch.tensor([33, 12, 0])   # row 0 runs past cache position 32
    model.text_decoder.tap_steps = lambda steps: range(steps)
    with torch.inference_mode():
        ids, text, _ = model(feats, mask, caps, 33, LANG)
    taps = model.text_decoder.tapped
    w = _weights(model)
    for r, n in enumerate(lens[:2]):
        enc = ref.speech_encoder(w, _m(), feats[r:r + 1, :n])
        c = int(caps[r])
        toks = torch.cat([torch.tensor([3, LANG]), ids[r, :c - 1]])[None]
        want = ref.decoder_logits(w, _m(), enc, toks)[0, 1:]
        got = torch.stack([taps[g][r] for g in range(c)])
        assert _rel(got, want) < FP32_REL
        # the served token is the argmax of its own logits (pad excluded)
        assert torch.equal(ids[r, :c], got[:, 1:].argmax(-1) + 1)
    assert torch.equal(ids[2], torch.zeros_like(ids[2]))   # cap 0: idle


def test_reference_matches_transformers():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.SeamlessM4Tv2Config(
        vocab_size=512, hidden_size=64, speech_encoder_layers=2,
        speech_encoder_attention_heads=4, speech_encoder_intermediate_size=128,
        conv_depthwise_kernel_size=7, decoder_layers=2,
        decoder_attention_heads=4, decoder_ffn_dim=128, encoder_layers=1,
        encoder_attention_heads=4, encoder_ffn_dim=128, t2u_encoder_layers=1,
        t2u_decoder_layers=1, t2u_vocab_size=32, char_vocab_size=32,
        unit_hifi_gan_vocab_size=32)
    hf = transformers.SeamlessM4Tv2ForSpeechToText(cfg).eval()
    w = _weights(_model())
    sd = {}
    for k, v in w.items():
        h = (k.replace("speech_encoder.layers.",
                       "speech_encoder.encoder.layers.")
             .replace("speech_encoder.layer_norm.",
                      "speech_encoder.encoder.layer_norm.")
             .replace("speech_encoder.adapter.",
                      "speech_encoder.adapter.layers.")
             .replace("distance_embedding", "distance_embedding.weight"))
        sd[h] = v[..., None] if "pointwise_conv" in k else v
    sd["shared.weight"] = sd["lm_head.weight"] = \
        w["text_decoder.embed_tokens.weight"]
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and all("embed_positions" in k for k in missing)
    feats, _, _ = _batch(lens=(40,))
    toks = torch.tensor([[3, LANG, 17, 250, 9, 300]])
    with torch.no_grad():
        enc_hf = hf.speech_encoder(feats).last_hidden_state
        lg_hf = hf(input_features=feats, decoder_input_ids=toks).logits
    enc = ref.speech_encoder(w, _m(), feats)
    assert _rel(enc, enc_hf) < FP32_REL
    assert _rel(ref.decoder_logits(w, _m(), enc, toks), lg_hf) < FP32_REL


def test_rows_stop_at_eos_or_their_cap():
    """Random weights emit no ``</s>``: every row runs to its cap, which
    follows the rule. Then the final LayerNorm is made constant and the
    tied ``</s>`` row points along it: ``</s>`` is every row's argmax, so
    each row with a cap stops at its first token with no text, and a row
    with cap 0 emits nothing."""
    model = _model()
    feats, mask, lens = _batch()
    frames = [ref.adaptor_frames(n) for n in lens]
    caps = [ref.cap(f, 0.6, 8, 40) for f in frames]
    assert caps == [s2t.DecodeRule(40, 0.6, 8).cap(f) for f in frames]
    assert s2t.DecodeRule(256, 0.6, 8).cap(157) == 103   # a 25 s chunk
    with torch.inference_mode():
        ids, text, _ = model(feats, mask, torch.tensor(caps), max(caps),
                             LANG)
    assert text.sum(1).tolist() == caps
    assert not bool((ids[:, :max(caps)] == 3).any())
    dec = model.text_decoder
    with torch.no_grad():
        u = torch.randn(64, generator=torch.Generator().manual_seed(5))
        dec.layer_norm.weight.zero_()
        dec.layer_norm.bias.copy_(u)
        dec.embed_tokens.weight[3] = 10.0 * u
    with torch.inference_mode():
        ids, text, _ = model(feats, mask, torch.tensor([5, 1, 0]), 5, LANG)
    assert text.sum().item() == 0
    assert ids[:, 0].tolist() == [3, 3, 0]
    assert not bool(ids[:, 1:].any())


def test_new_weight_storage_drops_the_decode_states_and_step_graphs():
    """The decoder's loop states and their step graphs live among its
    graphs per device, under the one storage check of
    ``models/cuda_graphs.py``: an in-place weight update keeps a key's
    state; a weight put in other storage drops the state and its step
    graphs (a placeholder stands in for a graph: the CPU captures none)."""
    dec = _model().text_decoder
    key = (3, 9, torch.float32)
    st = dec._state(*key, CPU)
    st.graphs[LANG] = "a step graph"
    assert dec._state(*key, CPU) is st
    assert dec._state(2, 9, torch.float32, CPU) is not st
    fc1 = dec.layers[0].ffn.fc1
    with torch.no_grad():
        fc1.weight.add_(1.0)
    dg = dec._graphs.on(CPU, cuda_graphs.storage_key(dec))
    assert dec._state(*key, CPU) is st and st.dg is dg
    assert dg.entries[key] is st and len(dg.entries) == 2
    fc1.weight = torch.nn.Parameter(fc1.weight.detach().clone())
    fresh = dec._state(*key, CPU)
    assert fresh is not st and fresh.graphs == {} and fresh.dg is not dg
    assert list(dec._graphs.devices) == [CPU]
    assert list(fresh.dg.entries) == [key]
    caps = torch.tensor([4, 2, 0])
    with torch.inference_mode():
        dec.cross_kv(fresh, torch.randn(3, 9, 64), torch.ones(3, 9,
                                                                dtype=bool))
        ids, _, _ = dec.decode(fresh, caps, 4, LANG)
    assert ids.shape == (3, 4) and bool(ids[0].all())
    assert not bool(ids[2].any())                   # cap 0: idle


def _s2t_config(root: Path, **kw):
    raw = dict(input_folder=str(root / "in"), output_folder=str(root / "out"),
               logs_folder=str(root / "logs"), temp_dir=str(root / "tmp"),
               enable_mixed_precision=False, chunk_duration_sec=4.0,
               overlap_sec=1.0, length_buckets_sec=[2.0, 4.0],
               chunk_batch_size=2, file_batch_size=2, save_csv_results=True,
               save_intermediate_results=False, database_type="none",
               asr_model_type=s2t.MODEL_TYPE, s2t_max_new_tokens=40,
               s2t_len_a=0.6, s2t_len_b=8, s2t_tgt_lang_id=LANG)
    raw.update(kw)
    return PipelineConfig.from_dict(raw)


def test_data_processor_writes_detokenized_rows(tmp_path, monkeypatch):
    """The normal entry points (DataProcessor -> dispatch_chunks -> _fused
    -> fetch -> CSV) write, for every chunk, the mixed, agent and client
    texts that the pieces of the served tokens spell."""
    from audio_processor_tpu_torch.io import wav
    from audio_processor_tpu_torch.pipeline.engine import DataProcessor

    cfg = _s2t_config(tmp_path)
    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(0)
    for name, dur in (("call-0", 5.0), ("call-1", 3.0)):
        wav.write(tmp_path / "in" / f"{name}.wav",
                  0.1 * rng.standard_normal((2, int(16000 * dur))), 16000)
    vocab = PieceVocab.synthetic(512, 9, LANG)
    engine = ASREngine(cfg, device=CPU, model=_model(), vocab=vocab)
    served = []
    orig = ASREngine._fused

    def spy(self, *a, **k):
        out = orig(self, *a, **k)
        served.append((out[0].numpy(), out[1].numpy()))
        return out

    monkeypatch.setattr(ASREngine, "_fused", spy)
    proc = DataProcessor(cfg, asr_engine=engine, device=CPU)
    try:
        assert proc.run() == 2
    finally:
        proc.close()
    (path,) = (tmp_path / "out").glob("optimized_results_*.csv")
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 + 1 and not any(r["error"] for r in rows)
    want = {ref.detokenize(ids[m], vocab.pieces, {0, 1, 2, 3, LANG})
            for ids_b, mask_b in served for ids, m in zip(ids_b, mask_b)}
    got = [r[f] for r in rows for f in ("transcription_chunk",
                                        "agent_transcription",
                                        "client_transcription")]
    assert all(t for t in got) and set(got) <= want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ctc_logits_unchanged_by_the_body_head_split(dtype):
    """``Wav2Vec2Bert`` after its split into ``ConformerEncoder._body`` and
    the CTC head gives the pre-split path's logits bit for bit."""
    cfg = w2v.W2VBertConfig(vocab_size=40, hidden_size=64,
                            num_hidden_layers=2, num_attention_heads=4,
                            intermediate_size=128,
                            conv_depthwise_kernel_size=7)
    model = w2v.build_synthetic(cfg, CPU, seed=4)
    feats, mask, _ = _batch(lens=(64, 40))

    def pre_split(x, m):   # the forward as it was written before
        pad = m.float()
        bias = ((1.0 - pad) * -1e9)[:, None, None, :]
        fp = model.feature_projection
        h = w2v.dense(fp.projection, w2v.layer_norm(fp.layer_norm,
                                                    x.to(dtype)))
        h = h * pad[..., None].to(dtype)
        for layer in model.layers:
            h = layer(h, bias, pad, "xla")
        return w2v.dense(model.lm_head, h.float())

    with torch.inference_mode():
        want = pre_split(feats, mask)
        assert torch.equal(model(feats, mask, dtype=dtype), want)
        assert torch.equal(model._encode(feats, mask, dtype, "xla"), want)


def test_int8_reaches_the_adaptor_and_the_decoder(tmp_path):
    engine = ASREngine(_s2t_config(tmp_path, quantization="int8"),
                       device=CPU, model=_model())
    quant = {n for n, m in engine.model.named_modules()
             if isinstance(m, QuantLinear)}
    assert quant == set(s2t.quantized_names(engine.model.cfg))
    assert any(n.startswith("speech_encoder.adapter.") for n in quant)
    assert any(n.startswith("text_decoder.") for n in quant)
    fed = engine.transcribe_chunks(_chunks(2))
    assert len(fed) == 2 and not any(r["error"] for r in fed)


def _chunks(n):
    from audio_processor_tpu_torch.pipeline.chunker import Chunk

    rng = np.random.default_rng(1)
    return [Chunk("c.wav", i, 0.0, 3.0,
                  agent=0.1 * rng.standard_normal(48000).astype(np.float32),
                  client=0.1 * rng.standard_normal(48000)
                  .astype(np.float32)) for i in range(n)]


@pytest.mark.parametrize("case", ["word_timestamps", "message_path",
                                  "serve", "mono_rows"])
def test_what_the_s2t_model_refuses(case, tmp_path):
    from audio_processor_tpu_torch.serving import InferenceService

    extra = {"word_timestamps": {"emit_word_timestamps": True},
             "message_path": {"enable_message_path": True}}.get(case, {})
    cfg = _s2t_config(tmp_path, **extra)
    if case in ("word_timestamps", "message_path"):
        with pytest.raises(ValueError, match="does not run"):
            cli.validate_config(cfg)
        with pytest.raises(ValueError, match="does not run"):
            ASREngine(cfg, device=CPU, model=_model())
        return
    cli.validate_config(cfg)
    engine = ASREngine(cfg, device=CPU, model=_model())
    if case == "serve":
        with pytest.raises(ValueError, match="serving"):
            cli.validate_config(cfg, serve=True)
        with pytest.raises(ValueError, match="serv"):
            InferenceService(cfg, asr_engine=engine, device="cpu")
    else:
        with pytest.raises(ValueError, match="mono-rows"):
            engine.transcribe_mono_segments([np.zeros(16000, np.float32)])
