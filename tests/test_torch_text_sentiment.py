"""The port's text sentiment (``TextSentimentAnalyzer`` and the
coordinator's ``_analyze_batch``) against the JAX package's, on the
directories tests/test_sentiment.py saves (tiny HF BERT classifiers with
their tokenizers, fitted sklearn heads). The port loads them without
``transformers``; the JAX package through it. Probabilities agree within
1e-5 (fp32 on both sides, as tests/test_torch_bert.py), and predictions,
skips and every fusion field are equal. int8 classifiers: probabilities
within 1e-4 (see tests/test_torch_bert.py)."""

import numpy as np
import pytest
import torch

from audio_processor_tpu import config as jconfig
from audio_processor_tpu.pipeline import sentiment as jax_sentiment
from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.pipeline import sentiment as port_sentiment

from tests.test_sentiment import (
    AGENT_LABELS, CLIENT_LABELS, _save_acoustic, _save_text_model,
)

PROB_ATOL = 1e-5
INT8_PROB_ATOL = 1e-4
TEXTS = ["salam labas", "chokran bzaf hh", "", "hi", "   ok   ",
         "wakha a sidi bikhir", "ghadi n3ayet lik mn ba3d",
         "salam " * 200]


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_text_models")
    for name, labels, seed in (("client_text", CLIENT_LABELS, 0),
                               ("agent_text", AGENT_LABELS, 1)):
        (base / name).mkdir()
        _save_text_model(base / name, labels, seed)
    _save_acoustic(base, CLIENT_LABELS, "svc", 2)
    _save_acoustic(base, AGENT_LABELS, "forest", 3)
    return base


def _cfg(base, **extra):
    return PipelineConfig.from_dict({
        "client_text_model_path": str(base / "client_text"),
        "agent_text_model_path": str(base / "agent_text"),
        "client_acoustic_model_path": str(base / "svc_model.joblib"),
        "client_acoustic_scaler_path": str(base / "svc_scaler.joblib"),
        "agent_acoustic_model_path": str(base / "forest_model.joblib"),
        "agent_acoustic_scaler_path": str(base / "forest_scaler.joblib"),
        **extra})


@pytest.fixture(scope="module")
def analyzers(model_dirs):
    cfg = _cfg(model_dirs)
    return (port_sentiment.SentimentAnalyzer(cfg, device="cpu"),
            jax_sentiment.SentimentAnalyzer(
                jconfig.PipelineConfig.from_dict(cfg.to_dict())))


def _assert_text_results_equal(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["prediction"] == w["prediction"]
        if not w["probabilities"]:
            assert g == w                                  # skipped text
            continue
        np.testing.assert_allclose(g["probabilities"], w["probabilities"],
                                   atol=atol, rtol=0)
        assert abs(g["confidence"] - w["confidence"]) <= atol


@pytest.mark.parametrize("speaker", ["client", "agent"])
def test_text_probabilities_equal_jax(analyzers, speaker):
    port, ref = analyzers
    assert port.text_analyzer.models_available
    assert port.text_analyzer.models[speaker]["id2label"] == \
        ref.text_analyzer.models[speaker]["id2label"]
    got = port.text_analyzer.analyze_batch_sentiment(TEXTS, speaker)
    want = ref.text_analyzer.analyze_batch_sentiment(TEXTS, speaker)
    _assert_text_results_equal(got, want, PROB_ATOL)
    assert [g["prediction"] == "" for g in got] == \
        [len(t.strip()) < 5 for t in TEXTS]
    assert port.text_analyzer.analyze_sentiment(TEXTS[0], speaker) == got[0]
    # 5 valid texts, 512 tokens at most: one 16-row batch at bucket 512.
    assert port.text_analyzer.shapes_run[(16, 512)] >= 1


def _chunks(seed, n=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        feats = rng.standard_normal((2, 38)).astype(np.float32) * 3
        out.append({
            "file_name": "call7.wav", "chunk_idx": i,
            "agent_transcription": TEXTS[i % len(TEXTS)],
            "client_transcription": TEXTS[(i + 5) % len(TEXTS)],
            "agent_waveform": np.zeros(16000, np.float32),
            "client_waveform": np.zeros(16000, np.float32),
            "agent_acoustic_features": feats[0],
            "client_acoustic_features": feats[1],
        })
    return out


def test_analyze_batch_rows_equal_jax(analyzers):
    port, ref = analyzers
    got = port.analyze_batch_sentiment(_chunks(0))
    want = ref.analyze_batch_sentiment(_chunks(0))
    fused = 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            if key.endswith("probabilities") and "text" in key:
                np.testing.assert_allclose(g[key], w[key], atol=PROB_ATOL)
            elif key.endswith("confidence"):
                assert abs(g[key] - w[key]) <= PROB_ATOL, key
            elif key.endswith(("sentiment", "probabilities")):
                assert g[key] == w[key], key
        fused += g["agent_fusion_sentiment"] != ""
    assert fused >= 2


def test_both_speakers_dispatched_before_either_fetch(analyzers,
                                                     monkeypatch):
    port, _ = analyzers
    events = []
    real = port.text_analyzer.dispatch_batch

    def spy(texts, speaker):
        events.append(("dispatch", speaker))
        fetch = real(texts, speaker)
        return lambda: events.append(("fetch", speaker)) or fetch()

    monkeypatch.setattr(port.text_analyzer, "dispatch_batch", spy)
    port._analyze_batch(_chunks(1, 2))
    assert events == [("dispatch", "agent"), ("dispatch", "client"),
                      ("fetch", "agent"), ("fetch", "client")]


def test_int8_text_classifiers_match_jax_int8(model_dirs):
    cfg = _cfg(model_dirs, quantization="int8")
    port = port_sentiment.TextSentimentAnalyzer(cfg, device="cpu")
    ref = jax_sentiment.TextSentimentAnalyzer(
        jconfig.PipelineConfig.from_dict(cfg.to_dict()))
    from audio_processor_tpu_torch.models.quant import QuantLinear

    layer = port.models["client"]["model"].bert["encoder"]["layer"][0]
    assert isinstance(layer["intermediate"]["dense"], QuantLinear)
    for speaker in ("client", "agent"):
        _assert_text_results_equal(
            port.analyze_batch_sentiment(TEXTS, speaker),
            ref.analyze_batch_sentiment(TEXTS, speaker), INT8_PROB_ATOL)


def test_api_gaps_equal_jax(analyzers):
    port, ref = analyzers
    for label in ("aggressive", "Neutre", None, "sec", "mécontent"):
        assert port.pretty_sentiment(label) == ref.pretty_sentiment(label)
    wave = (0.1 * np.random.default_rng(4).standard_normal(16000)
            ).astype(np.float32)
    got = port.acoustic_analyzer.analyze_sentiment(wave, 16000, "client")
    want = ref.acoustic_analyzer.analyze_sentiment(wave, 16000, "client")
    assert got["prediction"] == want["prediction"]
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               atol=5e-4)
