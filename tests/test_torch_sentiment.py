"""The port's sentiment stack (numpy heads, late fusion, coordinator)
against the JAX package's, on the same fitted sklearn models and the
same chunk rows. The heads are numpy on both sides, so results must be
equal, not merely close."""

import numpy as np
import pytest
import torch

from audio_processor_tpu import config as jconfig
from audio_processor_tpu.pipeline import sentiment as jax_sentiment
from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.pipeline import sentiment as port_sentiment

from tests.test_sentiment import AGENT_LABELS, CLIENT_LABELS, _save_acoustic


class _FixedText:
    """Stands in for both packages' text analyzers: fixed predictions
    (text BERT is not ported), so acoustic gating and fusion run."""

    def __init__(self, labels):
        self.labels = labels

    def analyze_batch_sentiment(self, texts, speaker):
        out = []
        for i, t in enumerate(texts):
            if len(t.strip()) < 5:
                out.append({"prediction": "", "confidence": 0.0,
                            "probabilities": []})
                continue
            p = np.roll([0.55, 0.25, 0.15, 0.05], i)
            lab = self.labels[speaker]
            out.append({"prediction": lab[int(np.argmax(p))],
                        "confidence": float(p.max()),
                        "probabilities": p.tolist()})
        return out

    def dispatch_batch(self, texts, speaker):
        res = self.analyze_batch_sentiment(texts, speaker)
        return lambda: res


@pytest.fixture(scope="module")
def analyzers(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_sentiment_models")
    _save_acoustic(base, CLIENT_LABELS, "svc", 2)
    _save_acoustic(base, AGENT_LABELS, "forest", 3)
    cfg = PipelineConfig(
        client_acoustic_model_path=str(base / "svc_model.joblib"),
        client_acoustic_scaler_path=str(base / "svc_scaler.joblib"),
        agent_acoustic_model_path=str(base / "forest_model.joblib"),
        agent_acoustic_scaler_path=str(base / "forest_scaler.joblib"))
    return (port_sentiment.SentimentAnalyzer(cfg,
                                             device=torch.device("cpu")),
            jax_sentiment.SentimentAnalyzer(
                jconfig.PipelineConfig.from_dict(cfg.to_dict())))


def _chunks(seed, n=4):
    rng = np.random.default_rng(seed)
    texts = ["salam labas bikhir", "ok", "chokran bzaf", "wakha a sidi"]
    out = []
    for i in range(n):
        feats = rng.standard_normal((2, 38)).astype(np.float32) * 3
        out.append({
            "file_name": "call7.wav", "chunk_idx": i,
            "agent_transcription": texts[i % 4],
            "client_transcription": texts[(i + 1) % 4],
            "agent_waveform": np.zeros(16000, np.float32),
            "client_waveform": np.zeros(16000, np.float32),
            "agent_acoustic_features": feats[0],
            "client_acoustic_features": feats[1],
        })
    out[-1]["agent_acoustic_features"] = np.full(38, np.nan, np.float32)
    return out


@pytest.mark.parametrize("speaker", ["client", "agent"])
def test_classify_features_equals_jax(analyzers, speaker):
    port, ref = analyzers
    feats = np.stack([c[f"{speaker}_acoustic_features"]
                      for c in _chunks(0, 8)])
    got = port.acoustic_analyzer.classify_features(feats, speaker)
    want = ref.acoustic_analyzer.classify_features(feats, speaker)
    assert got == want
    assert sum(g["prediction"] != "" for g in got) >= 6


def test_text_disabled_gates_acoustic_like_jax(analyzers):
    port, ref = analyzers
    got = port.analyze_batch_sentiment(_chunks(1))
    want = ref.analyze_batch_sentiment(_chunks(1))
    assert got[0].keys() == want[0].keys()
    for g, w in zip(got, want):
        for key in w:
            if key.endswith(("sentiment", "confidence", "probabilities")):
                assert g[key] == w[key], key
        assert g["agent_acoustic_sentiment"] == ""     # gated off


def test_fusion_with_text_equals_jax(analyzers, monkeypatch):
    port, ref = analyzers
    text = _FixedText({"client": CLIENT_LABELS, "agent": AGENT_LABELS})
    monkeypatch.setattr(port, "text_analyzer", text)
    monkeypatch.setattr(ref, "text_analyzer", text)
    got = port.analyze_batch_sentiment(_chunks(2))
    want = ref.analyze_batch_sentiment(_chunks(2))
    fused = 0
    for g, w in zip(got, want):
        for key in w:
            if key.endswith(("sentiment", "confidence", "probabilities")):
                assert g[key] == w[key], key
        fused += g["client_fusion_sentiment"] != ""
    assert fused >= 2


def test_extract_features_on_device_matches_jax(analyzers):
    """The fallback path (no fused features): the port extracts on its
    analyzer's device; relative to max(|ref|, 1), 2e-4 as in
    tests/test_fused_engine.py."""
    port, ref = analyzers
    rng = np.random.default_rng(3)
    waves = [(0.1 * rng.standard_normal(n)).astype(np.float32)
             for n in (16000, 12000, 9000)]
    got = port.acoustic_analyzer.extract_features(waves, 16000)
    want = ref.acoustic_analyzer.extract_features(waves, 16000)
    scale = np.maximum(np.abs(want), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-4)


def test_default_device_is_cuda_and_never_falls_back_to_cpu():
    """With no device given, both analyzers target ``cuda`` (as
    ``DataProcessor`` does); without CUDA a feature extraction raises
    instead of running on the CPU."""
    cfg = PipelineConfig()
    coordinator = port_sentiment.SentimentAnalyzer(cfg)
    assert coordinator.device == torch.device("cuda")
    assert coordinator.acoustic_analyzer.device == torch.device("cuda")
    acoustic = port_sentiment.AcousticSentimentAnalyzer(cfg)
    assert acoustic.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            acoustic.extract_features([np.zeros(16000, np.float32)], 16000)


def test_configured_text_model_raises(tmp_path, caplog):
    """Configured text paths load (tests/test_torch_text_sentiment.py);
    paths that hold no checkpoint fail to load as in the JAX package: the
    error is logged and text sentiment is disabled, with no exception out
    of the constructor. What still raises is the load itself."""
    cfg = PipelineConfig(client_text_model_path=str(tmp_path / "c"),
                         agent_text_model_path=str(tmp_path / "a"))
    with caplog.at_level("ERROR"):
        port = port_sentiment.SentimentAnalyzer(cfg, device="cpu")
    ref = jax_sentiment.SentimentAnalyzer(
        jconfig.PipelineConfig.from_dict(cfg.to_dict()))
    assert "Failed to load text models" in caplog.text
    assert not port.text_analyzer.models_available
    assert port.text_analyzer.models_available == \
        ref.text_analyzer.models_available
    texts = ["salam labas bikhir", "ok"]
    assert port.text_analyzer.analyze_batch_sentiment(texts, "agent") == \
        ref.text_analyzer.analyze_batch_sentiment(texts, "agent")
    with pytest.raises(FileNotFoundError):
        port.text_analyzer._load_one(str(tmp_path / "c"))
