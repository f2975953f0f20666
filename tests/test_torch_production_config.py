"""The production batch configuration on the CPU: ``transcription_model``
set to a saved HF ``Wav2Vec2BertForCTC`` directory, both
``*_text_model_path``s set to saved HF BERT classifiers, the acoustic
heads, CSV output. The port's ``DataProcessor(device="cpu")`` and the JAX
package's run it on the same audio; their chunk rows must agree:
transcripts equal (fp32 on both sides; on these seeded weights no frame
is a near tie), text probabilities within 1e-5 (tests/
test_torch_text_sentiment.py), and every sentiment label and the fusion
equal. The port's CLI runs the same configuration from a YAML file."""

import csv
import json

import numpy as np
import pytest
import torch
import yaml

from audio_processor_tpu import config as jconfig
from audio_processor_tpu.pipeline.engine import DataProcessor as JaxProcessor
from audio_processor_tpu_torch import cli
from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.io import wav
from audio_processor_tpu_torch.pipeline.engine import DataProcessor

from tests.conftest import make_stereo_call
from tests.test_sentiment import (
    AGENT_LABELS, CLIENT_LABELS, _save_acoustic, _save_text_model,
)
from tests.test_torch_hf_checkpoint import _save_w2v

PROB_ATOL = 1e-5


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("production")
    models = root / "models"
    for name, labels, seed in (("client_text", CLIENT_LABELS, 0),
                               ("agent_text", AGENT_LABELS, 1)):
        (models / name).mkdir(parents=True)
        _save_text_model(models / name, labels, seed)
    _save_acoustic(models, CLIENT_LABELS, "svc", 2)
    _save_acoustic(models, AGENT_LABELS, "forest", 3)
    _save_w2v(models / "asr")
    inp = root / "input"
    inp.mkdir()
    rng = np.random.default_rng(0)
    for i, dur in enumerate((6.0, 9.0)):
        call = make_stereo_call(dur=dur) + 0.05 * rng.standard_normal(
            (2, int(16000 * dur))).astype(np.float32)
        wav.write(inp / f"call-{i}.wav", call, 16000)
    settings = {
        "input_folder": str(inp), "logs_folder": str(root / "logs"),
        "transcription_model": str(models / "asr"),
        "client_text_model_path": str(models / "client_text"),
        "agent_text_model_path": str(models / "agent_text"),
        "client_acoustic_model_path": str(models / "svc_model.joblib"),
        "client_acoustic_scaler_path": str(models / "svc_scaler.joblib"),
        "agent_acoustic_model_path": str(models / "forest_model.joblib"),
        "agent_acoustic_scaler_path": str(models / "forest_scaler.joblib"),
        "enable_mixed_precision": False, "chunk_duration_sec": 4.0,
        "overlap_sec": 1.0, "length_buckets_sec": [2.0, 4.0],
        "chunk_batch_size": 4, "save_csv_results": True,
    }
    return root, settings


def _run(processor):
    """Run a DataProcessor and return its sentiment rows by chunk."""
    rows = []
    processor.setup_models()
    real = processor.sentiment_analyzer.analyze_batch_sentiment
    processor.sentiment_analyzer.analyze_batch_sentiment = \
        lambda chunks: rows.extend(real(chunks)) or chunks
    try:
        assert processor.run() == 2
    finally:
        processor.close()
    return {(r["file_name"], r["chunk_idx"]): r for r in rows}


def test_port_rows_equal_jax_rows(workspace):
    root, settings = workspace
    port_cfg = PipelineConfig.from_dict(
        {**settings, "output_folder": str(root / "out_port")})
    jax_cfg = jconfig.PipelineConfig.from_dict(
        {**settings, "output_folder": str(root / "out_jax")})
    port = DataProcessor(port_cfg, device="cpu")
    got = _run(port)
    assert port.sentiment_analyzer.text_analyzer.models_available
    assert port.asr_engine.model_cfg.num_hidden_layers == 3
    want = _run(JaxProcessor(jax_cfg))
    assert set(got) == set(want) and len(got) == 5
    texts = 0
    for key, w in want.items():
        g = got[key]
        for field in ("transcription_chunk", "agent_transcription",
                      "client_transcription", "error"):
            assert g[field] == w[field], (key, field)
        for speaker in ("agent", "client"):
            for kind in ("text", "acoustic", "fusion"):
                f = f"{speaker}_{kind}_sentiment"
                assert g[f] == w[f], (key, f)
            p = f"{speaker}_text_probabilities"
            np.testing.assert_allclose(g[p], w[p], atol=PROB_ATOL, rtol=0)
            texts += g[f"{speaker}_text_sentiment"] != ""
    assert texts >= 4


def test_cli_runs_the_production_config(workspace):
    root, settings = workspace
    out = root / "out_cli"
    path = root / "production.yaml"
    path.write_text(yaml.safe_dump({**settings, "output_folder": str(out)}))
    assert cli.main(["--config", str(path), "--save-mode", "csv",
                     "--device", "cpu"]) == 0
    (csv_path,) = out.glob("optimized_results_*.csv")
    with open(csv_path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 5 and not any(r["error"] for r in rows)
    assert any(r["client_text_sentiment"] in CLIENT_LABELS for r in rows)
    assert (root / "models" / "asr" / "torch_converted"
            / "metadata.json").exists()
    assert json.loads((root / "models" / "asr" / "torch_converted"
                       / "metadata.json").read_text())["config"][
        "num_hidden_layers"] == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["--config", str(path)])
