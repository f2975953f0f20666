"""The port's batch pipeline end to end on the CPU, in a fresh
interpreter (no tests/conftest.py, which imports JAX): the port's
DataProcessor over three stereo WAVs, one of them at 8 kHz (resampled
on the host), with an injected tiny engine on an explicit CPU device.
Checks the CSV rows, the markers, and that JAX was never imported."""

import csv
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from audio_processor_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]

DRIVER = r"""
import json, sys
from pathlib import Path

import numpy as np
import torch

from audio_processor_tpu.config import PipelineConfig
from audio_processor_tpu.io import wav
from audio_processor_tpu.models.tokenizer import CTCVocab
from audio_processor_tpu_torch.models import wav2vec2bert as w2v
from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
from audio_processor_tpu_torch.pipeline.engine import DataProcessor

root = Path(sys.argv[1])
inp = root / "input"
inp.mkdir()
rng = np.random.default_rng(0)
for name, sr, dur in (("call-0", 16000, 5.0), ("call-1", 16000, 7.0),
                      ("call-2", 8000, 6.0)):
    wav.write(inp / f"{name}.wav",
              0.1 * rng.standard_normal((2, int(sr * dur))), sr)
cfg = PipelineConfig(
    input_folder=str(inp), output_folder=str(root / "output"),
    logs_folder=str(root / "logs"), temp_dir=str(root / "tmp"),
    enable_mixed_precision=False, chunk_duration_sec=4.0, overlap_sec=1.0,
    length_buckets_sec=(2.0, 4.0), chunk_batch_size=4,
    save_csv_results=True)
vocab = CTCVocab.darija_default()
mcfg = w2v.W2VBertConfig(vocab_size=len(vocab), hidden_size=64,
                         num_hidden_layers=1, num_attention_heads=1,
                         intermediate_size=128,
                         conv_depthwise_kernel_size=7)
cpu = torch.device("cpu")
engine = ASREngine(cfg, device=cpu, model=w2v.build_synthetic(mcfg, cpu),
                   vocab=vocab)
proc = DataProcessor(cfg, asr_engine=engine, device=cpu)
try:
    n = proc.run()
finally:
    proc.close()
print(json.dumps({"succeeded": n, "dispatches": engine.dispatches,
                  "stats": {k: v for k, v in proc.stats.items()
                            if isinstance(v, int)},
                  "jax_imported": "jax" in sys.modules}))
"""


def test_port_pipeline_runs_without_jax(tmp_path):
    r = subprocess.run([sys.executable, "-c", DRIVER, str(tmp_path)],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["jax_imported"] is False
    assert out["succeeded"] == 3
    assert out["stats"]["files_success"] == 3
    assert out["stats"]["errors"] == 0
    # warmup (3 tail shapes of the top bucket) + one batch per file batch
    assert out["dispatches"] >= 4

    output = tmp_path / "output"
    done = sorted(p.name for p in (output / "processed_markers").glob("*"))
    assert done == ["call-0.done", "call-1.done", "call-2.done"]
    (csv_path,) = output.glob("optimized_results_*.csv")
    with open(csv_path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    # 4 s chunks with 1 s overlap: 5 s, 7 s and 6 s calls give 2 each
    # (the 8 kHz call is resampled to 16 kHz before chunking).
    by_file = {}
    for row in rows:
        by_file[row["file_name"]] = by_file.get(row["file_name"], 0) + 1
        assert row["error"] == ""
    assert by_file == {"call-0.wav": 2, "call-1.wav": 2, "call-2.wav": 2}


def test_cli_refuses_serve_and_missing_cuda(tmp_path):
    """``--serve`` is not ported; the default ``--device cuda`` refuses
    to start without CUDA instead of running on the CPU."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--serve"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["--config", str(tmp_path / "absent.yaml")])
    assert cli.resolve_device("cpu").type == "cpu"
