"""The port stands alone: importing every module of
``audio_processor_tpu_torch``, ``chip_smoke.py`` and the port's tools
loads neither JAX (nor optax or orbax) nor any module of the JAX package
``audio_processor_tpu``, and no source of the port names that package
in an import statement, lazy ones inside functions included. Loading HF
checkpoints and tokenizing text needs none of ``transformers``,
``safetensors``, ``tokenizers`` or ``orbax`` either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "audio_processor_tpu_torch"
SCRIPTS = [REPO / "chip_smoke.py"] + sorted((REPO / "tools").glob("*torch*.py"))

# Imports every module of the port by name, then each script as a module
# (under a name other than __main__, so that none of them runs), and
# prints what sys.modules then holds of JAX and of the JAX package.
IMPORT_ALL = r"""
import importlib, importlib.util, json, pkgutil, sys

import audio_processor_tpu_torch as port

names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"_script_{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax",
                                    "audio_processor_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _imported_names(path: Path):
    """Every module name an import statement of ``path`` names."""
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_importing_the_port_loads_no_jax_and_no_jax_package():
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL, *map(str, SCRIPTS)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(out["modules"]) > 50     # io/ alone holds some 30 modules
    # The message path's modules, the facade, the serving modules, the
    # fine-tuning modules, the scale-out modules and the entry points are
    # among them.
    assert {f"audio_processor_tpu_torch.{m}" for m in (
        "models.vad", "models.ctc_beam", "host.darija",
        "pipeline.segmenter", "pipeline.facades", "obs.profiler",
        "serving", "grpc_serving", "protos.serving_pb2", "utils.system",
        "training.train_step", "training.finetune", "utils.metrics",
        "parallel.distributed", "parallel.collectives", "parallel.mesh",
        "parallel.multi_device", "parallel.pipeline", "parallel.launch",
        "entry")} <= set(out["modules"])
    assert out["bad"] == []
    # The profilers of the two host-side paths are among the scripts.
    assert {REPO / "tools" / f"{t}_torch.py" for t in (
        "profile_e2e", "profile_message_path")} <= set(SCRIPTS)


@pytest.mark.parametrize("root", ["audio_processor_tpu_torch", "scripts"])
def test_no_source_names_the_jax_package(root):
    files = sorted(PORT.rglob("*.py")) if root != "scripts" else SCRIPTS
    assert files
    offenders = [f"{f.relative_to(REPO)}: {name}" for f in files
                 for name in _imported_names(f)
                 if name.split(".")[0] in ("jax", "optax", "orbax",
                                           "audio_processor_tpu")]
    assert offenders == []


# Loads a saved HF ASR directory and a BERT classifier directory through
# the port's loaders and tokenizer, runs the text analyzer on the CPU and
# prints which of the libraries the JAX package loads them with are loaded.
LOAD_HF = r"""
import json, sys

from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.models.bert_tokenizer import BertTokenizer
from audio_processor_tpu_torch.models.checkpoint import (
    load_or_convert_w2v_bert,
)
from audio_processor_tpu_torch.pipeline.sentiment import TextSentimentAnalyzer

w2v_dir, bert_dir = sys.argv[1:3]
cfg, sd, vocab = load_or_convert_w2v_bert(w2v_dir)
ids = BertTokenizer.from_pretrained(bert_dir)(["salam labas"])["input_ids"]
text = TextSentimentAnalyzer(PipelineConfig(
    client_text_model_path=bert_dir, agent_text_model_path=bert_dir),
    device="cpu")
res = text.analyze_batch_sentiment(["salam labas bikhir", "ok"], "client")
banned = ("jax", "jaxlib", "audio_processor_tpu", "transformers",
          "safetensors", "tokenizers", "orbax")
print(json.dumps({"layers": cfg.num_hidden_layers, "tensors": len(sd),
                  "vocab": len(vocab), "ids": ids.tolist(),
                  "available": text.models_available,
                  "predictions": [r["prediction"] for r in res],
                  "bad": sorted(m for m in sys.modules
                                if m.split(".")[0] in banned)}))
"""


def test_hf_loading_and_text_sentiment_load_no_hf_library(tmp_path):
    from tests.test_sentiment import CLIENT_LABELS, _save_text_model
    from tests.test_torch_hf_checkpoint import _save_w2v

    w2v_dir, bert_dir = tmp_path / "w2v", tmp_path / "bert"
    bert_dir.mkdir()
    _save_w2v(w2v_dir)
    _save_text_model(bert_dir, CLIENT_LABELS, 0)
    r = subprocess.run([sys.executable, "-c", LOAD_HF, str(w2v_dir),
                        str(bert_dir)], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["layers"] == 3 and out["tensors"] > 50 and out["vocab"] >= 32
    assert out["available"] is True
    assert out["predictions"][0] in CLIENT_LABELS
    assert out["predictions"][1] == ""
    assert out["ids"][0][0] == 2 and out["ids"][0][-1] == 3   # [CLS] .. [SEP]


def test_native_library_lives_in_the_port():
    """The port's native I/O library is built into and loaded from the
    port's own directory, never the JAX package's."""
    from audio_processor_tpu_torch import _build
    from audio_processor_tpu_torch.io import native

    lib = _build.native_library()
    assert native._LIB_PATH == lib
    assert lib.parent == PORT / "io" / "_native"
    assert lib.name.startswith("libaudioio-") and lib.suffix == ".so"


def test_serving_modules_import_without_grpc_or_protobuf():
    """The card machine may have neither ``grpc`` nor ``protobuf``: the
    serving modules import and build an HTTP service without them, and
    only building a gRPC server reaches for them."""
    code = r"""
import sys
for name in ("grpc", "google.protobuf"):
    sys.modules[name] = None          # makes any import of them fail
from audio_processor_tpu_torch import grpc_serving, serving
from audio_processor_tpu_torch.cli import main
try:
    grpc_serving.GrpcInferenceServer(None, 0)
except ImportError:
    print("refused")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip() == "refused"
