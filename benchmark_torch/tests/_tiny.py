"""A cell of the benchmark at a size the CPU runs in seconds: the real
harness, configuration and traffic files with the widths, depth, pool and
batch cut down."""

from __future__ import annotations

import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark_torch.harness.job import Job  # noqa: E402
from benchmark_torch.harness.spec import Spec  # noqa: E402

# Cells measured on the card and left out of BENCHMARK.json (PERF.md): their
# drivers, mixes and limits are kept, and checked here.
EXTRA_CELLS = {
    "asr.telephony-ulaw8k": {"name": "asr.telephony-ulaw8k", "chips": 1,
                             "config": "w2v-bert-2.0.asr",
                             "traffic": "telephony-ulaw8k"},
    "serve.prod-poisson": {"name": "serve.prod-poisson", "chips": 1,
                           "config": "w2v-bert-2.0.darijabert.prod",
                           "traffic": "prod-poisson"},
}
TINY_MODEL = {"hidden_size": 128, "num_hidden_layers": 2,
              "num_attention_heads": 2, "intermediate_size": 256}
TINY_TEXT = {"hidden_size": 64, "num_hidden_layers": 2,
             "num_attention_heads": 2, "intermediate_size": 128}


def tiny_job(cell_name: str, tmp: Path, seed: int = 7, trace: bool = False,
             control: bool = False, overrides=None) -> Job:
    spec = Spec(ROOT)
    cell = EXTRA_CELLS.get(cell_name) or spec.cell(cell_name)
    config = spec.config(cell)
    if "text_model" in config:
        config = dict(config, text_model=dict(config["text_model"],
                                              **TINY_TEXT))
    config = dict(config, model=dict(config["model"], **TINY_MODEL),
                  pipeline=dict(config["pipeline"], chunk_batch_size=4,
                                file_batch_size=2, io_workers=2,
                                **(overrides or {})))
    mix = dict(spec.mix(cell), pool_calls=4)
    if mix["duration_s"]["dist"] == "fixed":
        mix["duration_s"] = {"dist": "fixed", "value": 30.0}
    else:
        mix["duration_s"] = dict(mix["duration_s"], median=12.0, min=6.0,
                                 max=30.0)
    return Job(name=cell["name"], config=config, mix=mix,
               generator=spec.generator(mix["kind"]),
               limits=spec.limits(cell), end_to_end=spec.end_to_end(cell),
               per_layer=spec.per_layer(cell), seed=seed,
               seconds=2.0 if mix["kind"] == "open_loop_http" else 0.01,
               trace=trace, device="cpu", tmp=tmp,
               t_process=time.perf_counter(), control=control)


def run_tiny(cell_name: str, **kw) -> dict:
    import importlib

    tmp = Path(tempfile.mkdtemp(prefix="bench-tiny-"))
    try:
        job = tiny_job(cell_name, tmp, **kw)
        driver = importlib.import_module(
            f"benchmark_torch.harness.{job.generator.DRIVER}")
        return driver.run(job)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
