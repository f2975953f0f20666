"""The port's multi-process bootstrap and call sharding
(parallel/distributed.py) against the JAX package's, and a two-process
run of the port's CLI on the CPU.

- ``initialize_distributed`` under the launch environments a user gives:
  the JAX package's variables and torchrun's, each with one process and
  with two (the group's ``init_process_group`` call captured); the
  backend rule (NCCL when each process has a card, gloo only by name);
- ``owns_call`` and ``local_file_shard`` equal to the JAX functions for
  a world of 3 at rank 1 (the JAX side with ``jax.process_count`` and
  ``jax.process_index`` patched, tests/test_multidevice.py:105-116 covers
  one process only);
- ``cli.main`` under a launch of 2 processes: it joins the group with gloo
  for ``--device cpu``; then two real CLI processes (gloo, a ``file://``
  rendezvous through ``JAX_COORDINATOR_ADDRESS``) over 8 calls from a
  saved HF checkpoint: each process's markers are its ``owns_call``
  share, the shares are disjoint and cover the calls, and the union of
  their CSV rows (one per call) equals a one-process port run's and the
  JAX package's ``DataProcessor``'s (transcripts equal; fp32 on both
  sides, as tests/test_torch_production_config.py holds them).
"""

import csv
import datetime
import json
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from audio_processor_tpu_torch import cli
from audio_processor_tpu_torch.parallel import distributed as pdist
from audio_processor_tpu_torch.parallel import launch

from tests.conftest import make_stereo_call

REPO = Path(__file__).resolve().parents[1]
ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
       "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
       "MASTER_PORT")


@pytest.fixture
def captured(monkeypatch):
    """Clear the launch variables and capture init_process_group."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


@pytest.mark.parametrize("env, expect", [
    ({"JAX_COORDINATOR_ADDRESS": "localhost:1234"}, "JAX_NUM_PROCESSES"),
    ({"JAX_COORDINATOR_ADDRESS": "localhost:1234", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "1"}, ("tcp://localhost:1234", 2, 1)),
    ({"JAX_COORDINATOR_ADDRESS": "localhost:1234",
      "JAX_NUM_PROCESSES": "1"}, None),
    ({"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "localhost",
      "MASTER_PORT": "1234"}, ("env://", 2, 1)),
    ({"WORLD_SIZE": "1"}, None)])
def test_initialize_distributed_reads_the_launch(captured, monkeypatch, env,
                                                 expect):
    """One process (or none named) is a no-op returning rank 0; two join
    the group with the launch's address, size and rank, and a timeout; a
    coordinator without a process count is refused."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if isinstance(expect, str):
        with pytest.raises(ValueError, match=expect):
            pdist.initialize_distributed(backend="gloo")
        assert captured == []
        return
    rank = pdist.initialize_distributed(backend="gloo")
    if expect is None:
        assert rank == 0 and captured == []
        return
    (kw,) = captured
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == expect
    assert rank == expect[2] and kw["backend"] == "gloo"
    assert isinstance(kw["timeout"], datetime.timedelta)


def test_backend_is_nccl_per_card_and_gloo_only_by_name(captured,
                                                        monkeypatch):
    """NCCL when each process of the host has a card; two processes on one
    card, or no card, raise ValueError naming gloo; gloo runs when asked
    for."""
    args = dict(coordinator_address="localhost:1", num_processes=2,
                process_id=0)
    with pytest.raises(ValueError, match='backend="gloo"'):
        pdist.initialize_distributed(**args)          # no CUDA here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        pdist.initialize_distributed(**args)
    assert captured == []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    chosen = []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    pdist.initialize_distributed(**{**args, "process_id": 1})
    pdist.initialize_distributed(**args, backend="gloo")
    assert [kw["backend"] for kw in captured] == ["nccl", "gloo"]
    assert chosen == [torch.device("cuda", 1)]      # rank 1's card, first


def test_owns_call_and_shards_match_jax(monkeypatch):
    """A world of 3 at rank 1: the same calls owned, the same file shard,
    as the JAX package's functions with its process count and index
    patched; the hash is crc32 of the call id."""
    import jax

    from audio_processor_tpu.parallel import distributed as jdist

    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(pdist, "process_count", lambda: 3)
    monkeypatch.setattr(pdist, "process_index", lambda: 1)
    ids = [f"call-{i}" for i in range(200)] + ["", "é-ü", "a" * 300]
    owned = [c for c in ids if pdist.owns_call(c)]
    assert owned == [c for c in ids if jdist.owns_call(c)]
    assert owned == [c for c in ids if zlib.crc32(c.encode()) % 3 == 1]
    assert 40 < len(owned) < 100
    files = [f"f{i}.wav" for i in range(11)][::-1]
    assert pdist.local_file_shard(files) == jdist.local_file_shard(files)
    assert pdist.local_file_shard(files, sort=False) == \
        jdist.local_file_shard(files, sort=False)
    assert not pdist.is_primary_host() and not jdist.is_primary_host()


def test_cli_joins_the_launch_with_gloo_on_the_cpu(tmp_path, monkeypatch):
    """``cli.main --device cpu`` under a launch of two processes joins the
    group with gloo (``--dist-backend`` overrides) before the run."""
    from audio_processor_tpu_torch.pipeline import engine as tengine

    calls = []
    monkeypatch.setattr(pdist, "initialize_distributed",
                        lambda **kw: calls.append(kw) or 1)
    monkeypatch.setattr(pdist, "process_count", lambda: 2)
    runs = []
    monkeypatch.setattr(tengine.DataProcessor, "run",
                        lambda self: runs.append(self.device) or 0)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(json.dumps({
        "input_folder": str(tmp_path / "in"),
        "output_folder": str(tmp_path / "out"),
        "logs_folder": str(tmp_path / "logs")}))
    for extra, backend in (([], "gloo"), (["--dist-backend", "nccl"],
                                          "nccl")):
        assert cli.main(["--config", str(cfg), "--save-mode", "csv",
                         "--device", "cpu", *extra]) == 0
        assert calls[-1] == {"backend": backend}
    assert runs == [torch.device("cpu")] * 2


def test_data_processor_joins_a_launch_it_was_started_under(captured,
                                                           monkeypatch,
                                                           tmp_path):
    """``DataProcessor.run`` under a launch of two processes that nobody
    joined joins it (gloo on the CPU) before it scans a file, so no
    process of the launch runs every call."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.pipeline import engine as tengine

    for k, v in {"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    scanned = []
    monkeypatch.setattr(tengine.AudioFileScanner, "scan_files_parallel",
                        lambda self, d: scanned.append(len(captured)) or [])
    (tmp_path / "in").mkdir()
    proc = tengine.DataProcessor(
        PipelineConfig(input_folder=str(tmp_path / "in"),
                       output_folder=str(tmp_path / "out")),
        asr_engine=object(), sentiment_analyzer=object(), device="cpu")
    try:
        proc.run()
    finally:
        proc.close()
    (kw,) = captured
    assert (kw["init_method"], kw["world_size"], kw["rank"],
            kw["backend"]) == ("env://", 2, 1, "gloo")
    assert scanned == [1]


def _calls(root: Path, n: int = 8) -> list:
    from audio_processor_tpu_torch.io import wav

    inp = root / "input"
    inp.mkdir()
    rng = np.random.default_rng(0)
    stems = [f"call-{i}" for i in range(n)]
    for s in stems:
        call = make_stereo_call(dur=3.0) + 0.05 * rng.standard_normal(
            (2, 48000)).astype(np.float32)
        wav.write(inp / f"{s}.wav", call, 16000)
    return stems


def _csv_rows(out: Path) -> dict:
    rows = {}
    for path in out.glob("optimized_results_*.csv"):
        with open(path, newline="", encoding="utf-8") as f:
            for r in csv.DictReader(f):
                rows[r["file_name"]] = r
    return rows


def test_two_cli_processes_shard_the_calls(tmp_path):
    from audio_processor_tpu import config as jconfig
    from audio_processor_tpu.pipeline.engine import (
        DataProcessor as JaxProcessor,
    )
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.models.checkpoint import (
        load_or_convert_w2v_bert,
    )
    from audio_processor_tpu_torch.pipeline.engine import DataProcessor

    from tests.test_torch_hf_checkpoint import _save_w2v

    stems = _calls(tmp_path)
    _save_w2v(tmp_path / "asr")
    load_or_convert_w2v_bert(tmp_path / "asr")     # the ranks restore it
    settings = {
        "input_folder": str(tmp_path / "input"),
        "logs_folder": str(tmp_path / "logs"),
        "transcription_model": str(tmp_path / "asr"),
        "enable_mixed_precision": False, "chunk_duration_sec": 4.0,
        "overlap_sec": 1.0, "length_buckets_sec": [2.0, 4.0],
        "chunk_batch_size": 4, "file_batch_size": 2,
        "save_csv_results": True}
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(json.dumps(settings))
    init = launch.file_init_method(tmp_path)
    launch.run_ranks(
        lambda r: launch.python_argv(
            "audio_processor_tpu_torch.cli", "--config", str(cfg_path),
            "--save-mode", "csv", "--device", "cpu", "--no-minio-sync",
            "--output", str(tmp_path / f"out_{r}")), 2, 240,
        env=lambda r: launch.rank_env(r, 2, {
            "JAX_COORDINATOR_ADDRESS": init, "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(r), "MIN_FREE_DISK_GB": "0",
            "OMP_NUM_THREADS": "2"}),
        cwd=str(REPO))

    expected = {r: {s for s in stems if zlib.crc32(s.encode()) % 2 == r}
                for r in range(2)}
    assert expected[0] and expected[1]
    got = {}
    for r in range(2):
        done = {p.stem for p in
                (tmp_path / f"out_{r}" / "processed_markers").glob("*.done")}
        assert done == expected[r], (r, done)
        got.update(_csv_rows(tmp_path / f"out_{r}"))

    one = DataProcessor(PipelineConfig.from_dict(
        {**settings, "output_folder": str(tmp_path / "out_one")}),
        device="cpu")
    try:
        assert one.run() == 8
    finally:
        one.close()
    want = _csv_rows(tmp_path / "out_one")
    jax_proc = JaxProcessor(jconfig.PipelineConfig.from_dict(
        {**settings, "output_folder": str(tmp_path / "out_jax")}))
    try:
        assert jax_proc.run() == 8
    finally:
        jax_proc.close()
    jax_rows = _csv_rows(tmp_path / "out_jax")
    assert set(got) == set(want) == set(jax_rows) and len(got) == 8
    for key, w in want.items():
        for field in ("transcription_chunk", "agent_transcription",
                      "client_transcription", "error"):
            assert got[key][field] == w[field] == jax_rows[key][field], \
                (key, field)
