"""Spans of the port's batch pipeline (obs/profiler.py) on the CPU: what a
tiny ``DataProcessor`` sweep records with recording off, under the port's
``trace()``, under a bare ``torch.profiler`` and under ``enable_tracing``;
how the spans join on call and batch; each call's stage intervals against
its latency; the ranges in the exported Chrome trace; and the performance
report's ``stages`` section."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.host.db import DatabaseManager
from audio_processor_tpu_torch.io import native, wav
from audio_processor_tpu_torch.models import wav2vec2bert as w2v
from audio_processor_tpu_torch.models.tokenizer import CTCVocab
from audio_processor_tpu_torch.obs import monitor as monitor_mod
from audio_processor_tpu_torch.obs import profiler
from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
from audio_processor_tpu_torch.pipeline.engine import DataProcessor

CPU = torch.device("cpu")
# Every span of the batch path (io.native_read only where the native
# reader is built).
SPAN_NAMES = {
    "engine.sweep", "engine.decode", "io.native_read", "chunker.prepare",
    "engine.queue.device", "engine.backpressure", "engine.device_stage",
    "asr_engine.prep", "asr_engine.dispatch", "asr_fused",
    "engine.queue.analysis", "engine.analysis", "asr_engine.fetch_wait",
    "asr_engine.ctc_decode", "sentiment.text", "sentiment.acoustic",
    "sentiment.fusion", "engine.persist", "engine.call"}
RECORDED = {"engine.queue.device", "engine.queue.analysis", "engine.call"}
BATCH_SPANS = SPAN_NAMES - {"engine.sweep"}


def _expected_names():
    return SPAN_NAMES if native.available() else \
        SPAN_NAMES - {"io.native_read"}


@pytest.fixture(scope="module")
def engine():
    vocab = CTCVocab.darija_default()
    mcfg = w2v.W2VBertConfig(vocab_size=len(vocab), hidden_size=32,
                             num_hidden_layers=1, num_attention_heads=1,
                             intermediate_size=64,
                             conv_depthwise_kernel_size=7)
    cfg = _config(Path("."))
    return ASREngine(cfg, device=CPU, model=w2v.build_synthetic(mcfg, CPU),
                     vocab=vocab)


def _config(root: Path, **extra) -> PipelineConfig:
    return PipelineConfig.from_dict(dict(
        input_folder=str(root / "input"), output_folder=str(root / "out"),
        logs_folder=str(root / "logs"), temp_dir=str(root / "tmp"),
        enable_mixed_precision=False, chunk_duration_sec=4.0,
        overlap_sec=1.0, length_buckets_sec=(2.0, 4.0), chunk_batch_size=2,
        file_batch_size=2, max_batch_size_mb=100, save_csv_results=True,
        database_type="sqlite", max_inflight_batches=1, **extra))


def _processor(root: Path, engine, monitor=None, **extra):
    """A processor over four stereo calls in two file batches, whose
    analysis is slowed so the sweep waits on it (``engine.backpressure``)."""
    inp = root / "input"
    inp.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, dur in enumerate((5.0, 7.0, 6.0, 4.0)):
        wav.write(inp / f"call-{i}.wav",
                  0.1 * rng.standard_normal((2, int(16000 * dur))), 16000)
    cfg = _config(root, **extra)
    proc = DataProcessor(cfg, asr_engine=engine, device=CPU,
                         db_manager=DatabaseManager(cfg), monitor=monitor)
    proc.setup_models()
    sa = proc.sentiment_analyzer
    real = sa.analyze_batch_sentiment

    def slow(results):
        time.sleep(0.2)
        return real(results)

    sa.analyze_batch_sentiment = slow
    return proc, sorted(inp.glob("*.wav"))


def _sweep(root: Path, engine, under: str):
    """One sweep under the port's ``trace()`` or a bare profiler: (spans,
    the processor's call latencies, the trace's events, host time at which
    the trace's ``window`` range opened)."""
    proc, files = _processor(root, engine)
    profiler.clear()
    t_host0 = None
    try:
        if under == "trace":
            with profiler.trace(root / "profile"):
                # The first range of a trace pays the profiler's set-up
                # (about 1 ms) before its start is taken: not the anchor.
                with torch.profiler.record_function("first"):
                    pass
                with torch.profiler.record_function("window"):
                    t_host0 = time.perf_counter()
                    proc.process_files_parallel(files)
        else:
            acts = [torch.profiler.ProfilerActivity.CPU]
            with torch.profiler.profile(activities=acts):
                proc.process_files_parallel(files)
    finally:
        proc.close()
    events = []
    if under == "trace":
        (path,) = (root / "profile").glob("trace_*.json")
        events = json.loads(path.read_text())["traceEvents"]
    return profiler.spans(), list(proc._file_latencies), events, t_host0


@pytest.fixture(scope="module")
def swept(engine, tmp_path_factory):
    return {under: _sweep(tmp_path_factory.mktemp(under), engine, under)
            for under in ("trace", "bare")}


def test_off_records_nothing_and_opens_no_range(engine, tmp_path,
                                                monkeypatch):
    """With recording off a span is the shared null context, ``record``
    and a whole sweep leave the buffer empty, and no range is opened.
    The port has no ``annotate`` and none of the monitor's unread
    recommendation and memory-logging methods."""
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    proc, files = _processor(tmp_path, engine)
    profiler.clear()
    assert not profiler.recording()
    with profiler.span("x", batch=(0, 0)) as sp:
        assert sp is None
    profiler.record("y", 0, 1)
    assert profiler.current() is None
    try:
        assert proc.process_files_parallel(files) == 4
    finally:
        proc.close()
    assert profiler.spans() == [] and opened == []
    assert not hasattr(profiler, "annotate")
    for name in ("get_memory_recommendations",
                 "get_performance_recommendations",
                 "get_current_gpu_memory", "log_gpu_memory_status"):
        assert not hasattr(monitor_mod.PerformanceMonitor, name)


@pytest.mark.parametrize("under", ["trace", "bare"])
def test_a_sweep_records_every_span(swept, under):
    spans, latencies, _, _ = swept[under]
    assert {s.name for s in spans} == _expected_names()
    assert len(latencies) == 4
    assert sum(s.name == "engine.call" for s in spans) == 4
    persisted = {s.attrs["what"] for s in spans if s.name == "engine.persist"}
    assert {"calls", "chunks", "aggregates", "markers", "csv"} <= persisted
    assert not profiler.recording()


def test_spans_join_on_call_and_batch(swept):
    """``engine.call`` names its file stem; every span of a file batch
    carries the batch's (sweep, index) and a recorded parent, and every
    chain of parents ends at the sweep."""
    spans, _, _, _ = swept["bare"]
    by_id = {s.id: s for s in spans}
    (sweep,) = [s for s in spans if s.name == "engine.sweep"]
    assert sweep.attrs["files"] == 4 and sweep.attrs["batches"] == 2
    calls = [s for s in spans if s.name == "engine.call"]
    assert sorted(c.attrs["call"] for c in calls) == \
        [f"call-{i}" for i in range(4)]
    batches = set()
    for s in spans:
        if s.name not in BATCH_SPANS:
            continue
        sweep_no, index = s.attrs["batch"]
        assert sweep_no == sweep.attrs["sweep"] and index in (0, 1), s
        batches.add(index)
        p = s
        while p.parent is not None:
            p = by_id[p.parent]
            assert p.name == "engine.sweep" or \
                p.attrs["batch"] == s.attrs["batch"]
        assert p is sweep, s
    assert batches == {0, 1}
    by_batch = {}
    for c in calls:
        by_batch.setdefault(c.attrs["batch"], []).append(c.attrs["call"])
    assert sorted(len(v) for v in by_batch.values()) == [2, 2]


@pytest.mark.parametrize("under", ["trace", "bare"])
def test_stage_intervals_add_up_to_each_latency(swept, under):
    """decode (from the call's own start) + the device queue + the device
    stage + the analysis queue + the analysis stage = the call's latency
    within 1 ms, and the calls' latencies are the processor's."""
    spans, latencies, _, _ = swept[under]
    rows = profiler.call_stages(spans)
    assert len(rows) == 4
    for r in rows:
        assert all(r[k] >= 0 for k in profiler.CALL_STAGES), r
        assert abs(sum(r[k] for k in profiler.CALL_STAGES)
                   - r["latency"]) < 1e-3, r
    assert np.allclose(sorted(r["latency"] for r in rows), sorted(latencies),
                       atol=1e-3, rtol=0)


def test_trace_ranges_sit_on_the_span_threads(swept):
    """In the port's Chrome trace each span timed on one thread has a
    range of its name on that thread's native tid. Once host times are
    mapped onto the trace's clock through the ``window`` range, the range
    lies inside its span within 0.2 ms at either end, and ranges start
    0.2 ms or less after their spans in the median (one range can start
    later when its thread waits between the span's clock read and the
    range's, as on a loaded host)."""
    spans, _, events, t_host0 = swept["trace"]
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    (window,) = [e for e in ranges if e["name"] == "window"]
    off = float(window["ts"]) - t_host0 * 1e6
    starts = []
    for s in spans:
        if s.name in RECORDED:
            continue
        lo, hi = s.t0 / 1e3 + off, s.t1 / 1e3 + off
        inside = [float(e["ts"]) - lo for e in ranges
                  if e["name"] == s.name and e["tid"] == s.tid
                  and float(e["ts"]) >= lo - 200.0
                  and float(e["ts"]) + float(e["dur"]) <= hi + 200.0]
        assert inside, s
        starts.append(min(inside, key=abs))
    assert len(starts) >= 40
    assert abs(float(np.median(starts))) <= 200.0, sorted(starts)


def test_enable_tracing_records_without_a_profiler(engine, tmp_path):
    proc, files = _processor(tmp_path, engine, enable_tracing=True)
    profiler.clear()
    try:
        proc.process_files_parallel(files)
    finally:
        proc.close()
    assert {s.name for s in profiler.spans()} == _expected_names()
    assert len(profiler.call_stages(profiler.spans())) == 4
    assert not profiler.recording()


def test_report_stages_add_up(engine, tmp_path):
    """The performance report's ``stages``: per span name its count, total
    and self seconds (a parent's self time is its duration less what its
    children cover), and the per-call split at p50/p90."""
    mon = monitor_mod.PerformanceMonitor(_config(tmp_path), device=CPU)
    proc, files = _processor(tmp_path, engine, monitor=mon,
                             enable_tracing=True)
    profiler.clear()
    try:
        proc.process_files_parallel(files)
    finally:
        proc.close()
    spans = profiler.spans()
    stages = json.loads(mon.save_performance_report(tmp_path / "rep")
                        .read_text())["stages"]
    assert set(stages["spans"]) == _expected_names()
    for name, d in stages["spans"].items():
        mine = [s for s in spans if s.name == name]
        assert d["count"] == len(mine)
        assert d["total_s"] == pytest.approx(
            sum(s.t1 - s.t0 for s in mine) / 1e9)
        assert 0.0 <= d["self_s"] <= d["total_s"] + 1e-9
    leaves = RECORDED | {"asr_fused", "asr_engine.fetch_wait",
                         "engine.persist"}
    for name in leaves:
        d = stages["spans"][name]
        assert d["self_s"] == pytest.approx(d["total_s"])
    (an,) = [s for s in spans if s.name == "engine.analysis"
             and s.attrs["batch"][1] == 0]
    kids = [s for s in spans if s.parent == an.id]
    cover = profiler._cover([(s.t0, s.t1) for s in kids], an.t0, an.t1)
    assert 0 < cover <= an.t1 - an.t0
    assert stages["calls"] == 4
    lat = sorted(proc._file_latencies)
    split = stages["call_split_s"]
    assert split["latency"]["p50"] == pytest.approx(np.percentile(lat, 50),
                                                    abs=1e-3)
    assert sum(split[k]["p50"] for k in profiler.CALL_STAGES) > 0
