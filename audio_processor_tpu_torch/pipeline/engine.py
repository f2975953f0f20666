"""Pipeline engine: scan -> batch -> decode -> ASR -> sentiment -> persist
(port of pipeline/engine.py).

The reference's DataProcessor, copied: a host-side prefetcher decodes
and chunks the next file batch while the device runs the current one
and a single analysis worker persists the one before (producer/
consumer, batch order kept), with idempotence markers + skip filter,
size-aware batching, per-file retries, intermediate JSONL artifacts,
run summary / failed-calls / per-file-status reports, streamed CSV
output, retention cleanup, memory watchdog and queue metrics.

What differs from the reference:

- ``setup_models`` builds the port's ASR engine and sentiment analyzer
  on an explicit torch device;
- ``_decode_one`` resamples through the port's ``prepare_and_split``;
- ``setup_models`` builds the engine over ``mesh`` (or the mesh that
  ``mesh_shape`` names: one replica per 'data' device of this process;
  on a CPU processor a virtual mesh of CPU replicas);
- under several processes (parallel/distributed.py), ``run`` joins the
  launch (if its caller has not) and keeps the calls this process owns
  by call-id hash, as the reference does.

The VAD message path (``enable_message_path`` with a database) runs as
in the reference: :meth:`DataProcessor._run_message_path`.
"""

from __future__ import annotations

import gc
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from audio_processor_tpu_torch.host.csv_writer import save_results_csv
from audio_processor_tpu_torch.io.decode import load_audio
from audio_processor_tpu_torch.io.scanner import AudioFileScanner
from audio_processor_tpu_torch.obs import profiler
from audio_processor_tpu_torch.pipeline.batching import create_file_batches
from audio_processor_tpu_torch.pipeline.chunker import prepare_and_split
from audio_processor_tpu_torch.pipeline.markers import (
    ProcessedMarkers, cleanup_old_artifacts,
)

logger = logging.getLogger(__name__)


class MemoryManager:
    """Blocks batch submission above the memory threshold
    (reference: pipeline.py:33-53)."""

    def __init__(self, max_memory_gb: float,
                 threshold_percent: float = 80.0):
        self.max_memory_bytes = max_memory_gb * 1024 ** 3
        self.threshold = threshold_percent / 100.0

    def check_memory(self) -> bool:
        try:
            import psutil

            return psutil.virtual_memory().used < \
                self.max_memory_bytes * self.threshold
        except ImportError:
            return True

    def wait_for_memory(self, timeout: int = 60) -> None:
        start = time.time()
        while not self.check_memory() and time.time() - start < timeout:
            time.sleep(1)
            gc.collect()


class DataProcessor:
    def __init__(self, config, db_manager=None, asr_engine=None,
                 sentiment_analyzer=None, topic_classifier=None,
                 monitor=None, device="cuda", mesh=None):
        self.config = config
        self.db_manager = db_manager
        self.asr_engine = asr_engine
        self.sentiment_analyzer = sentiment_analyzer
        self.topic_classifier = topic_classifier
        self.monitor = monitor
        self.device = torch.device(device)
        self.mesh = mesh

        self.memory_manager = MemoryManager(
            float(config.get("max_memory_gb", 64.0)),
            float(config.get("memory_threshold_percent", 80)))
        self.file_scanner = AudioFileScanner(config)

        self.output_dir = Path(config.get("output_folder", "./output"))
        self.intermediate_dir = self.output_dir / "intermediate"
        self.markers = ProcessedMarkers(self.output_dir /
                                        "processed_markers")
        self.temp_dir = Path(config.get("temp_dir",
                                        "/tmp/audio_processing"))
        self.intermediate_dir.mkdir(parents=True, exist_ok=True)

        self.stats: Dict[str, Any] = {
            "files_processed": 0, "chunks_processed": 0, "errors": 0,
            "start_time": None, "files_success": 0, "files_failed": 0,
            "files_skipped": 0,
        }
        # Counters are read-modify-written from the device pool, the
        # analysis pool AND the sweep thread; unlocked `+=` can drop
        # increments and make the max_errors abort gate undercount.
        self._stats_lock = threading.Lock()
        self._file_statuses: List[Dict[str, Any]] = []
        self._file_latencies: List[float] = []
        self.failed_files: List[Dict[str, Any]] = []
        # Files that failed IN THIS PROCESS, keyed by path with the
        # (mtime, size) they failed at: watch-mode sweeps skip them
        # until the file changes on disk, so a directory of
        # permanently-bad files can't re-burn the per-sweep error
        # budget (and starve good files) every sweep. A process
        # restart retries everything — transient failures heal.
        self._failed_fingerprint: Dict[str, Any] = {}
        # Per-sweep baselines so watch-mode run summaries report THIS
        # sweep's work, not process-lifetime counters against a
        # single sweep's duration.
        self._sweep_stats_base: Dict[str, int] = {}
        self._sweep_latency_base = 0
        self._decode_pool: Optional[ThreadPoolExecutor] = None
        self._tuning_advice: Optional[Dict[str, Any]] = None
        self._all_results: List[Dict[str, Any]] = []
        self._queue_depths = {"decode_queue": 0, "device_queue": 0,
                              "result_queue": 0}
        # Current decode prefetch future (look-ahead fill metric).
        self._next_decode_fut = None
        self.max_retries = int(config.get("max_retries", 3))
        self.io_workers = int(config.get("io_workers", 32))
        # Overlap batch N+1's device dispatch with batch N's result
        # fetch/analysis (see _asr_stage). Device hangs then surface
        # at the analysis-stage timeout instead of the device-stage
        # one — still bounded, one batch later.
        self._async_fetch = bool(config.get("async_device_fetch", True))
        # Max dispatched-but-unanalyzed batches: each holds its
        # decoded waveforms (~tens of MB) plus device result buffers,
        # so the async window must be bounded.
        self._max_inflight = max(1, int(
            config.get("max_inflight_batches", 3)))
        # Files whose batch is still executing on an abandoned
        # (timed-out) worker: the next --watch sweep must not pick
        # them up concurrently (they have no marker yet).
        self._in_flight: set = set()
        self._in_flight_lock = threading.Lock()
        # Single-worker analysis executor, persistent across sweeps:
        # batch order for markers/CSV/stats is preserved because every
        # analysis runs here — including the late analysis of a batch
        # whose device future timed out and was abandoned (it is
        # re-submitted to this pool when the abandoned worker finally
        # completes, instead of running inline on that worker's
        # thread and racing the current sweep).
        self._analysis_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="analysis")
        # Streaming CSV writer state (save_csv_results): rows are
        # appended at the end of every analysis stage instead of
        # accumulating in RAM for the whole run — at full throughput a
        # 24 h --watch sweep would otherwise hold ~1M chunk rows.
        self._csv_stream = None
        # Guards open/append/close of the CSV stream: the sweep's
        # main thread closes it (end of run()) while a late analysis
        # of a timed-out batch may still be appending on the analysis
        # worker.
        self._csv_lock = threading.Lock()
        # Dispatched-but-incomplete device futures (current + any
        # abandoned-after-timeout), for the device_queue metric.
        # Updated from the sweep thread AND abandoned-future done
        # callbacks, so read-modify-writes take the lock.
        self._device_inflight = 0
        self._device_inflight_lock = threading.Lock()
        # Spans without a profiler (obs/profiler.py); sweeps are numbered
        # so each file batch's spans carry (sweep, batch index).
        self._record_spans = bool(config.get("enable_tracing", False))
        self._sweeps = 0

    # ------------------------------------------------------------------

    def _bump(self, key: str, n: int = 1):
        """Thread-safe stats counter increment (device pool, analysis
        pool and the sweep thread all write these)."""
        with self._stats_lock:
            self.stats[key] += n

    def _mark_failed_file(self, fp, err: str) -> None:
        """Shared failure bookkeeping: .failed marker, stats, status
        row, and the in-process fingerprint that lets later sweeps
        skip the file until it changes on disk."""
        self.markers.mark_failed(fp, err)
        self._bump("files_failed")
        self._file_statuses.append(
            {"file": str(fp), "status": "failed", "error": err})
        try:
            st = Path(fp).stat()
            self._failed_fingerprint[str(fp)] = (st.st_mtime,
                                                 st.st_size)
        except OSError:
            self._failed_fingerprint[str(fp)] = None

    def _skip_as_failed(self, f) -> bool:
        """True when this file already failed in this process and is
        unchanged on disk since."""
        fp = self._failed_fingerprint.get(str(f))
        if fp is None:
            return str(f) in self._failed_fingerprint
        try:
            st = Path(f).stat()
        except OSError:
            return True
        if (st.st_mtime, st.st_size) != fp:
            del self._failed_fingerprint[str(f)]   # changed: retry
            return False
        return True

    def setup_models(self):
        """Build the device engines lazily."""
        if self.asr_engine is None:
            from audio_processor_tpu_torch.pipeline.asr_engine import (
                ASREngine,
            )

            if self.mesh is None and self.config.get("mesh_shape"):
                from audio_processor_tpu_torch.parallel.multi_device import (
                    MultiDeviceManager,
                )

                self.mesh = MultiDeviceManager(
                    self.config, device=self.device).mesh
            self.asr_engine = ASREngine(self.config, device=self.device,
                                        mesh=self.mesh)
        if self.sentiment_analyzer is None:
            from audio_processor_tpu_torch.pipeline.sentiment import (
                SentimentAnalyzer,
            )

            self.sentiment_analyzer = SentimentAnalyzer(
                self.config, db_manager=self.db_manager,
                topic_classifier=self.topic_classifier, device=self.device)
        elif self.db_manager is not None:
            self.sentiment_analyzer.set_database_manager(self.db_manager)

    def get_queue_metrics(self) -> Dict[str, int]:
        d = dict(self._queue_depths)
        # Decode look-ahead fill, sampled live: 1 when the prefetched
        # next batch is fully decoded and waiting on the device stage.
        fut = self._next_decode_fut
        d["decode_ready"] = int(fut is not None and fut.done())
        return d

    # ------------------------------------------------------------------
    def _decode_one(self, file_path: Path, preloaded=None,
                    t_start: Optional[float] = None, parent=None):
        """Decode + resample + chunk one call, with retries; ``t_start``
        stamps the start of this file's decode for its latency, ``parent``
        is its batch's decode span."""
        if t_start is None:
            t_start = time.perf_counter()
        last_error: Optional[Exception] = None
        for attempt in range(1, self.max_retries + 1):
            try:
                if preloaded is not None and attempt == 1:
                    waveform, sr = preloaded
                else:
                    waveform, sr = load_audio(file_path)
                with profiler.span("chunker.prepare", parent=parent,
                                   call=file_path.stem):
                    waveform, sr, chunks = prepare_and_split(
                        waveform, sr, file_path.name, self.config)
                if not chunks:
                    raise RuntimeError("no_chunks")
                return {"file": file_path, "chunks": chunks,
                        "duration": waveform.shape[-1] / sr,
                        "waveform": waveform, "t_start": t_start}
            except Exception as e:
                last_error = e
                logger.warning("Attempt %d/%d failed for %s: %s",
                               attempt, self.max_retries, file_path, e)
                time.sleep(min(5, attempt) * 0.01)
        logger.error("All %d attempts failed for %s: %s",
                     self.max_retries, file_path, last_error)
        return {"file": file_path, "chunks": [], "duration": 0.0,
                "error": str(last_error), "waveform": None,
                "t_start": t_start}

    def _decode_batch(self, files: Sequence[Path], batch=None,
                      parent=None) -> List[Dict]:
        """Decode a file batch. WAVs go through the native C++ batch
        reader in one GIL-free call (io/native.py); everything else
        (OGG, fallback, retries) uses the per-file thread pool.
        ``batch`` (sweep, index) and ``parent`` (the sweep's span) tag the
        ``engine.decode`` span; its end is stamped on each call as
        ``decoded_ns`` while spans record."""
        files = [Path(f) for f in files]
        with profiler.span("engine.decode", parent=parent, batch=batch,
                           calls=len(files)) as sp:
            # per-file latency clock starts HERE: the native batch read
            # below is the bulk of decode I/O for WAVs, and _decode_one's
            # own stamp would miss it for preloaded files
            t_batch_start = time.perf_counter()
            preloaded: Dict[str, tuple] = {}
            wavs = [f for f in files if f.suffix.lower() == ".wav"]
            if wavs:
                try:
                    from audio_processor_tpu_torch.io import native

                    if native.available():
                        with profiler.span("io.native_read",
                                           files=len(wavs)):
                            read = native.read_wav_batch(
                                wavs, n_threads=min(self.io_workers, 16))
                        for f, out in zip(wavs, read):
                            if out is not None:
                                preloaded[str(f)] = out
                except Exception as e:
                    logger.debug("native batch read unavailable: %s", e)

            def decode(f: Path) -> Dict:
                return self._decode_one(f, preloaded.get(str(f)),
                                        t_start=t_batch_start
                                        if str(f) in preloaded else None,
                                        parent=sp)

            # Processor-lifetime pool (like _analysis_pool): a fresh
            # executor per batch paid thread spawn/join churn on the hot
            # prefetch path of every batch.
            if self._decode_pool is None:
                self._decode_pool = ThreadPoolExecutor(
                    max_workers=self.io_workers,
                    thread_name_prefix="decode")
            decoded = list(self._decode_pool.map(decode, files))
        if sp is not None:
            for d in decoded:
                d["decoded_ns"] = sp.t1
        return decoded

    # ------------------------------------------------------------------
    def process_file_batch(self, batch_id: int, files: Sequence[Path],
                           decoded: Optional[List[Dict]] = None) -> int:
        """Serial batch processing: ASR stage then analysis stage
        inline (the overlapped pipeline in process_files_parallel runs
        the two stages on separate workers)."""
        ctx = self._asr_stage(batch_id, files, decoded)
        if ctx is None:
            return 0
        return self._analysis_stage(ctx)

    def _asr_stage(self, batch_id: int, files: Sequence[Path],
                   decoded: Optional[List[Dict]] = None, batch=None,
                   parent=None) -> Optional[Dict[str, Any]]:
        """Device stage: decode accounting + call rows + batched ASR.
        Returns the batch context for _analysis_stage, or None when the
        stage itself failed (already counted toward the error gate).
        ``batch`` and ``parent`` tag its spans as in _decode_batch."""
        with profiler.span("engine.device_stage", parent=parent,
                           batch=batch) as sp:
            if sp is not None and decoded and "decoded_ns" in decoded[0]:
                profiler.record("engine.queue.device",
                                decoded[0]["decoded_ns"], sp.t0,
                                parent=parent, batch=batch)
            logger.info("Processing batch %d with %d files",
                        batch_id + 1, len(files))
            batch_t0 = time.perf_counter()
            with self._in_flight_lock:
                self._in_flight.update(str(f) for f in files)
            try:
                if decoded is None:
                    decoded = self._decode_batch(files, batch)

                all_chunks = []
                batch_failed: Dict[str, str] = {}
                for d in decoded:
                    if not d["chunks"]:
                        err = d.get("error", "empty_chunks_after_retries")
                        batch_failed[str(d["file"])] = err
                        self.failed_files.append({
                            "filename": d["file"].name,
                            "path": str(d["file"]),
                            "error": err, "chunks": []})
                # Per-file failures count toward the abort gate, matching
                # the reference's per-task error accounting
                # (pipeline.py:409-427).
                self._bump("errors", len(batch_failed))
                for d in decoded:
                    if str(d["file"]) in batch_failed:
                        continue
                    all_chunks.extend(d["chunks"])

                # Async fetch split: dispatch the device work here (prep +
                # upload + enqueue, returns once queued) and hand the fetch
                # closure to the analysis stage — batch N+1's device
                # dispatch then overlaps batch N's fetch/decode/sentiment
                # instead of idling the chip behind host-side result
                # handling. Sync fallback for engines without
                # dispatch_chunks (tests, facades). files_processed is
                # counted in _analysis_stage when the outcome is known —
                # counting per ATTEMPT here double-counted batches whose
                # device fetch failed and retried next sweep.
                fetch = None
                results: List[Dict] = []
                if not all_chunks:
                    pass
                elif self._async_fetch and hasattr(self.asr_engine,
                                                   "dispatch_chunks"):
                    fetch = self.asr_engine.dispatch_chunks(all_chunks)
                else:
                    results = self.asr_engine.transcribe_chunks(all_chunks)
                    self._bump("chunks_processed", len(results))
                return {"batch_id": batch_id, "files": files,
                        "decoded": decoded, "results": results,
                        "fetch": fetch,
                        "batch_failed": batch_failed, "batch_t0": batch_t0,
                        "trace": (parent, batch, sp)}
            except Exception as e:
                logger.exception("Error processing batch %d: %s",
                                 batch_id + 1, e)
                self._bump("errors")
                with self._in_flight_lock:
                    self._in_flight.difference_update(str(f) for f in files)
                return None

    def _analysis_stage(self, ctx: Dict[str, Any]) -> int:
        """Host/analysis stage: sentiment + persistence + markers +
        reports for one batch. Runs on the analysis worker so the
        device stage of the NEXT batch overlaps it."""
        parent, batch, device_span = ctx.get("trace", (None, None, None))
        with profiler.span("engine.analysis", parent=parent, batch=batch,
                           audio_s=sum(d["duration"]
                                       for d in ctx["decoded"])) as sp:
            if sp is not None and device_span is not None:
                profiler.record("engine.queue.analysis", device_span.t1,
                                sp.t0, parent=parent, batch=batch)
            batch_id, files = ctx["batch_id"], ctx["files"]
            decoded, results = ctx["decoded"], ctx["results"]
            batch_failed = ctx["batch_failed"]
            try:
                fetch = ctx.get("fetch")
                if fetch is not None:
                    # Realize the async device results (see _asr_stage);
                    # by now the NEXT batch is usually already executing
                    # on the device behind this fetch.
                    try:
                        results = ctx["results"] = fetch()
                    except Exception as e:
                        logger.exception("Device fetch failed for batch "
                                         "%d: %s", batch_id + 1, e)
                        self._bump("errors")
                        # Batch-level device failure: mirror the sync
                        # path (an exception from transcribe_chunks makes
                        # _asr_stage return None — no markers, no success
                        # counts), so the files stay unmarked and retry
                        # on the next sweep instead of being silently
                        # marked processed with zero rows. Decode-failed
                        # files ARE marked failed first — re-decoding
                        # them next sweep would fail again and duplicate
                        # their failed_files entries.
                        marked = 0
                        for d in decoded:
                            err = batch_failed.get(str(d["file"]))
                            if err is not None:
                                self._mark_failed_file(d["file"], err)
                                marked += 1
                        self._bump("files_processed", marked)
                        return 0
                    self._bump("chunks_processed", len(results))
                # Per-chunk device errors (dispatch/fetch exceptions are
                # swallowed into rows with 'error' set,
                # asr_engine._fetch_pending): a file whose chunks carry
                # errors must fail, not be marked .done with empty
                # transcriptions — that would silently drop the file
                # forever and keep the max_errors gate blind to a dying
                # device (reference fails the whole file on any chunk
                # error, audio_processor.py:247-309).
                chunk_errors: Dict[str, str] = {}
                for r in results:
                    if r.get("error"):
                        chunk_errors.setdefault(r.get("file_name", ""),
                                                r["error"])
                if chunk_errors:
                    for d in decoded:
                        fp = str(d["file"])
                        err = chunk_errors.get(d["file"].name)
                        if err and fp not in batch_failed:
                            batch_failed[fp] = f"asr_chunk_error: {err}"
                            self.failed_files.append({
                                "filename": d["file"].name,
                                "path": fp,
                                "error": batch_failed[fp], "chunks": []})
                            self._bump("errors")
                    failed_names = {Path(f).name for f in batch_failed}
                    results = [r for r in results
                               if r.get("file_name") not in failed_names]
                # Call rows are written here, NOT on the device-stage
                # worker: a slow or reconnecting database must never stall
                # the next batch's device dispatch. They go in before the
                # sentiment stage so chunk rows always find their call row
                # (with the real duration, not the lazy NULL-duration row
                # _save_chunks_to_database would create).
                if self.db_manager is not None:
                    with profiler.span("engine.persist", what="calls"):
                        for d in decoded:
                            if str(d["file"]) in batch_failed:
                                continue
                            try:
                                self.db_manager.insert_call({
                                    "id_enregistrement": d["file"].stem,
                                    "duration_seconds": d["duration"],
                                    "topics": "",
                                    "emotion_client_globale": "",
                                    "ton_agent_global": ""})
                            except Exception as e:
                                logger.error("Failed to save call %s: %s",
                                             d["file"].stem, e)
                if self.config.get("save_intermediate_results", False) \
                        and results:
                    with profiler.span("engine.persist",
                                       what="intermediate"):
                        self._save_intermediate_transcriptions(batch_id,
                                                               results)

                if self.sentiment_analyzer is not None and results:
                    results = \
                        self.sentiment_analyzer.analyze_batch_sentiment(
                            results)
                if self.config.get("save_sentiment_analysis", False) \
                        and results:
                    with profiler.span("engine.persist",
                                       what="intermediate"):
                        self._save_chunks_analysis(batch_id, results)

                # Optional VAD message path (reference ships it disabled,
                # audio_processor.py:354-358).
                if self.config.get("enable_message_path", False) \
                        and self.db_manager is not None:
                    self._run_message_path(decoded)

                # Per-file status + markers.
                with profiler.span("engine.persist", what="markers"):
                    for d in decoded:
                        fp = d["file"]
                        err = batch_failed.get(str(fp))
                        if err is not None:
                            self._mark_failed_file(fp, err)
                        else:
                            self.markers.mark_processed(fp)
                            self._bump("files_success")
                            self._file_statuses.append(
                                {"file": str(fp), "status": "success"})
                self._bump("files_processed", len(files))

                if self.config.get("save_csv_results", False):
                    with profiler.span("engine.persist", what="csv"):
                        self._append_csv_rows(results)
                t_done = time.perf_counter()
                batch_seconds = t_done - ctx["batch_t0"]
                # Per-call latency: decode start (prefetch included) to
                # analysis completion for THAT file — files entering the
                # prefetcher at different times get different latencies,
                # so p50/p95 over them are meaningful (files without a
                # decode stamp fall back to batch residency).
                latencies = [t_done - d.get("t_start", ctx["batch_t0"])
                             for d in decoded]
                self._file_latencies.extend(
                    latencies if latencies
                    else [batch_seconds] * len(files))
                if sp is not None:
                    for d in decoded:
                        profiler.record(
                            "engine.call",
                            d.get("t_start", ctx["batch_t0"]) * 1e9,
                            t_done * 1e9, parent=parent, batch=batch,
                            call=d["file"].stem)
                if self.monitor is not None:
                    self.monitor.record_batch(
                        batch_id, num_files=len(files),
                        num_chunks=len(results),
                        seconds=batch_seconds,
                        audio_seconds=sum(d["duration"] for d in decoded))
                    for d, lat in zip(decoded, latencies):
                        self.monitor.record_file(d["file"].name, lat)
                return len(files) - len(batch_failed)
            except Exception as e:
                logger.exception("Error in analysis for batch %d: %s",
                                 batch_id + 1, e)
                self._bump("errors")
                return 0
            finally:
                with self._in_flight_lock:
                    self._in_flight.difference_update(
                        str(f) for f in files)

    def _run_message_path(self, decoded: List[Dict]) -> None:
        """VAD -> windows -> batched mono transcription -> message
        rows. Every channel of the batch goes through ONE multi-channel
        VAD call (all enqueued before any fetch), and the segments of
        EVERY file and both speakers through ONE transcription call, so
        a lone speaker's few windows do not pad a device batch alone."""
        from audio_processor_tpu_torch.pipeline.segmenter import (
            SpeechBatchTranscriber,
        )

        if not hasattr(self, "_transcriber"):
            self._transcriber = SpeechBatchTranscriber(
                self.config, asr_engine=self.asr_engine)
        segmenter = self._transcriber.segmenter
        sr = int(self.config.get("target_sample_rate", 16000))

        channels: List[tuple] = []       # (waveform, label)
        chan_files: List[str] = []       # parallel: owning file stem
        for d in decoded:
            if d.get("waveform") is None or not d["chunks"]:
                continue
            wf = np.asarray(d["waveform"])
            if wf.ndim == 1:
                wf = wf[None]
            agent = wf[0]
            client = wf[1] if wf.shape[0] > 1 else wf[0]
            channels.extend([(agent, "agent"), (client, "client")])
            chan_files.extend([d["file"].stem, d["file"].stem])

        all_segments: List[Dict] = []
        spans: List[tuple] = []     # (file_stem, start, count|None)
        if channels:
            per_channel = segmenter.get_speech_segments_multi(
                channels, sr)
            for i in range(0, len(per_channel), 2):
                a, b = per_channel[i], per_channel[i + 1]
                if a is None or b is None:
                    # VAD FAILED for this file (None) — distinct from
                    # no speech ([]): skip its refresh entirely so a
                    # transient error can't wipe the call's existing
                    # message rows via the idempotent delete+insert.
                    logger.error("VAD failed for %s; keeping existing "
                                 "message rows", chan_files[i])
                    self._bump("errors")
                    spans.append((chan_files[i], len(all_segments),
                                  None))
                    continue
                segs = a + b
                spans.append((chan_files[i], len(all_segments),
                              len(segs)))
                all_segments.extend(segs)

        if not any(count for _stem, _start, count in spans):
            return

        def insert_rows(stem: str, msgs: List[Dict]) -> None:
            messages = sorted(msgs, key=lambda m: m.get("start", 0.0))
            try:
                # idempotent refresh on reprocess (watch-mode retries,
                # cleared markers): replace the call's message set
                self.db_manager.delete_messages_by_id_enregistrement(
                    stem)
            except Exception as e:
                logger.error("Failed to clear messages for %s: %s",
                             stem, e)
            for i, m in enumerate(messages):
                try:
                    self.db_manager.insert_message({
                        "id_enregistrement": stem,
                        "text": m["text"], "speaker": m["speaker"],
                        "order_message": i + 1})
                except Exception as e:
                    logger.error("Failed to insert message %d for %s: %s",
                                 i + 1, stem, e)

        try:
            transcribed = segmenter.transcribe_segments_batched(
                all_segments, sr)
        except Exception as e:
            # Per-file isolation: one failed batched call must not drop
            # message rows for every file in the batch — retry each
            # file's segments separately so only the genuinely failing
            # file loses its messages.
            logger.error("Batched mono transcription failed (%s); "
                         "retrying per file", e)
            for stem, start, count in spans:
                if count is None:       # VAD failed: no refresh
                    continue
                try:
                    insert_rows(stem, segmenter.transcribe_segments_batched(
                        all_segments[start:start + count], sr))
                except Exception as e2:
                    logger.error("Mono transcription failed for %s: %s",
                                 stem, e2)
            return
        for stem, start, count in spans:
            if count is None:           # VAD failed: no refresh
                continue
            insert_rows(stem, transcribed[start:start + count])

    # ------------------------------------------------------------------
    def process_files_parallel(self, files: Sequence[Path]) -> int:
        logger.info("Starting processing of %d files", len(files))
        self.stats["start_time"] = datetime.now()
        # Per-sweep baselines: watch mode reuses one processor, so
        # the run summary must report this sweep's deltas, not
        # process-lifetime counters against one sweep's duration.
        with self._stats_lock:
            self._sweep_stats_base = {
                k: v for k, v in self.stats.items()
                if isinstance(v, int)}
        self._sweep_latency_base = len(self._file_latencies)

        with self._in_flight_lock:
            in_flight = set(self._in_flight)
        if in_flight:
            logger.warning("Skipping %d files still in flight on an "
                           "abandoned (timed-out) batch worker",
                           len(in_flight))
        filtered = [f for f in files
                    if not self.markers.is_processed(f)
                    and str(f) not in in_flight
                    and not self._skip_as_failed(f)]
        skipped = len(files) - len(filtered)
        if skipped:
            logger.info("Skipping %d already-processed/failed files",
                        skipped)
        self._bump("files_skipped", skipped)

        batches = create_file_batches(
            filtered,
            float(self.config.get("max_batch_size_mb", 23.0)),
            int(self.config.get("file_batch_size", 32)))
        if not batches:
            logger.info("No batches to process after filtering")
            return 0

        max_errors = int(self.config.get("max_errors", 10))
        # Error budget is per sweep, not per process lifetime: in
        # --watch mode a long-lived processor must not inherit old
        # sweeps' errors (reference aborts per run, pipeline.py:386).
        with self._stats_lock:
            errors_at_start = self.stats["errors"]
        timeout = int(self.config.get("timeout_seconds", 300))
        total_success = 0
        # Three overlapped stages, one worker each (producer/consumer,
        # SURVEY.md §2.2): decode batch N+1 on host while batch N runs
        # on device while batch N-1's sentiment/persistence runs on the
        # analysis worker. Device work runs on its own bounded future
        # so a hung dispatch counts as a timeout error instead of
        # blocking forever (reference bounds each batch future,
        # pipeline.py:409); the single-worker analysis pool preserves
        # batch order for markers/CSV/reports.
        prefetcher = ThreadPoolExecutor(max_workers=1)
        device_pool = ThreadPoolExecutor(max_workers=1)
        analysis_pool = self._analysis_pool
        analysis_futs: List = []

        def _late_analysis(f):
            # A device future abandoned after its timeout eventually
            # completed: its analysis (markers, in-flight cleanup,
            # stats) still runs on the SAME single-worker analysis
            # pool so batch ordering and single-threaded stats
            # mutation are preserved — never inline on whatever
            # thread finished the abandoned future.
            with self._device_inflight_lock:
                self._device_inflight -= 1
                self._queue_depths["device_queue"] = self._device_inflight
            if f.cancelled():
                # Queued-but-never-run future cancelled at pool
                # shutdown; f.exception() would RAISE CancelledError
                # inside this callback.
                return
            if f.exception() is None and f.result() is not None:
                try:
                    self._analysis_pool.submit(
                        self._analysis_stage, f.result())
                except RuntimeError:   # processor close()d since
                    logger.error("Late analysis dropped: pool closed")
        self._sweeps += 1
        sweep_no = self._sweeps
        with profiler.recording_spans(self._record_spans), \
                profiler.span("engine.sweep", sweep=sweep_no,
                              files=len(filtered),
                              batches=len(batches)) as sweep:
            try:
                next_decode = prefetcher.submit(
                    self._decode_batch, batches[0], (sweep_no, 0), sweep)
                self._next_decode_fut = next_decode
                for i, batch in enumerate(batches):
                    self.memory_manager.wait_for_memory()
                    # Backpressure on the async-fetch window: wait for the
                    # oldest pending analysis once max_inflight batches
                    # are dispatched but not yet analyzed.
                    pending_analysis = [f for f in analysis_futs
                                        if not f.done()]
                    if len(pending_analysis) >= self._max_inflight:
                        try:
                            with profiler.span("engine.backpressure",
                                               batch=(sweep_no, i)):
                                pending_analysis[0].result(timeout=timeout)
                        except FuturesTimeoutError:
                            # Flow control only — NOT an error: a slow
                            # analysis (e.g. first-sweep BERT compiles
                            # through a cold toolchain) is accounted once
                            # at the drain loop if it truly hangs;
                            # counting it here would double-count and
                            # turn warm-in into phantom errors.
                            logger.warning(
                                "Analysis backlog slow (>%ds); continuing "
                                "with a wider in-flight window", timeout)
                    try:
                        decoded = next_decode.result(timeout=timeout)
                    except FuturesTimeoutError:
                        logger.error("Batch %d decode exceeded %ds timeout",
                                     i + 1, timeout)
                        self._bump("errors")
                        decoded = None
                    self._queue_depths["decode_queue"] = max(
                        0, len(batches) - i - 1)
                    if i + 1 < len(batches):
                        next_decode = prefetcher.submit(
                            self._decode_batch, batches[i + 1],
                            (sweep_no, i + 1), sweep)
                        self._next_decode_fut = next_decode
                    else:
                        self._next_decode_fut = None
                    if decoded is not None:
                        fut = device_pool.submit(
                            self._asr_stage, i, batch, decoded,
                            (sweep_no, i), sweep)
                        with self._device_inflight_lock:
                            self._device_inflight += 1
                            self._queue_depths["device_queue"] = \
                                self._device_inflight
                        try:
                            ctx = fut.result(timeout=timeout)
                            with self._device_inflight_lock:
                                self._device_inflight -= 1
                                self._queue_depths["device_queue"] = \
                                    self._device_inflight
                        except FuturesTimeoutError:
                            logger.error(
                                "Batch %d device work exceeded %ds timeout",
                                i + 1, timeout)
                            self._bump("errors")
                            fut.add_done_callback(_late_analysis)
                            ctx = None
                        if ctx is not None:
                            analysis_futs.append(analysis_pool.submit(
                                self._analysis_stage, ctx))
                    self._queue_depths["result_queue"] = sum(
                        1 for f in analysis_futs if not f.done())
                    with self._stats_lock:
                        sweep_errors = (self.stats["errors"]
                                        - errors_at_start)
                    if sweep_errors >= max_errors:
                        logger.error("Aborting after %d errors this sweep",
                                     sweep_errors)
                        break
                    if (i + 1) % max(1, len(batches) // 10) == 0:
                        logger.info("Progress: %d/%d batches done",
                                    i + 1, len(batches))
                for i, f in enumerate(analysis_futs):
                    try:
                        total_success += f.result(timeout=timeout)
                    except FuturesTimeoutError:
                        logger.error("Analysis stage exceeded %ds timeout",
                                     timeout)
                        self._bump("errors")
            finally:
                # Don't join potentially-hung workers; leftover futures are
                # cancelled and abandoned threads finish (or not) on their
                # own without blocking the sweep. The analysis pool is the
                # processor-lifetime executor (late analyses of abandoned
                # batches land there) — it is NOT shut down per sweep.
                prefetcher.shutdown(wait=False, cancel_futures=True)
                device_pool.shutdown(wait=False, cancel_futures=True)
        self._consult_tuners()
        return total_success

    def _consult_tuners(self) -> None:
        """Consult the advisory tuners at sweep end when
        ``enable_auto_batch_size`` is set.

        Advisory ONLY (logged + surfaced in the run summary as
        ``tuning_advice``), never auto-applied: device batch shapes are
        static length buckets and the file batch size is chosen for
        padding geometry (see config.enable_auto_batch_size), so a
        wall-time-targeted halving/doubling would regress throughput.
        The reference never calls its tuner at all
        (performance_monitor.py:272-304).
        """
        self._tuning_advice = None
        if not self.config.get("enable_auto_batch_size", False) or \
                self.monitor is None:
            return
        cur_files = int(self.config.get("file_batch_size", 8))
        cur_workers = int(self.config.get("io_workers", 32))
        advice = {
            "file_batch_size": {
                "current": cur_files,
                "recommended": self.monitor.optimize_batch_size(cur_files),
            },
            "io_workers": {
                "current": cur_workers,
                "recommended":
                    self.monitor.optimize_worker_count(cur_workers),
            },
        }
        self._tuning_advice = advice
        for key, a in advice.items():
            if a["recommended"] != a["current"]:
                logger.info(
                    "Tuner advice: %s %d -> %d (advisory only; static "
                    "TPU shapes — not auto-applied)", key, a["current"],
                    a["recommended"])

    # ------------------------------------------------------------------
    def _save_intermediate_transcriptions(self, batch_id: int,
                                          results: List[Dict]) -> None:
        try:
            ts = datetime.now().strftime("%Y%m%d_%H%M%S")
            out = self.intermediate_dir / f"batch_{batch_id+1}_{ts}.jsonl"
            with open(out, "w", encoding="utf-8") as f:
                for c in results:
                    f.write(json.dumps({
                        "file_name": c.get("file_name", ""),
                        "chunk_idx": c.get("chunk_idx", 0),
                        "start_time": c.get("start_time", 0.0),
                        "end_time": c.get("end_time", 0.0),
                        "transcription_chunk":
                            c.get("transcription_chunk", ""),
                        "agent_transcription":
                            c.get("agent_transcription", ""),
                        "client_transcription":
                            c.get("client_transcription", ""),
                        "error": c.get("error", ""),
                    }, ensure_ascii=False) + "\n")
        except OSError as e:
            logger.warning("Failed to write intermediates for batch "
                           "%d: %s", batch_id + 1, e)

    def _save_chunks_analysis(self, batch_id: int,
                              results: List[Dict]) -> None:
        try:
            ts = datetime.now().strftime("%Y%m%d_%H%M%S")
            out = self.intermediate_dir / \
                f"batch_{batch_id+1}_chunks_analysis_{ts}.jsonl"
            with open(out, "w", encoding="utf-8") as f:
                for c in results:
                    f.write(json.dumps({
                        "file_name": c.get("file_name", ""),
                        "chunk_idx": c.get("chunk_idx", 0),
                        "agent_text_sentiment":
                            c.get("agent_text_sentiment", ""),
                        "agent_text_confidence":
                            c.get("agent_text_confidence", 0.0),
                        "agent_acoustic_sentiment":
                            c.get("agent_acoustic_sentiment", ""),
                        "agent_acoustic_confidence":
                            c.get("agent_acoustic_confidence", 0.0),
                        "agent_fusion_sentiment":
                            c.get("agent_fusion_sentiment", ""),
                        "agent_fusion_confidence":
                            c.get("agent_fusion_confidence", 0.0),
                        "client_text_sentiment":
                            c.get("client_text_sentiment", ""),
                    }, ensure_ascii=False) + "\n")
        except OSError as e:
            logger.warning("Failed to write sentiment intermediates for "
                           "batch %d: %s", batch_id + 1, e)

    def log_results(self) -> Dict[str, Path]:
        """Run summary / failed calls / per-file statuses
        (reference: pipeline.py:539-599)."""
        end_time = datetime.now()
        start = self.stats["start_time"] or end_time
        duration = (end_time - start).total_seconds()
        run_id = end_time.strftime("%Y%m%d_%H%M%S")
        self.output_dir.mkdir(parents=True, exist_ok=True)
        paths: Dict[str, Path] = {}

        # This sweep's deltas (watch mode reuses one processor; the
        # duration above is per-sweep, so the counters must be too).
        base = self._sweep_stats_base
        with self._stats_lock:
            sweep = {k: self.stats[k] - base.get(k, 0)
                     for k, v in self.stats.items()
                     if isinstance(v, int)}
        sweep_lat = self._file_latencies[self._sweep_latency_base:]

        summary = {
            "start_time": start.isoformat(),
            "end_time": end_time.isoformat(),
            "duration_seconds": duration,
            "files_processed": (sweep["files_processed"]
                                - sweep["files_failed"]),
            "chunks_processed": sweep["chunks_processed"],
            "errors": sweep["errors"],
            "files_success": sweep.get("files_success", 0),
            "files_failed": sweep.get("files_failed", 0),
            "files_skipped": sweep.get("files_skipped", 0),
            "p50_call_latency_seconds": (
                float(np.percentile(sweep_lat, 50))
                if sweep_lat else None),
            "p95_call_latency_seconds": (
                float(np.percentile(sweep_lat, 95))
                if sweep_lat else None),
            "config_snapshot": {
                "file_batch_size": self.config.get("file_batch_size", 8),
                "chunk_batch_size": self.config.get("chunk_batch_size", 16),
                "max_workers": self.config.get("max_workers", 32),
                "io_workers": self.config.get("io_workers", 32),
            },
            # Advisory tuner output (enable_auto_batch_size); see
            # _consult_tuners for why it is never auto-applied.
            "tuning_advice": self._tuning_advice,
        }
        paths["summary"] = self.output_dir / f"run_summary_{run_id}.json"
        paths["summary"].write_text(json.dumps(summary, indent=2))

        paths["failed"] = self.output_dir / f"failed_calls_{run_id}.json"
        paths["failed"].write_text(
            json.dumps({"failed": self.failed_files}, indent=2,
                       ensure_ascii=False))

        paths["statuses"] = self.output_dir / \
            f"file_statuses_{run_id}.json"
        paths["statuses"].write_text(
            json.dumps({"files": self._file_statuses}, indent=2))
        return paths

    def save_results(self, results: Optional[List[Dict]] = None) -> Path:
        return save_results_csv(
            results if results is not None else self._all_results,
            self.output_dir)

    # ------------------------------------------------------------------
    def _append_csv_rows(self, results: List[Dict]) -> None:
        """Stream result rows into the run's CSV (17-column reference
        schema) as each batch's analysis completes. Only ever called
        from the single-worker analysis pool, so writes are ordered
        and unsynchronized. The file is created lazily on the first
        row and closed by :meth:`_close_csv_stream` at the end of the
        sweep (one timestamped file per run, like the reference's
        end-of-run dump, pipeline.py:603-662 — but with O(batch)
        instead of O(run) memory)."""
        if not results:
            return
        import csv

        from audio_processor_tpu_torch.host.csv_writer import COLUMNS, _row

        with self._csv_lock:
            if self._csv_stream is None:
                self.output_dir.mkdir(parents=True, exist_ok=True)
                ts = datetime.now().strftime("%Y%m%d_%H%M%S")
                path = self.output_dir / f"optimized_results_{ts}.csv"
                fh = open(path, "w", newline="", encoding="utf-8")
                writer = csv.DictWriter(fh, fieldnames=COLUMNS)
                writer.writeheader()
                self._csv_stream = {"path": path, "fh": fh,
                                    "writer": writer}
            try:
                for r in results:
                    self._csv_stream["writer"].writerow(_row(r))
                self._csv_stream["fh"].flush()
            except (OSError, ValueError) as e:
                # ValueError: write on a file the sweep already
                # closed (late analysis past the close) — log, don't
                # let it count as an analysis-stage error.
                logger.error("Failed to stream CSV rows: %s", e)

    def _close_csv_stream(self) -> Optional[Path]:
        with self._csv_lock:
            stream, self._csv_stream = self._csv_stream, None
        if stream is None:
            return None
        try:
            stream["fh"].close()
        except OSError as e:
            logger.warning("Failed to close CSV stream: %s", e)
        return stream["path"]

    def close(self) -> None:
        """Release the persistent analysis worker and any open CSV
        stream. Idempotent; the processor is unusable afterwards."""
        self._close_csv_stream()
        self._analysis_pool.shutdown(wait=False, cancel_futures=True)
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=False, cancel_futures=True)
            self._decode_pool = None

    def cleanup_old_artifacts(self) -> int:
        return cleanup_old_artifacts(self.config, self.markers,
                                     self.temp_dir, self.intermediate_dir)

    # ------------------------------------------------------------------
    def run(self) -> int:
        logger.info("Starting audio processing on %s", self.device)
        # A launch of several processes is joined here if the caller has
        # not (a no-op otherwise), so no process of it runs every call.
        from audio_processor_tpu_torch.parallel.distributed import (
            initialize_distributed, owns_call, process_count, process_index,
        )

        initialize_distributed(
            backend="gloo" if self.device.type == "cpu" else None)
        self.setup_models()
        input_dir = Path(self.config.get("input_folder", "./input"))
        if not input_dir.exists():
            raise FileNotFoundError(
                f"Input directory {input_dir} does not exist")
        files = self.file_scanner.scan_files_parallel(input_dir)
        logger.info("Found %d valid audio files", len(files))
        # Under several processes each keeps the calls it owns by call-id
        # hash (parallel/distributed.owns_call): decode, device work, DB
        # writes, markers and reports are sharded with no coordination
        # beyond the hash, which stays stable across sweeps.
        if process_count() > 1:
            owned = [f for f in files if owns_call(f.stem)]
            logger.info("Multi-process shard: process %d/%d owns %d/%d "
                        "calls", process_index(), process_count(),
                        len(owned), len(files))
            files = owned
        # Run every chunk shape once OUTSIDE the timeout-bounded batch
        # loop (first-use costs must not read as a hung device).
        warmup = self.config.get("batch_warmup", True)
        if warmup and files and hasattr(self.asr_engine, "warmup"):
            t0 = time.perf_counter()
            n = self.asr_engine.warmup(all_buckets=(warmup == "all"))
            if n:
                logger.info("Warmup ran %d shape(s) in %.1fs",
                            n, time.perf_counter() - t0)
        total_success = self.process_files_parallel(files)
        self.log_results()
        self._close_csv_stream()
        logger.info("Processing completed: %d files succeeded",
                    total_success)
        return total_success
