"""Driver of the batch cells: the program's ``DataProcessor`` sweeping a
pool of calls, as a cron sweep does, for the window.

Set-up (all counted in ``setup_s``): the port's kernels and native reader
are built (the first run of a checkout) or loaded, the weights are drawn on
the device from the seed, the pool is written, every (bucket, device batch)
shape the pool's sweeps dispatch is run once, and one file batch of the
pool is swept once through the whole pipeline.

Window: sweeps run back to back through
``DataProcessor.process_files_parallel``. Each sweep hard-links the pool
under fresh names into a new input folder, so the idempotence markers do
not skip it and the reads come from the page cache. The window closes at
the end of the first sweep that ends at or after ``--seconds``; fill and
drain of every sweep count. With ``--trace 1`` the first sweep runs under
``torch.profiler`` inside a ``bench.window`` range.

After the window the peak device memory is read, the processor is closed,
the program's state freed, and :mod:`.check` compares what the window
produced with the plain reference.
"""

from __future__ import annotations

import csv
import gc
import os
import random
import statistics
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, weights
from .job import Job
from .spans import Recorder
from .trace import Trace

SAMPLE_TOP = 2      # sampled device batches of the largest bucket
SAMPLE_OTHER = 1    # and of the other buckets


class Run:
    """What the per-layer readers see of one run."""

    def __init__(self, job: Job, rec: Recorder, model: Dict):
        self.job = job
        self.rec = rec
        self.model = model
        self.trace: Optional[Trace] = None
        self.traced_dispatches: List[Dict] = []
        self.dispatches: List[Dict] = []
        self.audio_s = 0.0
        self.window_s = 0.0
        self.decoded_audio_s = 0.0
        self.analysed_audio_s = 0.0
        self.tracing_window = [None, None]
        self.trace_host_t0 = 0.0
        self.serve_batches = 0
        self.serve_chunks = 0


def _pipeline_config(job: Job, root: Path, extra: Optional[Dict] = None):
    from audio_processor_tpu_torch.config import PipelineConfig

    raw = dict(job.config["pipeline"], **(extra or {}))
    raw.update({"input_folder": str(root / "in"),
                "output_folder": str(root / "out"),
                "logs_folder": str(root / "logs"),
                "temp_dir": str(root / "tmp")})
    return PipelineConfig.from_dict(raw)


def _model_dict(job: Job) -> Dict:
    return dict(job.config["model"])


def _chunk_bounds(n: int, chunk: int, step: int) -> List[Tuple[int, int]]:
    out, s = [], 0
    while n > 0 and s < n:
        e = min(s + chunk, n)
        out.append((s, e))
        if e >= n:
            break
        s += step
    return out


def _shapes(engine, pool: List[Dict], files_per_batch: List[List[str]],
            pcfg) -> set:
    """(bucket samples, device chunks) of every device batch that sweeping
    these file batches dispatches (the program's own bucketing rules)."""
    from audio_processor_tpu_torch.pipeline.chunker import pick_bucket

    sr = int(pcfg.target_sample_rate)
    chunk = int(pcfg.chunk_duration_sec * sr)
    step = chunk - int(pcfg.overlap_sec * sr)
    by_name = {p["name"]: p for p in pool}
    shapes = set()
    for names in files_per_batch:
        counts: Dict[int, int] = {}
        for nm in names:
            n = int(round(by_name[nm]["duration_s"] * sr))
            for s, e in _chunk_bounds(n, chunk, step):
                b = pick_bucket(e - s, engine.bucket_samples)
                counts[b] = counts.get(b, 0) + 1
        for b, c in counts.items():
            full, rest = divmod(c, engine.device_chunks)
            if full:
                shapes.add((b, engine.device_chunks))
            if rest:
                shapes.add((b, engine._tail_size(rest)))
    return shapes


def build_engine(job: Job, dev, root: Path, extra: Optional[Dict] = None):
    """Build (or load) the kernels, draw the ASR weights from the seed and
    put them into the port's model and ``ASREngine``: (engine, pipeline
    config, weight seed)."""
    from audio_processor_tpu_torch import _build
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.models.tokenizer import CTCVocab
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine

    job.mark("import")
    if dev.type == "cuda":
        _build.build_all(("flash_rel_attention",), native=True)
    job.mark("kernels")
    m = _model_dict(job)
    pcfg = _pipeline_config(job, root, extra)
    w_seed = weights.sub_seed(job.seed, "asr-weights")
    sd = weights.make(weights.w2v_bert_layout(m), w_seed, dev)
    with torch.device("meta"):
        model = w2v.Wav2Vec2Bert(w2v.W2VBertConfig(
            **{k: m[k] for k in (
                "vocab_size", "hidden_size", "num_hidden_layers",
                "num_attention_heads", "intermediate_size",
                "feature_projection_input_dim", "conv_depthwise_kernel_size",
                "left_max_position_embeddings",
                "right_max_position_embeddings", "layer_norm_eps",
                "pad_token_id")}))
    model.load_state_dict(sd, assign=True, strict=True)
    vocab = CTCVocab({t: i for i, t in enumerate(job.config["vocab"])})
    engine = ASREngine(pcfg, device=dev, model=model, vocab=vocab)
    job.mark("weights")
    return engine, pcfg, w_seed


def capture_sample(job: Job, rec: Recorder, run: Run, engine,
                   owner=None) -> Dict[str, List]:
    """Wrap the engine's host prep, dispatch, model and fetch: count the
    dispatched lengths, and keep a seeded reservoir of device batches
    (``SAMPLE_TOP`` of the largest bucket, ``SAMPLE_OTHER`` of the others)
    with the audio spans of their chunks and the ids, masks, logits and
    acoustic features the program served. ``owner(chunk)`` names a
    chunk's call (its file name by default)."""
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine

    owner = owner or (lambda c: c.file_name)
    pending_prep: Dict[int, List[int]] = {}
    pending_out: Dict[int, tuple] = {}
    local = threading.local()
    rng = random.Random(weights.sub_seed(job.seed, "sample"))
    seen = {"top": 0, "other": 0}
    sample: Dict[str, List] = {"top": [], "other": []}
    taken: Dict[str, set] = {"top": set(), "other": set()}
    top_bucket = max(engine.bucket_samples)

    def prep_after(out, args, kwargs, t0, t1):
        pending_prep[id(out[0])] = [int(x) for x in args[1].lengths]

    def model_after(out, args, kwargs, t0, t1):
        local.logits = out

    def run_fused_after(out, args, kwargs, t0, t1):
        buf, bucket = args[1], args[3]
        real = pending_prep.pop(id(buf), None)
        logits = getattr(local, "logits", None)
        local.logits = None
        if real is None:
            return
        d = {"bucket": int(bucket), "n_dev": int(buf.shape[0]),
             "real": real, "t": t0}
        run.dispatches.append(d)
        if run.tracing_window[0] is not None \
                and run.tracing_window[1] is None:
            run.traced_dispatches.append(d)
        key = "top" if int(bucket) == top_bucket else "other"
        k = SAMPLE_TOP if key == "top" else SAMPLE_OTHER
        seen[key] += 1                       # reservoir, decided here so
        slot = (len(sample[key]) + len(taken[key])   # only the sampled
                if len(sample[key]) + len(taken[key]) < k   # keep logits
                else rng.randrange(seen[key]))
        if slot < k:
            taken[key].add(slot)
            pending_out[id(out)] = (real, int(bucket), logits, key, slot)

    def fetch_after(out, args, kwargs, t0, t1):
        for sub_chunks, dev_out, err in args[2]:
            held = pending_out.pop(id(dev_out), None)
            if held is None:
                continue
            real, bucket, logits, key, slot = held
            taken[key].discard(slot)
            if err is not None:
                continue
            ids, mask, af = (np.concatenate([p[i].cpu().numpy()
                                             for p in dev_out])
                             for i in range(3))
            n = len(sub_chunks)
            item = {"bucket": bucket,
                    "chunks": [(owner(c), c.chunk_idx, c.start_time,
                                c.end_time) for c in sub_chunks],
                    "ids": ids[:3 * n], "mask": mask[:3 * n],
                    "af": af[:n], "lengths": real,
                    "logits": None if logits is None
                    else logits[:3 * n].float().cpu().numpy()}
            if slot < len(sample[key]):
                sample[key][slot] = item
            else:
                sample[key].append(item)

    E = ASREngine
    rec.wrap(E, "_prepare_fused_buffer", "asr_engine.prep", after=prep_after)
    rec.wrap(E, "_run_fused", "asr_engine.dispatch", after=run_fused_after)
    rec.wrap(E, "_fused", "asr_fused")
    rec.wrap(w2v.Wav2Vec2Bert, "forward", "encoder", after=model_after)
    rec.wrap(E, "_fetch_pending", "asr_engine.fetch", after=fetch_after)
    return sample


def _chunk_counts(pool: List[Dict], files_per_batch: List[List[str]],
                  pcfg) -> List[int]:
    """Chunks of each file batch."""
    by_name = {p["name"]: p for p in pool}
    return [sum(check.expected_chunks(by_name[nm]["samples"],
                                      by_name[nm]["sample_rate"], pcfg)
                for nm in names) for names in files_per_batch]


def _link_sweep(pool: List[Dict], folder: Path, prefix: str,
                names: Optional[List[str]] = None) -> List[Path]:
    folder.mkdir(parents=True)
    out = []
    for p in pool:
        if names is not None and p["name"] not in names:
            continue
        dst = folder / f"{prefix}-{p['name']}"
        os.link(p["path"], dst)
        out.append(dst)
    return sorted(out)


def run(job: Job) -> Dict:
    """One run of a batch cell; returns the result object."""
    dev = torch.device(job.device)
    cuda = dev.type == "cuda"
    from audio_processor_tpu_torch.pipeline import engine as engine_mod
    from audio_processor_tpu_torch.pipeline.chunker import Chunk
    from audio_processor_tpu_torch.pipeline.batching import (
        create_file_batches,
    )

    m = _model_dict(job)
    root = job.tmp
    rec = Recorder()
    runrec = Run(job, rec, m)
    pool_dir = root / "pool"

    # ---- set-up ------------------------------------------------------
    engine, pcfg, w_seed = build_engine(job, dev, root)
    analyzers = None
    if job.config.get("analyzers"):
        from . import prod

        analyzers = prod.setup(job, pcfg, dev, root, database=True)
        job.mark("text+heads")
    pool = job.generator.make_pool(job.mix, weights.sub_seed(
        job.seed, "traffic"), pool_dir, dev)
    job.mark("pool")
    by_name = {p["name"]: p for p in pool}
    batches = create_file_batches(
        [p["path"] for p in pool], float(pcfg.max_batch_size_mb),
        int(pcfg.file_batch_size))
    names_per_batch = [[Path(f).name for f in b] for b in batches]
    shapes = _shapes(engine, pool, names_per_batch, pcfg)
    for bucket, n in sorted(shapes):
        zeros = np.zeros(bucket, np.float32)
        engine.transcribe_chunks([Chunk("warmup.wav", i, 0.0, 0.0,
                                        agent=zeros, client=zeros)
                                  for i in range(n)])
    proc = engine_mod.DataProcessor(
        pcfg, device=dev, asr_engine=engine,
        sentiment_analyzer=analyzers["sentiment"] if analyzers else None,
        db_manager=analyzers["db"] if analyzers else None)
    proc.setup_models()
    if analyzers:
        prod.warm(job, analyzers, _chunk_counts(pool, names_per_batch, pcfg))
    smallest = min(names_per_batch, key=len)
    proc.process_files_parallel(
        _link_sweep(pool, root / "in" / "warm", "warm", smallest))
    if cuda:
        torch.cuda.synchronize()

    # ---- spans, counters and the sample for the comparison -----------
    starts: Dict[str, float] = {}
    done: Dict[str, float] = {}
    failed_calls: set = set()
    tracing_window = runrec.tracing_window

    def decode_before(args, kwargs):
        t = time.perf_counter()
        for f in args[1]:
            starts.setdefault(Path(f).name, t)

    def decode_after(out, args, kwargs, t0, t1):
        runrec.decoded_audio_s += sum(
            by_name[_pool_name(Path(f).name)]["duration_s"] for f in args[1])

    def analysis_after(out, args, kwargs, t0, t1):
        ctx = args[1]
        failed = ctx["batch_failed"]
        for d in ctx["decoded"]:
            nm = d["file"].name
            if str(d["file"]) in failed or not out:
                failed_calls.add(nm)
            else:
                done[nm] = t1
        runrec.analysed_audio_s += sum(
            by_name[_pool_name(d["file"].name)]["duration_s"]
            for d in ctx["decoded"])

    D = engine_mod.DataProcessor
    rec.wrap(D, "_decode_batch", "engine.decode", decode_before, decode_after)
    rec.wrap(D, "_analysis_stage", "engine.analysis", after=analysis_after)
    sample = capture_sample(job, rec, runrec, engine)
    if analyzers:
        prod.wrap(job, rec, runrec, analyzers, tracing_window)

    job.mark("warm-up")
    setup_s = time.perf_counter() - job.t_process
    job.say(f"[setup] phases: {job.phases()}")
    job.say(f"[setup] {setup_s:.3f} s; pool {len(pool)} calls, "
            f"{sum(p['duration_s'] for p in pool):.1f} audio s; file batches "
            f"{[len(b) for b in batches]}; shapes warmed {sorted(shapes)}")

    # ---- window ------------------------------------------------------
    attempted: List[str] = []
    prof = None
    try:
        rec.on = True
        t_start = time.perf_counter()
        k = 0
        while True:
            files = _link_sweep(pool, root / "in" / f"s{k:04d}", f"s{k:04d}")
            attempted += [f.name for f in files]
            if job.trace and k == 0:
                prof = _profile_sweep(proc, files, rec, tracing_window, cuda,
                                      runrec)
            else:
                proc.process_files_parallel(files)
            k += 1
            if time.perf_counter() - t_start >= job.seconds:
                break
        t_end = time.perf_counter()
        rec.on = False
    finally:
        rec.restore()
    window_s = t_end - t_start
    runrec.window_s = window_s
    completed = [nm for nm in attempted if nm in done
                 and nm not in failed_calls]
    runrec.audio_s = sum(by_name[_pool_name(nm)]["duration_s"]
                         for nm in completed)
    latencies = [done[nm] - starts[nm] for nm in completed if nm in starts]
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    job.say(f"[window] {window_s:.3f} s, {k} sweeps, calls attempted "
            f"{len(attempted)}, completed {len(completed)}, audio "
            f"{runrec.audio_s:.1f} s, device batches "
            f"{len(runrec.dispatches)}")

    # ---- the program's outputs, then its state freed ------------------
    proc.close()
    rows = _read_csv(root / "out")
    db_rows = prod.read_db(analyzers) if analyzers else None
    kept = prod.close(job, analyzers) if analyzers else None
    del proc, engine, analyzers
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- comparison with the reference -------------------------------
    checks = check.batch(
        job, m, vocab_list=job.config["vocab"],
        sample=sample["top"] + sample["other"], pool=by_name,
        attempted=attempted, rows=rows, pcfg=pcfg, device=dev,
        w_seed=w_seed, db_rows=db_rows, kept=kept)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    # ---- metrics -----------------------------------------------------
    metrics: Dict[str, Dict] = {}
    if not job.trace:
        for e in job.end_to_end:
            v = _end_to_end(e["name"], setup_s, window_s, runrec, latencies)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        for mt, reader in job.per_layer:
            v = reader.read(runrec)
            if v is not None:
                metrics[mt["name"]] = {"value": v, "unit": mt["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": len(attempted),
              "failed": len(attempted) - len(completed), "metrics": metrics,
              "device": device}
    if job.trace and runrec.trace is not None:
        t = runrec.trace
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.idle_gaps()}
    if len(latencies) >= 2:
        q = statistics.quantiles(latencies, n=10)
        job.say(f"[latency] calls {len(latencies)}, p50 "
                f"{statistics.median(latencies):.4f} s, p90 {q[8]:.4f} s, "
                f"max {max(latencies):.4f} s")
    result["checks"] = checks
    return result


def _profile_sweep(proc, files, rec, tracing_window, cuda, runrec):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    rec.tracing = cuda
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.window"):
            tracing_window[0] = time.perf_counter()
            proc.process_files_parallel(files)
            if cuda:
                torch.cuda.synchronize()
            tracing_window[1] = time.perf_counter()
    rec.tracing = False
    out = runrec.job.tmp / "trace.json"
    prof.export_chrome_trace(str(out))
    try:
        runrec.trace = Trace.load(out, list(rec.spans), tracing_window[0])
    finally:
        out.unlink(missing_ok=True)
    return prof


def _pool_name(name: str) -> str:
    """``s0003-call-005.wav`` -> ``call-005.wav``."""
    return name.split("-", 1)[1]


def _read_csv(out_dir: Path) -> Dict[str, List[Dict]]:
    rows: Dict[str, List[Dict]] = {}
    for path in sorted(out_dir.glob("optimized_results_*.csv")):
        with open(path, newline="", encoding="utf-8") as f:
            for r in csv.DictReader(f):
                rows.setdefault(r["file_name"], []).append(r)
    return rows


def _end_to_end(name: str, setup_s: float, window_s: float, run: Run,
                latencies: List[float]) -> Optional[float]:
    if name == "setup_s":
        return setup_s
    if name == "rtfx":
        return run.audio_s / window_s if window_s > 0 else None
    if name == "call_latency_p90_s":
        if len(latencies) < 2:
            return None
        return statistics.quantiles(latencies, n=10)[8]
    return None
