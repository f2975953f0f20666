"""Driver of the serving cells: the program's HTTP server
(``serving.serve``) behind an open-loop client on the same machine.

Set-up (counted in ``setup_s``): the kernels, the weights and the production
stack as for the batch cells (the server persists nothing, so no database),
the pool of calls, every (bucket, device batch) shape and every text bucket
the requests can reach, then the server on a localhost port and two
requests through it.

Window: the mix's requests, each sent when it is due on the open-loop
schedule by a pool of client threads, whether or not earlier ones have
answered. A request's latency runs from when it was due to when its whole
response has arrived; one that fails or is refused counts as missing. The
window is the schedule's ``--seconds``; the run then waits for every
answer, a minute past the close at most. With ``--trace 1`` the profiler
records the first 5 s of the window.
"""

from __future__ import annotations

import gc
import http.client
import json
import math
import statistics
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, weights
from .batch import Run, build_engine, capture_sample
from .job import Job
from .spans import Recorder
from .trace import Trace

TRACE_S = 5.0
CLIENTS = 96
LATE_S = 60.0


def run(job: Job) -> Dict:
    dev = torch.device(job.device)
    cuda = dev.type == "cuda"
    from audio_processor_tpu_torch import serving

    m = dict(job.config["model"])
    root = job.tmp
    engine, pcfg, w_seed = build_engine(job, dev, root, extra={
        "serve_batch_window_ms": float(job.mix["batch_window_ms"])})
    rec = Recorder()
    runrec = Run(job, rec, m)
    analyzers = None
    if job.config.get("analyzers"):
        from . import prod

        analyzers = prod.setup(job, pcfg, dev, root, database=False)
        job.mark("text+heads")
    pool = job.generator.make_pool(job.mix, weights.sub_seed(
        job.seed, "traffic"), root / "pool", dev)
    job.mark("pool")
    by_name = {p["name"]: p for p in pool}
    wav = {p["name"]: Path(p["path"]).read_bytes() for p in pool}
    plan = job.generator.schedule(job.mix, weights.sub_seed(
        job.seed, "schedule"), job.seconds)
    for r in plan:
        r["pool"] = pool[r["call"]]["name"]
        r["file"] = f"{r['name']}-{r['pool']}"
        r["body"] = job.generator.body(wav[r["pool"]], r["file"])
    del wav
    sizes = sorted({engine.device_chunks, engine._tail_size(1),
                    engine._tail_size(max(1, engine.device_chunks // 2))})
    engine.warmup(all_buckets=True, tail_sizes=sizes)
    if analyzers:
        prod.warm(job, analyzers, [engine.device_chunks])
    server = serving.serve(pcfg, host="127.0.0.1", port=0,
                           asr_engine=engine,
                           sentiment_analyzer=analyzers["sentiment"]
                           if analyzers else None, device=dev)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="bench-http")
    thread.start()
    port = server.server_address[1]
    service = server.service
    for r in plan[:2]:
        _post(port, r["body"], True)
    if cuda:
        torch.cuda.synchronize()

    # ---- spans, counters and the sample ---------------------------------
    local = threading.local()
    chunk_owner: Dict[int, str] = {}
    sample = capture_sample(job, rec, runrec, engine,
                            lambda c: chunk_owner.get(id(c), c.file_name))

    def bytes_before(args, kwargs):
        local.name = job.generator.request_name(args[1])

    def submit_before(args, kwargs):
        name = getattr(local, "name", "")
        for c in args[1]:
            chunk_owner[id(c)] = name

    S = serving.InferenceService
    rec.wrap(S, "transcribe_bytes", "serve.request", bytes_before)
    rec.wrap(S, "submit_chunks", "serve.queue", submit_before)
    rec.wrap(S, "_process", "serve.batch")
    if analyzers:
        prod.wrap(job, rec, runrec, analyzers, [None, None],
                  name_of=lambda c: getattr(local, "name", c["file_name"]))

    job.mark("warm-up")
    setup_s = time.perf_counter() - job.t_process
    job.say(f"[setup] phases: {job.phases()}")
    job.say(f"[setup] {setup_s:.3f} s; pool {len(pool)} calls; "
            f"{len(plan)} requests at {job.mix['rate_per_s']}/s over "
            f"{job.seconds} s; shapes warmed {sorted(engine._warmed)}")

    # ---- window ----------------------------------------------------------
    done: Dict[str, Dict] = {}
    stats0 = service.snapshot_stats()
    prof, traced = None, False

    def send(r, t0):
        sent = time.perf_counter()
        status, payload = _post(port, r["body"], r["sentiment"])
        end = time.perf_counter()
        done[r["name"]] = {"status": status, "payload": payload,
                           "late": sent - (t0 + r["due"]),
                           "latency": end - (t0 + r["due"])}

    try:
        rec.on = True
        pool_ex = ThreadPoolExecutor(max_workers=CLIENTS,
                                     thread_name_prefix="bench-client")
        t0 = time.perf_counter()
        if job.trace:
            prof, runrec.trace_host_t0 = _start_profile(cuda, rec)
        futs = []
        for r in plan:
            wait = t0 + r["due"] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if prof is not None and not traced \
                    and time.perf_counter() - t0 >= TRACE_S:
                _stop_profile(prof, rec, cuda)
                traced = True
            futs.append(pool_ex.submit(send, r, t0))
        t_close = max(t0 + job.seconds, time.perf_counter())
        for f in futs:
            f.result(timeout=max(1.0, t_close + LATE_S - time.perf_counter()))
        t_end = time.perf_counter()
        if prof is not None and not traced:
            _stop_profile(prof, rec, cuda)
        rec.on = False
    finally:
        rec.restore()
        pool_ex.shutdown(wait=True, cancel_futures=True)
    stats1 = service.snapshot_stats()
    if prof is not None:
        out = job.tmp / "trace.json"
        prof.export_chrome_trace(str(out))
        try:
            runrec.trace = Trace.load(out, list(rec.spans),
                                      runrec.trace_host_t0)
        finally:
            out.unlink(missing_ok=True)
    runrec.window_s = t_end - t0
    runrec.serve_batches = stats1["batches"] - stats0["batches"]
    runrec.serve_chunks = stats1["chunks"] - stats0["chunks"]

    latencies, failed, rows = [], 0, {}
    for r in plan:
        d = done.get(r["name"])
        if d is None or d["status"] != 200:
            failed += 1
            latencies.append(math.inf)
            continue
        latencies.append(d["latency"])
        rows[r["file"]] = json.loads(d["payload"])["chunks"]
    late = [d["late"] for d in done.values()]
    job.say(f"[window] {runrec.window_s:.3f} s, requests {len(plan)}, "
            f"failed {failed}, device batches {runrec.serve_batches}, "
            f"chunks {runrec.serve_chunks}; generator late: mean "
            f"{statistics.mean(late) if late else 0:.6f} s, max "
            f"{max(late) if late else 0:.6f} s")
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # ---- close the server, free the program's state, compare ------------
    server.shutdown()
    service.close()
    server.server_close()
    thread.join(timeout=30)
    kept = prod.close(job, analyzers) if analyzers else None
    del server, service, engine, analyzers
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    attempted = [r["file"] for r in plan]
    checks = check.batch(
        job, m, vocab_list=job.config["vocab"],
        sample=sample["top"] + sample["other"], pool=by_name,
        attempted=attempted, rows=rows, pcfg=pcfg, device=dev,
        w_seed=w_seed, db_rows=None, kept=kept)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics: Dict[str, Dict] = {}
    if not job.trace:
        for e in job.end_to_end:
            v = None
            if e["name"] == "setup_s":
                v = setup_s
            elif e["name"] == "request_latency_p95_s":
                v = _p95(latencies)
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
    result = {"correct": bool(correct), "attempted": len(plan),
              "failed": failed, "metrics": metrics, "device": device}
    if job.trace and runrec.trace is not None:
        t = runrec.trace
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.idle_gaps()}
    third = max(1, len(latencies) // 3)
    job.readings["latency_first_third_s"] = _p95(latencies[:third]) or 0.0
    job.readings["latency_last_third_s"] = _p95(latencies[-third:]) or 0.0
    job.readings["request_latency_p95_s"] = _p95(latencies) or 0.0
    fin = sorted(x for x in latencies if math.isfinite(x))
    if fin:
        job.say(f"[latency] requests {len(fin)}, p50 "
                f"{statistics.median(fin):.4f} s, p95 {_p95(latencies):.4f}"
                f" s, max {fin[-1]:.4f} s")
    result["checks"] = checks
    return result


def _p95(latencies: List[float]) -> Optional[float]:
    """Nearest-rank 95th percentile; a missing request is infinitely
    late, so more than 5% missing gives no finite value (reported as
    1e30, which no bound admits)."""
    if not latencies:
        return None
    s = sorted(latencies)
    v = s[max(0, math.ceil(0.95 * len(s)) - 1)]
    return v if math.isfinite(v) else 1e30


def _post(port: int, body: bytes, sentiment: bool):
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request("POST", "/v1/transcribe" + ("?sentiment=1"
                                                     if sentiment else ""),
                         body=body, headers={"Content-Type": "audio/wav"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()
    except OSError as e:
        return -1, str(e).encode()


def _start_profile(cuda: bool, rec: Recorder):
    """Start the profiler and open the ``bench.window`` range; returns the
    profiler and the host time at which the range opened."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    prof._bench_range = torch.profiler.record_function("bench.window")
    prof._bench_range.__enter__()
    t = time.perf_counter()
    rec.tracing = cuda
    return prof, t


def _stop_profile(prof, rec: Recorder, cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()
    prof._bench_range.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    rec.tracing = False
