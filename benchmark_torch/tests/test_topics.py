"""The topics cell (``harness/batch_topics.py``) on the CPU at a tiny size,
the readers of ``metrics/_topics_counts.py`` and the five topic LM metrics
on its spans, the faults its comparison must catch (a latent cache read
one position off; a router that ignores the correction bias; an LM that
fails) and its control (fp8 latents), and the plain reference's imports. On the card,
``control.py`` reads the control at full size (PERF.md).

    python -m pytest benchmark_torch/tests/test_topics.py -q
"""

from __future__ import annotations

import ast
import importlib
import shutil
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch

import _tiny

CELL = "topics.calls3m-pcm16k"
# The topic LM and its vocabulary cut as well as the encoder (_tiny's cut),
# so the CPU runs the cell in seconds; the special ids moved into the
# smaller vocabulary; transcripts and glossary shortened (``run``), so
# prompts are a few hundred tokens.
TINY_LM = dict(vocab_size=4096, hidden_size=64, intermediate_size=128,
               moe_intermediate_size=32, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=3,
               bos_token_id=4000, eos_token_id=4001, user_token_id=4003,
               assistant_token_id=4004)
METRICS = Path(__file__).resolve().parents[1] / "metrics"
# The attention's wide weights at the tiny widths: peaked scores, so that a
# cache fault moves the logits here too.
TINY_WIDE_STD = 0.3
# The largest relative MSE of one decode step's logits at the tiny widths:
# 3 bf16 layers 64 wide read 2.6e-4-5.2e-4 on sound runs (seeds 7-9) and
# 2.0e-2 with the cache read one position off, where sound runs at the
# published widths read at most 2.6e-4 and the fault 4.3e-4 (PERF.md): the
# cell's limit is too tight here.
TINY_STEP_LIMIT = 2e-3


def run(seed=7, trace=False, control=False, max_new=6):
    from benchmark_torch.harness import batch_topics

    tmp = Path(tempfile.mkdtemp(prefix="bench-topics-"))
    wide, batch_topics.WIDE_STD = batch_topics.WIDE_STD, TINY_WIDE_STD
    try:
        job = _tiny.tiny_job(CELL, tmp, seed=seed, trace=trace,
                             control=control)
        job.limits = dict(job.limits, topic_step_rel_mse_max=TINY_STEP_LIMIT)
        an = job.config["analyzers"]
        topics = dict(an["topics"], words_per_chunk=[3, 6],
                      categories=an["topics"]["categories"][:2],
                      types=an["topics"]["types"][:2], explanation_words=5)
        job.config = dict(job.config, **TINY_LM, pipeline=dict(
            job.config["pipeline"], max_tokens_summary=max_new),
            analyzers=dict(an, topics=topics))
        job.t_process = time.perf_counter()
        driver = importlib.import_module(
            f"benchmark_torch.harness.{job.generator.DRIVER}")
        return driver.run(job), job
    finally:
        batch_topics.WIDE_STD = wide
        shutil.rmtree(tmp, ignore_errors=True)


def _over(r):
    return {k for k, v in r["checks"].items() if v["value"] > v["limit"]}


def test_a_sound_run_is_correct_and_every_call_has_topics():
    r, job = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    for k in ("topic_logit_rel_mse", "topic_not_argmax", "route_mismatch",
              "topics_missing"):
        assert k in r["checks"]
    assert r["checks"]["topics_missing"]["value"] == 0
    assert r["checks"]["topic_logit_rel_mse"]["value"] < 1e-3
    assert job.readings["route_decisions"] > 0


def test_a_latent_cache_read_one_position_off(monkeypatch):
    from audio_processor_tpu_torch.models import moe_lm

    orig = moe_lm.LatentAttention.decode

    def off_by_one(self, x, cos, sin, cache, pos, visible):
        return orig(self, x, cos, sin, cache, pos,
                    visible & (torch.arange(visible.shape[1])[None]
                               < pos[:, None]))

    monkeypatch.setattr(moe_lm.LatentAttention, "decode", off_by_one)
    r, _ = run()
    assert not r["correct"] and {"topic_logit_rel_mse",
                                 "topic_step_rel_mse_max"} <= _over(r), \
        r["checks"]


def test_a_router_without_its_correction_bias(monkeypatch):
    from audio_processor_tpu_torch.models import moe_lm

    def unbiased(self, x):
        s = torch.nn.functional.linear(x.float(),
                                       self.gate.weight.float()).sigmoid()
        idx = torch.topk(s, self.cfg.num_experts_per_tok, dim=-1).indices
        w = s.gather(1, idx)
        w = w / w.sum(-1, keepdim=True)
        return idx, w * self.cfg.routed_scaling_factor

    monkeypatch.setattr(moe_lm.MoE, "route", unbiased)
    r, _ = run()
    assert not r["correct"] and "route_mismatch" in _over(r), r["checks"]


def test_a_failing_lm_leaves_topics_missing_and_its_checks_failed(
        monkeypatch):
    """An LM whose class pass raises: every call's ``topics`` is left
    empty, so ``topics_missing`` counts them, and the sample lacks the
    class taps, so the topic LM checks fail too. The program's stand-in
    answers are among what ``topics_missing`` counts."""
    from audio_processor_tpu_torch.host import topics
    from audio_processor_tpu_torch.models import moe_lm
    from benchmark_torch.harness import batch_topics

    assert {f"{c} - {t}" for _, c, t in (
        topics.FAILED, topics.CONFIG_ERROR, topics.NOT_AVAILABLE)} | {""} \
        == batch_topics.NO_ANSWER
    generate = moe_lm.MoELM.generate

    def failing(self, prompts, max_new, kind="summary"):
        if kind == "class":
            raise RuntimeError("CUDA out of memory")
        return generate(self, prompts, max_new, kind)

    monkeypatch.setattr(moe_lm.MoELM, "generate", failing)
    r, _ = run()
    over = _over(r)
    assert r["checks"]["topics_missing"]["value"] >= 1, r["checks"]
    assert {"topics_missing", "topic_logit_rel_mse", "topic_step_rel_mse_max",
            "topic_not_argmax", "route_mismatch"} <= over, r["checks"]


def test_the_control_with_fp8_latents_is_not_correct():
    """The control: every cached latent rounded to fp8 e4m3."""
    r, _ = run(control=True)
    assert not r["correct"] and "topic_logit_rel_mse" in _over(r), \
        r["checks"]


def test_the_topic_metrics_read_a_traced_run():
    """The five per-layer readers on a CPU run's spans, with a stand-in
    trace that puts 1 ms of card time under every launch the spans'
    threads made; a stand-in ``topics.graph`` span of 5 steps (the CPU
    decodes eagerly) whose 5 graph launches each ran 3 kernels and a
    copy."""
    from audio_processor_tpu_torch.obs import profiler

    spec = importlib.util.spec_from_file_location(
        "bench_topics_counts", METRICS / "_topics_counts.py")
    counts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(counts)
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        t0 = time.perf_counter()
        r, job = run(max_new=4)
        with profiler.span("topics.graph", rows=2, capacity=512, steps=5):
            time.sleep(0.01)
        t1 = time.perf_counter()
        got = [s for s in profiler.spans() if s.id not in seen]
    assert r["correct"], r["checks"]
    pre = [s for s in got if s.name == "topics.prefill"]
    dec = [s for s in got if s.name == "topics.decode"]
    assert pre and dec and all(s.attrs["lengths"] for s in pre)
    events, launches = [], []
    for i, s in enumerate(pre + dec):
        mid = (s.t0 + s.t1) / 2e3            # us on the host's clock
        launches.append({"tid": s.tid, "ts": mid,
                         "args": {"correlation": i}})
        events.append({"ts": mid, "dur": 1000.0,
                       "args": {"correlation": i}})
    graph = next(s for s in got if s.name == "topics.graph")
    for i in range(5):
        c = 100 + i
        ts = graph.t0 / 1e3 + (i + 1) * (graph.t1 - graph.t0) / 6e3
        launches.append({"tid": graph.tid, "ts": ts,
                         "args": {"correlation": c}})
        events += [{"ts": ts, "dur": 1.0, "cat": cat,
                    "args": {"correlation": c}}
                   for cat in ("kernel", "kernel", "kernel", "gpu_memcpy")]
    trace = SimpleNamespace(t0=t0 * 1e6, launches=launches, device=events)
    run_ = SimpleNamespace(trace=trace, tracing_window=[t0, t1], job=job)
    mods = {n: _load(n) for n in ("topics.device_ms_per_call",
                                  "topics.prefill_mfu",
                                  "topics.decode_hbm_roofline",
                                  "topics.padded_token_share",
                                  "topics.kernels_per_step")}
    vals = {n: m.read(run_) for n, m in mods.items()}
    calls = sum(s.attrs["calls"] for s in got if s.name == "topics.batch")
    assert vals["topics.device_ms_per_call"] == (
        1.0 * (len(pre) + len(dec)) / calls)
    flops = sum(counts.prefill_flops(job.config, s.attrs["lengths"])
                for s in pre)
    assert abs(vals["topics.prefill_mfu"]
               - 100 * flops / (len(pre) * 1e-3 * 989e12)) < 1e-9
    bound = sum(counts.decode_bound_s(job.config, s.attrs["steps"],
                                      s.attrs["lengths"],
                                      s.attrs["experts_touched"])
                for s in dec)
    assert abs(vals["topics.decode_hbm_roofline"]
               - 100 * bound / (len(dec) * 1e-3)) < 1e-9
    assert vals["topics.padded_token_share"] == 0.0
    assert vals["topics.kernels_per_step"] == 3.0
    assert counts.device_s(SimpleNamespace(trace=None, tracing_window=[
        t0, t1]), "topics.decode") is None


def test_published_counts():
    """At Moonlight-16B-A3B's widths: 4.49 GFLOP a token through the
    products (6 of 64 routed experts), and a decode step of 8 rows that
    touches 34 experts a layer reads ≈ 17.8 GB."""
    spec = importlib.util.spec_from_file_location(
        "bench_topics_counts", METRICS / "_topics_counts.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    m = _tiny.Spec(_tiny.ROOT).config(
        _tiny.Spec(_tiny.ROOT).cell(CELL))
    assert abs(c.token_flops(m) / 4.49e9 - 1) < 0.01
    t = c.decode_bound_s(m, 1, [1] * 8, 34 * 26)
    assert abs(t * c._counts.HBM_BYTES_S / 17.8e9 - 1) < 0.01


def test_the_reference_imports_nothing_of_the_port():
    path = Path(__file__).resolve().parents[1] / "reference" / "moonlight.py"
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    assert mods <= {"__future__", "contextlib", "typing", "torch",
                    "torch.nn.functional"}, mods


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
