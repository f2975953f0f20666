"""The Kimi-Linear cell (``harness/batch_kimi.py``) on the CPU at a tiny
size: a sound run, the two controls its comparison must catch (the KDA
state held in bf16; a state pass that skips a chunk's decay), the readers
of ``metrics/_kimi_counts.py`` and the five new metrics on canned spans
and on a run's spans, the counts at the published widths, and the plain
reference's imports. On the card, ``control_kimi.py`` reads the program
and both controls at full size (PERF.md).

    python -m pytest benchmark_torch/tests/test_kimi.py -q
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import itertools
import shutil
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import _tiny

CELL = "kimi.calls3m-pcm16k"
METRICS = Path(__file__).resolve().parents[1] / "metrics"
# The hybrid at tiny widths (Kimi's key names): KDA, KDA, KDA, NoPE MLA,
# the first layer dense, 8 of 16 experts held; the special ids moved into
# the smaller vocabulary.
TINY_LM = dict(
    vocab_size=4096, hidden_size=64, intermediate_size=128,
    moe_intermediate_size=32, num_hidden_layers=4, num_attention_heads=4,
    num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, num_experts=8,
    expert_parallel={"router_experts": 16, "first_expert": 0},
    num_experts_per_token=4, num_shared_experts=1,
    linear_attn_config={"kda_layers": [1, 2, 3], "full_attn_layers": [4],
                        "num_heads": 2, "head_dim": 16,
                        "short_conv_kernel_size": 4},
    bos_token_id=4000, eos_token_id=4001, user_token_id=4003,
    assistant_token_id=4004)
TINY_WIDE_STD = 0.3          # as test_topics.py's, for the MLA layer
# At these widths the sound bf16 program's one-step logit error is larger
# than at the published widths (PERF.md): test_topics.py's limit.
TINY_STEP_LIMIT = 2e-3


def run(seed=7, trace=False, control=None, max_new=6):
    from benchmark_torch.harness import batch_kimi

    tmp = Path(tempfile.mkdtemp(prefix="bench-kimi-"))
    wide, batch_kimi.WIDE_STD = batch_kimi.WIDE_STD, TINY_WIDE_STD
    try:
        job = _tiny.tiny_job(CELL, tmp, seed=seed, trace=trace,
                             control=control is not None)
        if control:
            job.mix = dict(job.mix, control=control)
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
        batch_kimi.WIDE_STD = wide
        shutil.rmtree(tmp, ignore_errors=True)


def _over(r):
    return {k for k, v in r["checks"].items() if v["value"] > v["limit"]}


def test_a_sound_run_is_correct_and_every_call_has_topics():
    r, job = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["topics_missing"]["value"] == 0
    assert r["checks"]["kda_state_rel_mse"]["value"] < 1e-4
    assert job.readings["route_decisions"] > 0


@pytest.mark.parametrize("control", ["bf16_state", "skip_decay"])
def test_each_control_fails_a_limit(control):
    """The bf16 state and the skipped decay each move the KDA states after
    the prefill past ``kda_state_rel_mse``'s limit."""
    r, _ = run(control=control)
    assert not r["correct"] and "kda_state_rel_mse" in _over(r), \
        r["checks"]


def test_the_driver_leaves_the_topics_driver_as_it_was():
    from audio_processor_tpu_torch.models import kda
    from benchmark_torch.harness import batch_kimi, batch_topics

    before = (batch_topics.build_lm, batch_topics.check_topics,
              kda.state_pass, kda.KimiDeltaAttention.decode)
    job = SimpleNamespace(control=True, mix={"control": "bf16_state"},
                          say=lambda msg: None)
    with batch_kimi._patched(job):
        assert batch_topics.build_lm is batch_kimi.build_lm
        assert kda.state_pass is not before[2]
    assert (batch_topics.build_lm, batch_topics.check_topics,
            kda.state_pass, kda.KimiDeltaAttention.decode) == before
    with pytest.raises(ValueError, match="control"):
        with batch_kimi._patched(SimpleNamespace(
                control=True, mix={"control": "fp4"}, say=print)):
            pass


_ids = itertools.count(1)


def _span(name, t_s, **attrs):
    from audio_processor_tpu_torch.obs import profiler

    t = int(t_s * 1e9)
    return profiler.Span(name, t, t + 1000, 1, 1, next(_ids), None, attrs)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_t_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _published():
    spec = _tiny.Spec(_tiny.ROOT)
    return spec.config(spec.cell(CELL))


def test_fused_mixer_share_on_canned_spans(monkeypatch):
    """27 mixers a step: 7 MLA attention launches and 20 KDA launches per
    step read 100; half the KDA steps eager reads less; spans without
    ``kda_launches`` (the parent) read nothing."""
    from audio_processor_tpu_torch.obs import profiler

    spans = [_span("topics.graph", 5.0, steps=9, mla_launches=63,
                   kda_launches=180),                       # before
             _span("topics.graph", 11.0, steps=199, mla_launches=7 * 199,
                   kda_launches=20 * 199, mode="replay"),
             _span("topics.graph", 12.0, steps=2, mla_launches=14,
                   kda_launches=20, mode="eager")]
    monkeypatch.setattr(profiler, "spans", lambda: list(spans))
    reader = _load("kimi.fused_mixer_share")
    run_ = SimpleNamespace(tracing_window=[10.0, 20.0],
                           job=SimpleNamespace(config=_published()))
    assert reader.read(run_) == pytest.approx(
        100.0 * (27 * 199 + 34) / (27 * 201))
    spans[:] = spans[1:2]
    assert reader.read(run_) == pytest.approx(100.0)
    spans[:] = [_span("topics.graph", 11.0, steps=199, mla_launches=27 * 199,
                      mode="replay")]
    assert reader.read(run_) is None


def test_kda_roofline_on_canned_spans_and_trace(monkeypatch):
    """The KDA kernel's bound over its launches at each span's rows, scaled
    to the trace's launches, over their trace time; nothing without a
    trace or a count."""
    from audio_processor_tpu_torch.obs import profiler

    m = _published()
    counts = _load("_kimi_counts")
    spans = [_span("topics.graph", 11.0, steps=199, rows=8,
                   kda_launches=20 * 199, mla_launches=7 * 199),
             _span("topics.graph", 12.0, steps=2, rows=3, kda_launches=40,
                   mla_launches=14)]
    monkeypatch.setattr(profiler, "spans", lambda: list(spans))
    kernel_s = 0.05
    trace = SimpleNamespace(
        kernel_s=lambda name: (kernel_s, 20 * 201)
        if name == "kda_decode_kernel" else (0.0, 0))
    reader = _load("kda.decode_roofline")
    run_ = SimpleNamespace(tracing_window=[10.0, 20.0], trace=trace,
                           job=SimpleNamespace(config=m))
    bound = (20 * 199 * counts.kda_launch_bound_s(m, 8)
             + 40 * counts.kda_launch_bound_s(m, 3))
    assert reader.read(run_) == pytest.approx(100 * bound / kernel_s)
    assert reader.read(SimpleNamespace(tracing_window=[10.0, 20.0],
                                       trace=None, job=run_.job)) is None
    spans[:] = [_span("topics.graph", 11.0, steps=199, rows=8,
                      mla_launches=27 * 199)]
    assert reader.read(run_) is None


def test_published_counts():
    """At Kimi-Linear-48B-A3B's widths with 128 of 256 experts held: ≈ 4.0
    GFLOP a token through the products (4 of a token's 8 routed copies
    held on average), a KDA decode launch over 8 rows moves ≈ 35 MB
    (10.5 us at 3.35 TB/s), and a decode step of 8 rows touching 10 held
    experts a layer (the stand-in's overlapping routing) moves ≈ 7.6 GB:
    3.3 GB of weights outside the routed experts, 3.7 GB of experts and
    0.7 GB of KDA state read and written."""
    m = _published()
    c = _load("_kimi_counts")
    assert abs(c.token_flops(m) / 3.99e9 - 1) < 0.01
    assert abs(c.kda_launch_bound_s(m, 8) * 1e6 / 10.52 - 1) < 0.01
    t = c.decode_bound_s(m, 1, [1] * 8, 10 * 26)
    assert abs(t * c._counts.HBM_BYTES_S / 7.63e9 - 1) < 0.01
    # the chunkwise form's operations per token lie near the recurrence's
    # 7 per state element and head, plus the intra-chunk pairs
    per_token = c.kda_chunk_flops(m, 64 * 60) / (64 * 60)
    assert 32 * 6 * 128 * 128 < per_token < 32 * 12 * 128 * 128


def test_the_kimi_metrics_read_a_traced_run():
    """The readers on a CPU run's spans, with a stand-in trace that puts
    1 ms of card time under every launch the spans' threads made, and a
    stand-in ``topics.graph`` span whose step graph ran the KDA kernel."""
    from audio_processor_tpu_torch.obs import profiler

    c = _load("_kimi_counts")
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        t0 = time.perf_counter()
        r, job = run(max_new=4)
        with profiler.span("topics.graph", rows=2, capacity=512, steps=5,
                           mla_launches=5, kda_launches=15):
            time.sleep(0.01)
        t1 = time.perf_counter()
        got = [s for s in profiler.spans() if s.id not in seen]
    assert r["correct"], r["checks"]
    kp = [s for s in got if s.name == "topics.kda_prefill"]
    pre = [s for s in got if s.name == "topics.prefill"]
    dec = [s for s in got if s.name == "topics.decode"]
    assert kp and pre and dec
    assert all(s.attrs["layer"] in (0, 1, 2) and s.attrs["chunks"] >= 1
               for s in kp)
    events, launches = [], []
    for i, s in enumerate(kp + pre + dec):
        # a prefill's own launch at its start, before its KDA layers'
        mid = (s.t0 + s.t1) / 2e3 if s in kp else s.t0 / 1e3 + 1e-3
        launches.append({"tid": s.tid, "ts": mid,
                         "args": {"correlation": i}})
        events.append({"ts": mid, "dur": 1000.0, "cat": "kernel",
                       "name": "k", "args": {"correlation": i}})
    trace = SimpleNamespace(t0=t0 * 1e6, launches=launches, device=events,
                            kernel_s=lambda name: (1e-3, 15)
                            if name == "kda_decode_kernel" else (0.0, 0))
    run_ = SimpleNamespace(trace=trace, tracing_window=[t0, t1], job=job)
    vals = {n: _load(n).read(run_) for n in (
        "kda.prefill_ms_per_call", "kimi.prefill_mfu",
        "kimi.decode_hbm_roofline", "kimi.fused_mixer_share",
        "kda.decode_roofline")}
    calls = sum(s.attrs["calls"] for s in got if s.name == "topics.batch")
    # a kda_prefill span nests inside its prefill: both hold its launch
    assert vals["kda.prefill_ms_per_call"] == pytest.approx(
        1.0 * len(kp) / calls)
    flops = sum(c.prefill_flops(job.config, s.attrs["lengths"]) for s in pre)
    inside = len(pre) + len(kp)
    assert vals["kimi.prefill_mfu"] == pytest.approx(
        100 * flops / (inside * 1e-3 * 989e12))
    bound = sum(c.decode_bound_s(job.config, s.attrs["steps"],
                                 s.attrs["lengths"],
                                 s.attrs["experts_touched"]) for s in dec)
    assert vals["kimi.decode_hbm_roofline"] == pytest.approx(
        100 * bound / (len(dec) * 1e-3))
    assert vals["kimi.fused_mixer_share"] == pytest.approx(
        100 * 20 / (4 * 5))
    assert vals["kda.decode_roofline"] == pytest.approx(
        100 * 15 * c.kda_launch_bound_s(job.config, 2) / 1e-3)


def test_the_reference_imports_nothing_of_the_port():
    path = Path(__file__).resolve().parents[1] / "reference" / \
        "kimi_linear.py"
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(("." * node.level) + (node.module or ""))
    assert mods <= {"__future__", "typing", "torch", "torch.nn.functional",
                    ".moonlight"}, mods
