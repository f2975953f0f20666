"""Self-checks of the benchmark's pure parts, on the CPU.

    python -m pytest benchmark_torch/tests -q
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from _tiny import EXTRA_CELLS, ROOT, TINY_MODEL, TINY_TEXT  # sets sys.path
from benchmark_torch.harness import trace as trace_mod
from benchmark_torch.harness import weights
from benchmark_torch.harness.spec import Spec, load_module

BENCH = ROOT / "benchmark_torch"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _counts():
    return load_module(BENCH / "metrics" / "_counts.py", "bench_counts_t")


def _gen():
    return load_module(BENCH / "traffic" / "batch_sweep.py", "bench_gen_t")


# ---- BENCHMARK.json and resolution by name ------------------------------

def test_benchmark_json_keeps_to_its_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark_torch"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    layers = (ROOT / "PERF.md").read_text()
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert f"| {m['layer']} |" in layers   # PERF.md's list of layers
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in b["configs"]:
        assert c["file"].startswith("benchmark_torch/")
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_every_cell_resolves_its_pieces_by_name():
    spec = Spec(ROOT)
    for cell in spec.bench["workloads"] + list(EXTRA_CELLS.values()):
        config = spec.config(cell)
        assert config["name"] == cell["config"]
        mix = spec.mix(cell)
        gen = spec.generator(mix["kind"])
        assert (BENCH / "harness" / f"{gen.DRIVER}.py").exists()
        limits = spec.limits(cell)
        assert limits and all(v >= 0 for v in limits.values())
        if cell["name"] in EXTRA_CELLS:
            continue
        reported = spec.end_to_end(cell)
        assert any(m["name"] == "setup_s" for m in reported)
        assert len(reported) >= 2
        layers = spec.per_layer(cell)
        assert layers and all(callable(mod.read) for _, mod in layers)
        for m, _ in layers:   # a per-layer metric moves one this cell reports
            assert m["moves"] in {e["name"] for e in reported}


def test_weight_layout_is_the_ports_state_dict():
    from audio_processor_tpu_torch.models import bert as bert_mod
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v

    spec = Spec(ROOT)
    for cell in spec.bench["workloads"]:
        config = spec.config(cell)
        m = dict(config["model"], **TINY_MODEL)
        names = [n for n, _, _ in weights.w2v_bert_layout(m)]
        with torch.device("meta"):
            model = w2v.Wav2Vec2Bert(w2v.W2VBertConfig(
                vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
                num_hidden_layers=m["num_hidden_layers"],
                num_attention_heads=m["num_attention_heads"],
                intermediate_size=m["intermediate_size"]))
        sd = model.state_dict()
        assert sorted(names) == sorted(sd)
        assert all(tuple(sd[n].shape) == s
                   for n, s, _ in weights.w2v_bert_layout(m))
        if "text_model" in config:
            tm = dict(config["text_model"], **TINY_TEXT)
            with torch.device("meta"):
                bm = bert_mod.BertForSequenceClassification(
                    bert_mod.BertConfig(**{k: tm[k] for k in (
                        "vocab_size", "hidden_size", "num_hidden_layers",
                        "num_attention_heads", "intermediate_size",
                        "num_labels")}))
            want = {("bert." + n if not n.startswith("classifier") else n)
                    for n, _, _ in weights.bert_layout(tm)}
            assert want == set(bm.state_dict())


def test_weights_are_one_draw_per_seed():
    lay = weights.w2v_bert_layout(dict(
        Spec(ROOT).config(Spec(ROOT).bench["workloads"][0])["model"],
        **TINY_MODEL))
    a = weights.make(lay, 5, "cpu")
    b = weights.make(lay, 5, "cpu")
    c = weights.make(lay, 6, "cpu")
    k = "layers.0.ffn1.intermediate_dense.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert float(a["layers.0.ffn1_layer_norm.weight"].min()) == 1.0
    assert weights.sub_seed(2 ** 40 + 3, "x") != weights.sub_seed(3, "x")


# ---- traffic -------------------------------------------------------------

def _mix(encoding="pcm16", rate=16000):
    return {"kind": "batch_sweep", "pool_calls": 3, "encoding": encoding,
            "sample_rate": rate,
            "duration_s": {"dist": "lognormal", "median": 2.0, "sigma": 0.5,
                           "min": 1.0, "max": 4.0},
            "noise": 0.02, "tone": 0.3, "tone_hz": [120.0, 350.0],
            "turn_s": 1.5}


@pytest.mark.parametrize("encoding,rate", [("pcm16", 16000), ("ulaw", 8000)])
def test_traffic_from_a_seed_is_deterministic(encoding, rate):
    gen = _gen()
    mix = _mix(encoding, rate)
    with tempfile.TemporaryDirectory() as tmp:
        a = gen.make_pool(mix, 2 ** 33 + 1, Path(tmp) / "a", "cpu")
        b = gen.make_pool(mix, 2 ** 33 + 1, Path(tmp) / "b", "cpu")
        c = gen.make_pool(mix, 2 ** 33 + 2, Path(tmp) / "c", "cpu")
        for x, y in zip(a, b):
            assert x["path"].read_bytes() == y["path"].read_bytes()
        assert any(x["path"].read_bytes() != y["path"].read_bytes()
                   for x, y in zip(a, c))
        # every seed sweeps the same set of lengths, in another order
        assert sorted(p["duration_s"] for p in a) == \
            sorted(p["duration_s"] for p in c)
        x, r = gen.read_pcm(a[0]["path"])
        assert r == rate and x.shape == (2, a[0]["samples"])
        assert np.abs(x).max() <= 32768


def test_the_ports_wav_reader_reads_the_pool():
    from audio_processor_tpu_torch.io.wav import read as port_read

    gen = _gen()
    with tempfile.TemporaryDirectory() as tmp:
        for enc, rate in (("pcm16", 16000), ("ulaw", 8000)):
            pool = gen.make_pool(_mix(enc, rate), 11, Path(tmp) / enc, "cpu")
            x, r = gen.read_pcm(pool[1]["path"])
            y, r2 = port_read(pool[1]["path"])
            assert r == r2
            np.testing.assert_allclose(np.asarray(y, np.float64),
                                       x / 32768.0, atol=1e-6)


def test_ulaw_encoding_matches_g711():
    gen = _gen()
    # G.711 mu-law code words of a few 16-bit values (ITU-T G.711 table)
    x = torch.tensor([0, 1000, -1000, 32767, -32768]) / 32768.0
    codes = gen._ulaw_encode(x).tolist()
    assert codes == [0xFF, 0xCE, 0x4E, 0x80, 0x00]


# ---- operation and byte counts -------------------------------------------

def test_counts_against_hand_worked_shapes():
    c = _counts()
    m = {"hidden_size": 1024, "num_attention_heads": 16,
         "num_hidden_layers": 24, "intermediate_size": 4096,
         "conv_depthwise_kernel_size": 31, "feature_projection_input_dim": 160,
         "left_max_position_embeddings": 64,
         "right_max_position_embeddings": 8, "vocab_size": 78}
    assert c.encoder_frames(400000) == 1249     # a 25 s chunk
    assert c.encoder_frames(399) == 0
    ops, nbytes = c.relative_attention(m, 1000)
    assert ops == 16 * (4 * 1000 * 1000 * 64 + 2 * 1000 * 73 * 64)
    assert nbytes == 4 * 16 * 1000 * 64 * 2 + 73 * 64 * 2
    # one row of 1000 frames: operations bound it (4.1 GFLOP vs 8 MB)
    assert c.attention_bound_s(m, [1000]) == pytest.approx(ops / 989e12)
    per_frame = 2 * 2 * 2 * 1024 * 4096 + 4 * 2 * 1024 ** 2 \
        + 2 * 1024 * 2048 + 2 * 31 * 1024 + 2 * 1024 ** 2
    want = 24 * (per_frame * 1000 + ops) + 1000 * 2 * 160 * 1024 \
        + 1000 * 2 * 1024 * 78
    assert c.encoder_flops(m, 1000) == want
    assert want / 1000 == pytest.approx(1.26e9, rel=0.01)   # per frame
    frames = 1 + (400000 - 400) // 160
    assert c.frontend_flops(400000) == frames * (4 * 400 * 257 + 2 * 257 * 80)


# ---- the trace's arithmetic ----------------------------------------------

def _ev(cat, name, ts, dur, **kw):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": kw.pop("tid", 7)}
    if kw:
        e["args"] = kw
    return e


def test_idle_share_and_attribution_from_a_synthetic_trace():
    events = [
        _ev("user_annotation", "bench.window", 1000.0, 1000.0, tid=1),
        # two streams overlapping: union 1100-1400 and 1500-1600
        _ev("kernel", "kern_a", 1100.0, 200.0, correlation=1),
        _ev("kernel", "kern_b", 1200.0, 200.0, correlation=2),
        _ev("gpu_memcpy", "c", 1500.0, 100.0, correlation=3),
        _ev("kernel", "late", 1950.0, 100.0, correlation=4),  # clipped at 2000
        _ev("kernel", "before", 900.0, 50.0, correlation=9),  # outside
        # launches: thread 21 inside its span, thread 22 outside it
        _ev("cuda_runtime", "cudaStreamQuery", 1050.0, 1.0, tid=21),
        _ev("cuda_runtime", "cudaLaunchKernel", 1060.0, 2.0, tid=21,
            correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 1070.0, 2.0, tid=22,
            correlation=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1300.0, 2.0, tid=21,
            correlation=3),
    ]
    # host clock: window opened at host t = 5.0 s; the span 5.00005-5.0002
    spans = [("asr_fused", 5.00005, 5.0002, 0)]
    t = trace_mod.Trace(events, spans, host_t0=5.0)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((300 + 100 + 50) / 1e6)
    s, n = t.span_device_s("asr_fused")
    assert n == 1 and s == pytest.approx(200 / 1e6)   # kernel a only
    assert t.kernel_s("kern_a") == (pytest.approx(200 / 1e6), 1)
    gaps = dict(t.idle_gaps())
    assert sum(gaps.values()) == pytest.approx((1000 - 450) / 1e6)
    assert gaps["idle: asr_fused"] == pytest.approx(100 / 1e6)
    assert [name for name, _ in t.top_ops()][0] in ("kern_a", "kern_b")


def test_union_merges_overlaps():
    assert trace_mod.union([(3, 4), (0, 2), (1, 3), (6, 7)]) == \
        [(0, 4), (6, 7)]


# ---- the references import nothing of the program ------------------------

def test_reference_imports_no_kernel_of_the_port():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            for mod in mods:
                assert not mod.startswith(("audio_processor_tpu", "jax")), \
                    (path.name, mod)
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark_torch.reference.w2v_bert, "
            "benchmark_torch.reference.acoustic, "
            "benchmark_torch.reference.bert, benchmark_torch.reference.heads, "
            "benchmark_torch.reference.resample; "
            "bad = [m for m in sys.modules if m.startswith("
            "('audio_processor_tpu', 'jax'))]; print(bad); "
            "sys.exit(1 if bad else 0)") % str(ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_run_never_measures_the_cpu():
    """Without a card the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         Spec(ROOT).bench["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
