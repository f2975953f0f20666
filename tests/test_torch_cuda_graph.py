"""The encoder's CUDA graphs on the card (``Wav2Vec2Bert.forward``): a
replay gives the eager logits bit for bit, a replay's result is its own,
each replay counts the kernel launches its capture recorded, and the
profiler sees a replay's kernels under the graph launch that ran them.

Marked ``cuda``: every test skips without a card. This file imports no
JAX, so on the card it runs without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graph.py
"""

import json

import pytest
import torch

from audio_processor_tpu_torch.models import wav2vec2bert as tw
from audio_processor_tpu_torch.models.flash_rel_attention import (
    flash_rel_attention,
)
from audio_processor_tpu_torch.obs import profiler

pytestmark = pytest.mark.cuda

# 24 layers at the kernel's head size and small widths, and the
# published w2v-bert-2.0 widths (the W2VBertConfig defaults).
SMALL = dict(vocab_size=40, hidden_size=128, num_hidden_layers=24,
             num_attention_heads=2, intermediate_size=256)
FULL = dict(vocab_size=78)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, rows: int, frames: int, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, frames, 160, device=dev, generator=gen)
    valid = torch.randint(frames // 2, frames + 1, (rows,), device=dev,
                          generator=gen)
    mask = torch.arange(frames, device=dev)[None, :] < valid[:, None]
    return x, mask


def _model(dev, widths):
    return tw.build_synthetic(tw.W2VBertConfig(**widths), dev, seed=1)


def _modes(fn):
    """Run ``fn`` while spans record; the ``encoder.graph`` modes seen."""
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        out = fn()
        modes = [s.attrs.get("mode") for s in profiler.spans()
                 if s.id not in seen and s.name == "encoder.graph"]
    return out, modes


@pytest.mark.parametrize("widths, rows, frames", [
    (SMALL, 6, 512), (FULL, 48, 1280)], ids=["small", "full-48x1280"])
def test_replay_equals_eager_bit_for_bit(card, widths, rows, frames):
    model = _model(card, widths)
    x, mask = _inputs(card, rows, frames, 0)
    with torch.inference_mode():
        eager = model._encode(x, mask, torch.bfloat16, "flash_rel")
        outs, modes = _modes(lambda: [model(x, mask, dtype=torch.bfloat16)
                                      for _ in range(3)])
    assert modes == ["capture", "replay", "replay"]
    for out in outs:
        assert torch.equal(out, eager)


def test_a_replay_result_survives_the_next_replay(card):
    model = _model(card, SMALL)
    a, b = _inputs(card, 6, 512, 1), _inputs(card, 6, 512, 2)
    with torch.inference_mode():
        want_a = model._encode(*a, torch.bfloat16, "flash_rel")
        want_b = model._encode(*b, torch.bfloat16, "flash_rel")
        model(*a, dtype=torch.bfloat16)                     # capture
        got_a = model(*a, dtype=torch.bfloat16)
        got_b = model(*b, dtype=torch.bfloat16)
    assert not torch.equal(want_a, want_b)
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)


def test_launches_advance_by_24_per_replay(card):
    model = _model(card, SMALL)
    x, mask = _inputs(card, 6, 512, 3)
    counts = []
    with torch.inference_mode():
        for _ in range(4):               # capture, then three replays
            before = flash_rel_attention.launches
            model(x, mask, dtype=torch.bfloat16)
            counts.append(flash_rel_attention.launches - before)
    assert counts == [24, 24, 24, 24]


def test_profiler_sees_the_kernels_of_a_replay(card, tmp_path):
    """A graph captured before the profiler starts: its replay's 24
    attention kernels appear in the trace, each correlated with the
    ``cudaGraphLaunch`` that ran it; replays after the profiler stops
    still give the eager logits."""
    model = _model(card, SMALL)
    x, mask = _inputs(card, 6, 512, 4)
    with torch.inference_mode():
        eager = model._encode(x, mask, torch.bfloat16, "flash_rel")
        model(x, mask, dtype=torch.bfloat16)                # capture
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            model(x, mask, dtype=torch.bfloat16)
            torch.cuda.synchronize()
        after = model(x, mask, dtype=torch.bfloat16)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    launches = {e["args"]["correlation"] for e in events
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and "GraphLaunch" in e.get("name", "")}
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"
               and "flash_rel_kernel" in e.get("name", "")]
    assert len(launches) == 1 and len(kernels) == 24
    assert {e["args"].get("correlation") for e in kernels} == launches
    assert torch.equal(after, eager)
