#!/usr/bin/env python
"""Profile the port's VAD message path at full width on the card (the
twin of tools/profile_message_path.py).

On synthetic 2-channel calls (speech-like tone bursts over silence,
int16-exact), it times:

  1. PyanNet sliding-window VAD (``models/vad.pyannet_windowed_dispatch``
     and fetch) for both speakers of every call, every channel enqueued
     before any is fetched; PyanNet at pyannote's default geometry from
     a seeded pyannote-layout state dict (``vad_model_id``);
  2. binarize -> merge -> pad -> window on the host;
  3. batched mono transcription of every segment of the file batch
     through the full-width ASR engine (``transcribe_mono_segments``;
     bf16, the flash_rel kernel).

Prints the card's name and power limit, per-phase seconds and a
message RTFx (processed audio seconds / wall seconds, counting BOTH
speaker channels as processed audio, as the reference's work per call
does): 2 untimed warm-in sweeps, then 5 timed, best and p50, and one
JSON line.

    python3 tools/profile_message_path_torch.py [n_calls=4] [call_sec=180]
    --device cpu runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import torch

from tools.profile_e2e_torch import require_device, smi_line, sync

SR = 16000


def synth_call(call_sec: float, seed: int) -> np.ndarray:
    """[2, T] speech-ish bursts over silence, int16-exact."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * call_sec)) / SR
    wav = np.zeros((2, t.shape[0]), np.float32)
    for ch in range(2):
        pos = 0.0
        while pos < call_sec - 4.0:
            dur = float(rng.uniform(2.0, 8.0))
            s, e = int(pos * SR), int(min(call_sec, pos + dur) * SR)
            f0 = float(rng.uniform(120, 300))
            seg = np.sin(2 * np.pi * f0 * t[s:e]) * \
                (0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * t[s:e]))
            wav[ch, s:e] = 0.3 * seg + 0.02 * rng.standard_normal(e - s)
            pos += dur + float(rng.uniform(1.5, 5.0))
    # PCM16-exact, as decoded production audio is: mono rows then ride
    # the int16 wire.
    return np.round(np.clip(wav, -1.0, 0.999) * 32768.0) / 32768.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_calls", nargs="?", type=int, default=4)
    ap.add_argument("call_sec", nargs="?", type=float, default=180.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.models.flash_rel_attention import (
        flash_rel_attention,
    )
    from audio_processor_tpu_torch.models.vad import (
        synthetic_pyannote_state_dict,
    )
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
    from audio_processor_tpu_torch.pipeline.segmenter import SpeechSegment

    with tempfile.TemporaryDirectory() as td:
        ckpt = Path(td) / "pyannet.ckpt"
        torch.save({"state_dict": synthetic_pyannote_state_dict(0)}, ckpt)
        cfg = PipelineConfig.from_dict({
            "transcription_model": "", "logs_folder": str(Path(td) / "logs"),
            "chunk_batch_size": 16, "enable_mixed_precision": True,
            "enable_message_path": True, "vad_model_id": str(ckpt)})
        print("loading the full-width ASR engine (synthetic weights)",
              flush=True)
        engine = ASREngine(cfg, device=device)
        seg = SpeechSegment(cfg, asr_engine=engine)
    if seg._vad_params is None:
        sys.exit("PyanNet did not load; the energy VAD would run")
    mc = engine.model_cfg
    print(f"engine: hidden {mc.hidden_size}, {mc.num_hidden_layers} layers, "
          f"{engine.dtype}, attention {engine.attention_impl}; PyanNet "
          f"{seg._vad_cfg}", flush=True)

    calls = [synth_call(args.call_sec, i) for i in range(args.n_calls)]
    t0 = time.perf_counter()
    warmed = engine.warmup(message_rows=True)
    msgs = []
    for ch in range(2):
        s = seg.get_speech_segments(calls[0][ch], SR,
                                    "agent" if ch == 0 else "client")
        msgs.extend(seg.transcribe_segments_batched(s, SR))
    sync(device)
    print(f"warmup {time.perf_counter() - t0:.2f} s ({warmed} engine "
          f"shapes, {len(msgs)} segments)", flush=True)

    # VAD alone on one channel, outside the sweeps.
    t0 = time.perf_counter()
    seg.vad_probs(calls[0][0], SR)
    print(f"vad_probs alone: {time.perf_counter() - t0:.4f} s per "
          f"{args.call_sec:.0f} s channel", flush=True)

    channels = [(wav[ch], label) for wav in calls
                for ch, label in ((0, "agent"), (1, "client"))]
    audio_sec = args.n_calls * args.call_sec * 2   # both speaker channels
    def one_sweep():
        """The engine's regime (engine._run_message_path): every
        channel's VAD enqueued, then fetched, segments windowed on the
        host, then ONE batched transcription over the file batch."""
        phases = {}
        t_all = time.perf_counter()
        t0 = time.perf_counter()
        monos = [seg._as_mono2d(w) for w, _ in channels]
        pending = [seg._vad_dispatch(flat, SR) for _, flat in monos]
        probs = [seg._vad_fetch(p) for p in pending]
        phases["vad"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        segments = []
        for (mono, _), (p, hop), (_, label) in zip(monos, probs, channels):
            segments.extend(seg._segments_from_probs(p, hop, mono, SR,
                                                     label))
        phases["window"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = seg.transcribe_segments_batched(segments, SR)
        phases["asr"] = time.perf_counter() - t0
        return phases, len(out), time.perf_counter() - t_all

    for w in range(2):
        _, n_segments, tw = one_sweep()
        print(f"warm-in sweep {w}: {tw:.4f} s", flush=True)

    totals, all_phases = [], []
    for it in range(5):
        flash_rel_attention.launches = 0
        mono0 = engine.mono_dispatches
        phases, n_segments, total = one_sweep()
        totals.append(total)
        all_phases.append(phases)
        dispatches = engine.mono_dispatches - mono0
        print(f"sweep {it}: vad {phases['vad']:.4f} s window "
              f"{phases['window']:.4f} s asr {phases['asr']:.4f} s total "
              f"{total:.4f} s rtfx {audio_sec / total:.1f}; {dispatches} "
              f"mono dispatches, {flash_rel_attention.launches} flash_rel "
              "launches", flush=True)

    best = min(totals)
    p50 = sorted(totals)[len(totals) // 2]
    k = totals.index(best)
    print(f"\ncalls={args.n_calls} x {args.call_sec:.0f} s (x2 speakers), "
          f"segments={n_segments}")
    for key in ("vad", "window", "asr"):
        print(f"  {key:7s} {all_phases[k][key]:9.4f} s (best sweep)")
    print(f"  total   {best:9.4f} s best / {p50:.4f} s p50")
    print(f"message_rtfx = {audio_sec / best:.1f} (p50 {audio_sec / p50:.1f})")
    print(json.dumps({
        "tool": "profile_message_path_torch", "device": str(device),
        "card": smi_line() if device.type == "cuda" else None,
        "calls": args.n_calls, "call_sec": args.call_sec,
        "segments": n_segments, "best_sweep_s": all_phases[k],
        "total_best_s": best, "total_p50_s": p50,
        "message_rtfx_best": audio_sec / best,
        "message_rtfx_p50": audio_sec / p50,
        "mono_shapes": {f"{r}x{n}": c for (r, n), c in
                        sorted(engine.mono_shapes.items())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
