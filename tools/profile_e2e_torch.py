#!/usr/bin/env python
"""Stage split of the port's batch ASR loop on the card (the twin of
tools/profile_e2e.py): decode, chunk, host prep, H2D upload, the fused
device program with its inputs resident, fetch + CTC text decode.

    python3 tools/profile_e2e_torch.py [--calls 24] [--call-sec 180]
        [--device cuda]

It writes its own synthetic 2-channel PCM16 WAV calls (those of the
repo's bench: a tone over noise per speaker, seed 0), builds a
synthetic-mode ``ASREngine`` at the full w2v-bert-2.0 width (random
weights, bf16, ``attention_impl: auto``, which runs the flash_rel
kernel), and times each
stage serially. Device stages end in ``torch.cuda.synchronize()``;
the device program is timed after a warm-up pass over every shape.
Prints the card's name and power limit, each stage, the serial total
and its RTFx, and one JSON line with the stages. The engine's own loop
overlaps host prep with the device, so the serial total bounds it from
above.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import torch

SR = 16000


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def require_device(name: str) -> torch.device:
    """The device asked for; the card unless ``cpu`` is named, and no
    run without one."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit(f"{Path(sys.argv[0]).name}: torch.cuda.is_available() "
                     "is False; pass --device cpu to run on the CPU")
        print(smi_line(), flush=True)
        from audio_processor_tpu_torch import _build

        # The engine's kernel and the native host library the pipeline
        # preps and decodes with.
        _build.build_all(("flash_rel_attention",), native=True)
    print(f"device {device}, torch {torch.__version__}", flush=True)
    return device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_calls(root: Path, n_calls: int, call_sec: float) -> list:
    """``n_calls`` 2-channel PCM16 WAV calls of ``call_sec`` seconds:
    agent and client tones (180 + 10 i and 240 + 10 i Hz) over noise."""
    from audio_processor_tpu_torch.io import wav

    rng = np.random.default_rng(0)
    t = np.arange(int(SR * call_sec)) / SR
    paths = []
    for i in range(n_calls):
        agent = 0.05 * rng.standard_normal(t.shape[0]) + \
            0.2 * np.sin(2 * np.pi * (180 + 10 * i) * t)
        client = 0.05 * rng.standard_normal(t.shape[0]) + \
            0.2 * np.sin(2 * np.pi * (240 + 10 * i) * t)
        p = root / f"call_{i}.wav"
        wav.write(p, np.stack([agent, client]).astype(np.float32), SR)
        paths.append(p)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=24)
    ap.add_argument("--call-sec", type=float, default=180.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.io import native
    from audio_processor_tpu_torch.io.decode import load_audio
    from audio_processor_tpu_torch.io.wire import upload
    from audio_processor_tpu_torch.models.flash_rel_attention import (
        flash_rel_attention,
    )
    from audio_processor_tpu_torch.models.tokenizer import batch_decode
    from audio_processor_tpu_torch.pipeline.asr_engine import (
        ASREngine, _SubBatch,
    )
    from audio_processor_tpu_torch.pipeline.chunker import (
        chunk_batch, split_audio,
    )

    cfg = PipelineConfig.from_dict({
        "transcription_model": "", "chunk_batch_size": 16,
        "enable_mixed_precision": True,
        "attention_impl": "auto"})
    engine = ASREngine(cfg, device=device)
    mc = engine.model_cfg
    print(f"engine: hidden {mc.hidden_size}, {mc.num_hidden_layers} layers, "
          f"{mc.num_attention_heads} heads, ffn {mc.intermediate_size}, "
          f"{engine.dtype}, attention {engine.attention_impl}", flush=True)

    with tempfile.TemporaryDirectory() as td:
        paths = make_calls(Path(td), args.calls, args.call_sec)

        t0 = time.perf_counter()
        waves = [load_audio(p)[0] for p in paths]
        t_decode = time.perf_counter() - t0

    t0 = time.perf_counter()
    chunks = []
    for p, w in zip(paths, waves):
        chunks.extend(split_audio(w, SR, p.name, cfg.chunk_duration_sec,
                                  cfg.overlap_sec))
    t_chunk = time.perf_counter() - t0
    print(f"decode {t_decode * 1e3:.3f} ms, chunk {t_chunk * 1e3:.3f} ms, "
          f"{len(chunks)} chunks; native I/O library loaded: "
          f"{native.available()}", flush=True)

    subs = []
    for b in chunk_batch(chunks, engine.bucket_samples):
        for i in range(0, len(b), engine.device_chunks):
            subs.append(_SubBatch(b, i, i + min(engine.device_chunks,
                                                len(b) - i)))
    print(f"{len(subs)} device batches, bucket lens "
          f"{[s.bucket_len for s in subs]}", flush=True)

    t0 = time.perf_counter()
    prepped = [engine._prepare_fused_buffer(s, engine._tail_size(len(s)))
               for s in subs]
    t_prep = time.perf_counter() - t0
    print(f"host prep {t_prep * 1e3:.3f} ms total "
          f"({prepped[0][0].dtype} buffers)", flush=True)

    # Warm-up: every (bucket, rows) shape once (kernel build, cuBLAS
    # heuristics, allocator growth).
    for s, (buf, lengths) in zip(subs, prepped):
        engine._run_fused(buf, lengths, s.bucket_len)
    sync(device)

    t0 = time.perf_counter()
    dev = [(upload(b, device), upload(l, device)) for b, l in prepped]
    sync(device)
    t_upload = time.perf_counter() - t0
    mb = sum(b.nbytes + l.nbytes for b, l in prepped) / 1e6
    print(f"upload {t_upload * 1e3:.3f} ms for {mb:.1f} MB "
          f"({mb / max(t_upload, 1e-9):.0f} MB/s)", flush=True)

    # The device program alone, inputs resident; the last of 3 passes.
    device_passes = []
    for _ in range(3):
        flash_rel_attention.launches = 0
        t0 = time.perf_counter()
        outs = [engine._fused(b, l, s.bucket_len)
                for s, (b, l) in zip(subs, dev)]
        sync(device)
        device_passes.append(time.perf_counter() - t0)
    t_device = device_passes[-1]
    launches = flash_rel_attention.launches
    print(f"device fused x{len(dev)} {t_device * 1e3:.3f} ms "
          f"({t_device / len(dev) * 1e3:.3f} ms/batch; passes "
          f"{[round(x * 1e3, 3) for x in device_passes]} ms); flash_rel "
          f"launches in the last pass {launches}", flush=True)

    t0 = time.perf_counter()
    n_texts = 0
    for ids, mask, _af in outs:
        n_texts += len(batch_decode(ids.cpu().numpy(), engine.vocab,
                                    mask.cpu().numpy()))
    t_fetch = time.perf_counter() - t0
    print(f"fetch+ctc-decode {t_fetch * 1e3:.3f} ms ({n_texts} texts)",
          flush=True)

    stages = {"decode": t_decode, "chunk": t_chunk, "host_prep": t_prep,
              "upload": t_upload, "device": t_device,
              "fetch_decode": t_fetch}
    total = sum(stages.values())
    audio_s = args.calls * args.call_sec
    print(f"serial total {total:.4f} s -> RTFx {audio_s / total:.1f} "
          "(the pipelined loop overlaps some of these)", flush=True)
    for k, v in stages.items():
        print(f"  {k:13s} {v * 1e3:10.3f} ms  {v / total:.4f}", flush=True)
    print(json.dumps({
        "tool": "profile_e2e_torch", "device": str(device),
        "card": smi_line() if device.type == "cuda" else None,
        "attention_impl": engine.attention_impl, "calls": args.calls,
        "call_sec": args.call_sec, "chunks": len(chunks),
        "device_batches": len(subs), "flash_rel_launches": launches,
        "native_io": native.available(),
        "stages_ms": {k: v * 1e3 for k, v in stages.items()},
        "shares": {k: v / total for k, v in stages.items()},
        "serial_total_s": total, "rtfx": audio_s / total}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
