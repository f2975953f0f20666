"""Entry points (port of the reference's root ``__graft_entry__.py``).

``entry()``              the forward step of the flagship model
                         (Wav2Vec2Bert CTC at the full w2v-bert-2.0
                         geometry, 4 x 25 s, bf16, the flash_rel kernel) on
                         one card: returns (fn, args), fn(*args) -> ids.
``dryrun_multichip(n)``  n processes, one step each on tiny shapes: a
                         dp x tp ZeRO-1 train step, the sequence-parallel
                         step's loss against it, the pipelined forward
                         against the plain one, and sharded inference.

    python -m audio_processor_tpu_torch.entry [--devices N] [--device cpu]

runs ``dryrun_multichip(N)`` (default 8 processes) on the card, or on the
CPU under gloo with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# The dry run's tiny geometry: the full parallel structure (head and FFN
# dims divisible by the tensor-parallel size), the reference's shapes.
TINY = dict(vocab_size=36, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            conv_depthwise_kernel_size=7, left_max_position_embeddings=8,
            right_max_position_embeddings=2)


def entry(device: Optional[str] = None):
    """(fn, (model, audio, lengths)): fn runs the fbank frontend, the
    encoder in bf16 with the configured kernel path and greedy CTC ids
    over 4 x 25 s of audio at the full w2v-bert-2.0 geometry, random
    weights from seed 0, on ``device`` (default the card)."""
    from audio_processor_tpu_torch.dsp.fbank import log_mel_frontend
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v

    dev = torch.device(device or "cuda")
    cfg = w2v.W2VBertConfig(vocab_size=64)
    model = w2v.build_synthetic(cfg, dev, seed=0)

    @torch.inference_mode()
    def fn(model, audio, lengths):
        from audio_processor_tpu_torch.pipeline.asr_engine import pad_seq

        feats, mask = pad_seq(*log_mel_frontend(audio, lengths))
        logits = model(feats, mask, dtype=torch.bfloat16)
        return w2v.greedy_ctc_ids(logits, mask, cfg.pad_token_id)

    B, T = 4, 16000 * 25
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(
        (0.1 * rng.standard_normal((B, T))).astype(np.float32)).to(dev)
    lengths = torch.full((B,), T, dtype=torch.int64, device=dev)
    return fn, (model, audio, lengths)


def _dryrun_batch(B: int, cfg, T: int = 32, N: int = 8, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "features": rng.standard_normal(
            (B, T, cfg.feature_projection_input_dim)).astype(np.float32),
        "feature_mask": np.ones((B, T), np.float32),
        "labels": rng.integers(1, cfg.vocab_size, (B, N)).astype(np.int64),
        "label_mask": np.ones((B, N), np.float32),
    }


def _dryrun_rank(rank: int, world: int, init: str, kind: str, backend: str,
                 out: Path) -> None:
    """One rank of :func:`dryrun_multichip`."""
    import torch.distributed as dist

    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.models.tokenizer import CTCVocab
    from audio_processor_tpu_torch.parallel import collectives as coll
    from audio_processor_tpu_torch.parallel.distributed import (
        initialize_distributed, local_device,
    )
    from audio_processor_tpu_torch.parallel.mesh import (
        make_mesh, opt_state_shardings,
    )
    from audio_processor_tpu_torch.parallel.pipeline import (
        make_pipelined_forward, make_stage_mesh,
    )
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
    from audio_processor_tpu_torch.pipeline.chunker import split_audio
    from audio_processor_tpu_torch.training.train_step import (
        init_state, make_optimizer, make_train_step, shard_batch,
    )

    initialize_distributed(init, num_processes=world, process_id=rank,
                           backend=backend, timeout_s=120)
    dev = local_device(kind)
    cfg = w2v.W2VBertConfig(**TINY)
    batch_np = _dryrun_batch(world * 2, cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}

    def step_loss(mesh, zero1):
        model = w2v.build_synthetic(cfg, dev, seed=0).train()
        state = init_state(model, make_optimizer(1e-4), mesh=mesh,
                           zero1=zero1)
        sh = opt_state_shardings(state.optimizer, model, mesh) \
            if zero1 and mesh.axis_size("data") > 1 else None
        step = make_train_step(torch.float32, mesh=mesh, opt_shardings=sh)
        state, loss = step(state, shard_batch(batch, mesh))
        assert state.step == 1
        return float(loss)

    # dp x tp with the Adam moments partitioned over 'data' (ZeRO-1).
    mesh = make_mesh(world, model=2 if world % 2 == 0 else 1, device=kind)
    loss = step_loss(mesh, zero1=True)
    assert np.isfinite(loss), f"non-finite CTC loss: {loss}"

    # Frames split over 'seq' must not change the loss.
    sp_loss = None
    if world % 2 == 0:
        sp_mesh = make_mesh(world, model=2 if world % 4 == 0 else 1, seq=2,
                            device=kind)
        sp_loss = step_loss(sp_mesh, zero1=False)
        assert abs(sp_loss - loss) < 1e-3 * max(1.0, abs(loss)), \
            f"seq-parallel loss {sp_loss} != dp/tp loss {loss}"

    # Pipelined forward, one layer stack stage per process, against the
    # plain forward.
    pp_cfg = dataclasses.replace(cfg, num_hidden_layers=max(2, world))
    model = w2v.build_synthetic(pp_cfg, dev, seed=1)
    feats = batch["features"]
    fmask = batch["feature_mask"].bool()
    with torch.no_grad():
        ref = model(feats, fmask)
    pp = make_pipelined_forward(pp_cfg, make_stage_mesh(world, device=kind),
                                4)(
        model, feats, fmask)
    pp_err = float((pp - ref).abs().max())
    assert pp_err < 1e-4, f"pipelined forward mismatch: {pp_err}"

    # Sharded inference: each process transcribes its share of the
    # chunks on its own device; the shares cover every chunk.
    icfg = PipelineConfig(enable_mixed_precision=False,
                          chunk_duration_sec=1.0, overlap_sec=0.25,
                          length_buckets_sec=(1.0,), chunk_batch_size=1)
    vocab = CTCVocab.darija_default()
    # Heads of 64, the attention kernels' head size, for the card.
    infer_cfg = w2v.W2VBertConfig(**{
        **TINY, "vocab_size": len(vocab), "hidden_size": 128,
        "num_attention_heads": 2, "intermediate_size": 256})
    engine = ASREngine(icfg, device=dev,
                       model=w2v.build_synthetic(infer_cfg, dev, seed=1),
                       vocab=vocab, mesh=mesh)
    wave = (0.1 * np.random.default_rng(0).standard_normal(
        (2, 16000 * 3))).astype(np.float32)
    chunks = split_audio(wave, 16000, "dryrun.wav", 1.0, 0.25)
    rows = engine.transcribe_chunks(chunks[rank::world])
    assert all(r["error"] == "" for r in rows), rows
    n_rows = torch.tensor([len(rows)], device=dev)
    coll.all_reduce_(n_rows, dist.group.WORLD)
    assert int(n_rows) == len(chunks), (int(n_rows), len(chunks))
    if rank == 0:
        out.write_text(json.dumps({
            "mesh": mesh.shape, "backend": dist.get_backend(),
            "device": str(dev), "loss": loss, "seq_parallel_loss": sp_loss,
            "pipeline_max_err": pp_err,
            "sharded_inference_chunks": int(n_rows)}))
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     timeout_s: float = 600.0) -> dict:
    """Run the dry run in ``n_devices`` processes and return rank 0's
    summary. ``device`` (default the card; ``"cpu"`` runs every rank on
    the CPU) is each process's: ``cuda:<rank>`` with NCCL when there are
    enough cards, else every rank on the visible cards under gloo, which
    is named here and printed. With no card and no ``device="cpu"`` it
    raises RuntimeError before any process starts."""
    from audio_processor_tpu_torch.parallel.launch import (
        file_init_method, python_argv, run_ranks,
    )

    kind = torch.device(device or "cuda").type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dryrun_multichip runs on the card, and no CUDA device is "
            "visible; pass device=\"cpu\" (--device cpu) to run it on the "
            "CPU")
    backend = "nccl" if kind == "cuda" \
        and torch.cuda.device_count() >= n_devices else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        init = file_init_method(tmp)
        out = Path(tmp) / "rank0.json"
        run_ranks(lambda r: python_argv(
            "audio_processor_tpu_torch.entry", "--rank", str(r), "--world",
            str(n_devices), "--init", init, "--device", kind, "--backend",
            backend, "--out", str(out)), n_devices, timeout_s,
            cwd=str(Path(__file__).resolve().parents[1]))
        summary = json.loads(out.read_text())
    print(f"dryrun_multichip ok: {summary}", flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--backend", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _dryrun_rank(args.rank, args.world, args.init, args.device,
                     args.backend, Path(args.out))
        return 0
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
