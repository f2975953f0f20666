"""CTC fine-tuning entry point for Wav2Vec2Bert (port of
training/finetune.py).

A JSONL manifest (``{"audio": path, "text": transcript}`` per line)
streams through the same fbank frontend as inference, labels encode with
the CTC vocab, and training runs the step of training/train_step.py on
one device (``FinetuneConfig.device``, the card unless the caller asks
for the CPU). The resume point is a ``torch.save`` of the model's and
the optimizer's state dicts and the step, restored bitwise.

With ``mesh_shape`` ({data, seq, model}) the run goes under a launcher of
data x seq x model processes (``torchrun --nproc-per-node N -m
audio_processor_tpu_torch.training.finetune cfg.yaml``), one device each
(``cuda:<LOCAL_RANK>``). Every rank draws the same global batch and
decodes only its rows of it; ``zero1`` partitions the Adam moments over
'data'. The resume point keeps the single-device format (gathered on
rank 0 before the save, sliced again on a resume), and only the primary
rank writes checkpoints and logs metrics.

Usage:
    from audio_processor_tpu_torch.training.finetune import (
        FinetuneConfig, finetune)
    finetune(FinetuneConfig(manifest="train.jsonl", output_dir="ckpt"))

or ``python -m audio_processor_tpu_torch.training.finetune config.yaml``
(needs pyyaml).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from audio_processor_tpu_torch.models.tokenizer import CTCVocab, batch_decode
from audio_processor_tpu_torch.models.wav2vec2bert import (
    W2VBertConfig, Wav2Vec2Bert, build_synthetic,
)
from audio_processor_tpu_torch.training.train_step import (
    SpecAugment, TrainState, ctc_loss, gather_train_state, init_state,
    make_optimizer, make_train_step, scatter_train_state,
)
from audio_processor_tpu_torch.utils.metrics import cer, wer

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


@dataclasses.dataclass
class FinetuneConfig:
    manifest: str = ""
    output_dir: str = "./finetune_ckpt"
    init_checkpoint: str = ""       # HF dir to start from ("" = scratch)
    batch_size: int = 8
    num_steps: int = 1000
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    max_audio_sec: float = 25.0
    sample_rate: int = 16000
    checkpoint_every: int = 500
    mesh_shape: Optional[dict] = None   # {data, seq, model} processes
    zero1: bool = False                 # Adam moments split over 'data'
    seed: int = 0
    # Evaluation: greedy-decode WER/CER over a held-out manifest
    # (utils/metrics.py); 0 = only after the final step.
    eval_manifest: str = ""
    eval_every: int = 0
    # Resume from output_dir/state_latest (params + Adam moments +
    # step), continuing the step count where it stopped.
    resume: bool = False
    # SpecAugment (HF apply_spec_augment counterpart); 0 masks = off.
    spec_augment: bool = True
    num_time_masks: int = 2
    time_mask_span: int = 10
    num_freq_masks: int = 2
    freq_mask_span: int = 10
    device: str = "cuda"


def load_manifest(path: str | Path) -> List[dict]:
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def encode_text(text: str, vocab: CTCVocab) -> List[int]:
    """Character-level CTC label encoding with the inference vocab
    (spaces map to the word delimiter token)."""
    ids = []
    for ch in text.lower():
        tok = vocab.word_delimiter_token if ch == " " else ch
        idx = vocab.vocab.get(tok)
        if idx is not None:
            ids.append(idx)
    return ids


def _make_batch(sel: List[dict], cfg: FinetuneConfig,
                vocab: CTCVocab, rows: Optional[int] = None,
                device: Optional[torch.device] = None) -> dict:
    """Featurize + label-encode ``len(sel) <= rows`` manifest rows (rows
    defaults to batch_size) into one padded batch on ``device`` (default
    ``cfg.device``; a short final eval batch zero-pads the batch dim, as
    the JAX package's does): features [B, T, 160] and feature_mask [B, T]
    float32, labels [B, N] int64, label_mask [B, N] float32."""
    from audio_processor_tpu_torch.dsp.fbank import log_mel_frontend
    from audio_processor_tpu_torch.dsp.resample import resample_np
    from audio_processor_tpu_torch.io.decode import load_audio

    T = int(cfg.max_audio_sec * cfg.sample_rate)
    B = rows or cfg.batch_size
    audio = np.zeros((B, T), np.float32)
    lengths = np.zeros((B,), np.int64)
    labels_list = [encode_text(row["text"], vocab) for row in sel]
    for i, row in enumerate(sel):
        wf, sr = load_audio(row["audio"])
        if sr != cfg.sample_rate:
            wf = resample_np(wf, sr, cfg.sample_rate)
        mono = np.asarray(wf, np.float32).mean(0) \
            if wf.ndim == 2 else np.asarray(wf, np.float32)
        n = min(mono.shape[0], T)
        audio[i, :n] = mono[:n]
        lengths[i] = n
    dev = device or torch.device(cfg.device)
    feats, mask = log_mel_frontend(torch.from_numpy(audio).to(dev),
                                   torch.from_numpy(lengths).to(dev))
    max_lab = max(1, max((len(l) for l in labels_list), default=1))
    labels = np.zeros((B, max_lab), np.int64)
    label_mask = np.zeros((B, max_lab), np.float32)
    for i, l in enumerate(labels_list):
        labels[i, :len(l)] = l
        label_mask[i, :len(l)] = 1.0
    return {
        "features": feats,
        "feature_mask": mask.float(),
        "labels": torch.from_numpy(labels).to(dev),
        "label_mask": torch.from_numpy(label_mask).to(dev),
    }


def batches(rows: List[dict], cfg: FinetuneConfig, vocab: CTCVocab,
            rng: np.random.Generator, shard: Tuple[int, int] = (0, 1),
            device: Optional[torch.device] = None) -> Iterator[dict]:
    """Infinite shuffled stream of padded feature/label batches (the
    JAX package's order for the same ``rng``). With ``shard`` = (index,
    count), each global batch's rows split into ``count`` equal parts and
    this stream decodes part ``index`` alone."""
    index, count = shard
    if cfg.batch_size % count:
        raise ValueError(f"batch_size {cfg.batch_size} does not split "
                         f"over data={count}")
    n = cfg.batch_size // count
    while True:
        order = rng.permutation(len(rows))
        for start in range(0, len(rows) - cfg.batch_size + 1,
                           cfg.batch_size):
            sel = [rows[i] for i in order[start:start + cfg.batch_size]]
            yield _make_batch(sel[index * n:(index + 1) * n], cfg, vocab,
                              rows=n, device=device)


def _default_dtype(device: torch.device) -> torch.dtype:
    return torch.float32 if device.type == "cpu" else torch.bfloat16


@torch.inference_mode()
def evaluate(model: Wav2Vec2Bert, vocab: CTCVocab, rows: List[dict],
             cfg: FinetuneConfig, dtype: Optional[torch.dtype] = None,
             device: Optional[torch.device] = None) -> dict:
    """One pass over ``rows``: greedy CTC decode -> corpus WER/CER +
    mean CTC loss over the full batches (the zero-padded rows of a short
    batch would skew it). The attention is the plain ``"xla"`` path, as
    in the JAX package's eval; the loss reuses the decode's logits. A
    sharded model evaluates every row on every rank (its forward runs
    collectives over 'model' and 'seq')."""
    device = device or torch.device(cfg.device)
    dtype = dtype or _default_dtype(device)
    refs: List[str] = []
    hyps: List[str] = []
    losses: List[float] = []
    B = cfg.batch_size
    for start in range(0, len(rows), B):
        sel = rows[start:start + B]
        batch = _make_batch(sel, cfg, vocab, device=device)
        mask = batch["feature_mask"]
        logits = model(batch["features"], mask.bool(), dtype=dtype,
                       attention_impl="xla")
        ids = logits.argmax(dim=-1).cpu().numpy()
        hyps.extend(batch_decode(ids[:len(sel)], vocab,
                                 mask=mask[:len(sel)].cpu().numpy(),
                                 skip_special_tokens=True))
        refs.extend(row["text"].lower() for row in sel)
        if len(sel) == B:
            losses.append(float(ctc_loss(
                logits, 1.0 - mask, batch["labels"],
                1.0 - batch["label_mask"],
                blank_id=model.cfg.pad_token_id).mean()))
    return {
        "wer": wer(refs, hyps),
        "cer": cer(refs, hyps),
        "loss": float(np.mean(losses)) if losses else float("nan"),
        "num_utterances": len(refs),
    }


def _state_dir(output_dir) -> Path:
    return Path(output_dir) / "state_latest"


def save_train_state(state: TrainState, output_dir) -> Path:
    """Full-fidelity resume point: the model's and the optimizer's state
    dicts (params, both Adam moments) and the step, written to a temp
    file and renamed, so a crash mid-write leaves the last one whole.
    Under a mesh every rank calls it; the state is gathered into the
    single-device format and rank 0 writes it."""
    path = _state_dir(output_dir)
    blob = gather_train_state(state)
    if blob is None:
        return path
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, path / STATE_FILE)
    return path


def load_train_state(state: TrainState, output_dir) -> TrainState:
    """Restore params, Adam moments and step bitwise into ``state``
    (built by ``init_state`` over a model of the same config; under a
    mesh each rank keeps its slices and partition)."""
    blob = torch.load(_state_dir(output_dir) / STATE_FILE,
                      map_location="cpu", weights_only=True)
    if state.mesh is not None:
        return scatter_train_state(state, blob)
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return state


def _mesh_of(cfg: FinetuneConfig):
    """The process mesh ``mesh_shape`` asks for (None without one). A
    shape of several processes needs a launch of that many, with the
    process group initialised (``main`` does it)."""
    if not cfg.mesh_shape:
        return None
    import torch.distributed as dist

    from audio_processor_tpu_torch.parallel.mesh import make_mesh

    shape = cfg.mesh_shape
    model, seq = int(shape.get("model", 1)), int(shape.get("seq", 1))
    data = int(shape.get("data") or 0) or None
    n = (data or 1) * model * seq
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data, n = world // (model * seq), world
    if n == world == 1:
        return None
    if n != world:
        raise ValueError(
            f"mesh_shape {shape} needs {n} processes, and this launch has "
            f"{world}: run it under torchrun --nproc-per-node {n}")
    return make_mesh(data=data, model=model, seq=seq,
                     device=torch.device(cfg.device).type)


def _load_model(cfg: FinetuneConfig, device: torch.device,
                model_cfg: Optional[W2VBertConfig],
                vocab: Optional[CTCVocab]
                ) -> Tuple[Wav2Vec2Bert, CTCVocab]:
    """The model to start from: ``init_checkpoint`` (an HF directory,
    through the port's converter and its ``torch_converted/`` cache) or
    seeded random weights."""
    if cfg.init_checkpoint:
        from audio_processor_tpu_torch.models.checkpoint import (
            load_or_convert_w2v_bert,
        )

        model_cfg, sd, vocab_dict = load_or_convert_w2v_bert(
            cfg.init_checkpoint)
        with torch.device("meta"):
            model = Wav2Vec2Bert(model_cfg)
        model = model.to_empty(device=device)
        model.load_state_dict(sd)
        vocab = CTCVocab(vocab_dict) if vocab_dict \
            else CTCVocab.darija_default()
        return model, vocab
    vocab = vocab or CTCVocab.darija_default()
    model_cfg = model_cfg or W2VBertConfig(vocab_size=len(vocab))
    return build_synthetic(model_cfg, device, seed=cfg.seed), vocab


def finetune(cfg: FinetuneConfig, model_cfg: Optional[W2VBertConfig] = None,
             model: Optional[Wav2Vec2Bert] = None,
             vocab: Optional[CTCVocab] = None,
             on_step: Optional[Callable] = None
             ) -> Tuple[Wav2Vec2Bert, List[float]]:
    """Run fine-tuning; returns (the trained model, loss history: every
    10th step's loss and the last's). A given ``model`` is moved to
    ``cfg.device`` and trained in place. fp32 on the CPU, bf16 compute
    on CUDA. ``on_step(step, state, loss, times)``, when given, is
    called after every step, with the device synchronised around the
    step's parts: ``times`` holds ``prep_s`` (the batch), ``fwd_bwd_s``
    and ``opt_s`` (host clock) and ``frames`` (the batch's valid
    frames), and the step's gradients are still in the parameters'
    ``.grad``."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("FinetuneConfig.device is cuda but CUDA is not "
                           "available; pass device='cpu' to train on the "
                           "CPU")
    mesh = _mesh_of(cfg)
    primary = True
    if mesh is not None:
        from audio_processor_tpu_torch.parallel.distributed import (
            is_primary_host,
        )

        device = mesh.local_device
        primary = is_primary_host()
    if model is None:
        model, vocab = _load_model(cfg, device, model_cfg, vocab)
    else:
        model = model.to(device)
    vocab = vocab or CTCVocab.darija_default()
    model.train()

    dtype = _default_dtype(device)
    augment = None
    if cfg.spec_augment:
        augment = SpecAugment(cfg.num_time_masks, cfg.time_mask_span,
                              cfg.num_freq_masks, cfg.freq_mask_span)
    state = init_state(model, make_optimizer(cfg.learning_rate,
                                             cfg.weight_decay),
                       mesh=mesh, zero1=bool(cfg.zero1))
    step_fn = make_train_step(dtype=dtype, augment=augment,
                              augment_seed=cfg.seed + 1, mesh=state.mesh)

    start_step = 0
    if cfg.resume and (_state_dir(cfg.output_dir) / STATE_FILE).exists():
        state = load_train_state(state, cfg.output_dir)
        start_step = state.step
        logger.info("resumed from %s at step %d",
                    _state_dir(cfg.output_dir), start_step)

    rows = load_manifest(cfg.manifest)
    if len(rows) < cfg.batch_size:
        raise ValueError(
            f"manifest has {len(rows)} rows < batch_size {cfg.batch_size}")
    eval_rows = load_manifest(cfg.eval_manifest) if cfg.eval_manifest \
        else []
    rng = np.random.default_rng(cfg.seed)
    shard = (0, 1) if mesh is None else (mesh.coordinate("data"),
                                         mesh.axis_size("data"))
    stream = batches(rows, cfg, vocab, rng, shard=shard, device=device)

    def run_eval(step):
        metrics = evaluate(model, vocab, eval_rows, cfg, dtype=dtype,
                           device=device)
        if primary:
                logger.info("eval @ step %d: WER %.4f CER %.4f loss %.4f "
                            "(%d utts)", step, metrics["wer"],
                            metrics["cer"], metrics["loss"],
                            metrics["num_utterances"])
        return metrics

    losses: List[float] = []
    last_eval = None
    for step in range(start_step, cfg.num_steps):
        t0 = time.perf_counter()
        batch = next(stream)
        times = None
        if on_step is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times = {"prep_s": time.perf_counter() - t0,
                     "frames": int(batch["feature_mask"].sum())}
        state, loss = step_fn(state, batch, times=times)
        if step % 10 == 0 or step == cfg.num_steps - 1:
            loss_val = float(loss)
            losses.append(loss_val)
            if primary:
                logger.info("step %d loss %.4f", step, loss_val)
        if on_step is not None:
            on_step(step, state, loss, times)
        if cfg.checkpoint_every and (step + 1) % cfg.checkpoint_every == 0:
            _save(model, vocab, cfg.output_dir, step + 1, mesh=mesh)
            save_train_state(state, cfg.output_dir)
        if eval_rows and cfg.eval_every and \
                (step + 1) % cfg.eval_every == 0:
            last_eval = run_eval(step + 1)
    save_train_state(state, cfg.output_dir)
    if eval_rows:
        last_eval = run_eval(cfg.num_steps)
    _save(model, vocab, cfg.output_dir, cfg.num_steps, metrics=last_eval,
          mesh=mesh)
    return model, losses


def main(argv=None) -> int:
    """CLI: ``python -m audio_processor_tpu_torch.training.finetune
    config.yaml``; YAML keys map onto FinetuneConfig fields, and unknown
    keys fail."""
    import argparse

    ap = argparse.ArgumentParser(
        description="CTC fine-tuning for the wav2vec2bert ASR model")
    ap.add_argument("config", help="YAML file of FinetuneConfig fields")
    args = ap.parse_args(argv)
    try:
        import yaml
    except ImportError:
        ap.error("pyyaml is not installed, so a YAML config cannot be "
                 "read; build a FinetuneConfig in Python and call "
                 "finetune(cfg) instead")
    with open(args.config, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    known = {f.name for f in dataclasses.fields(FinetuneConfig)}
    unknown = set(raw) - known
    if unknown:
        ap.error(f"unknown config keys: {sorted(unknown)}")
    cfg = FinetuneConfig(**raw)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    from audio_processor_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )

    initialize_distributed(
        backend="gloo" if torch.device(cfg.device).type == "cpu" else None)
    _, losses = finetune(cfg)
    logger.info("done: %d steps, final loss %.4f", len(losses),
                losses[-1] if losses else float("nan"))
    return 0


def _save(model: Wav2Vec2Bert, vocab: CTCVocab, output_dir, step: int,
          metrics: Optional[dict] = None, mesh=None) -> None:
    """Params-only checkpoint in ``output_dir/step_<step>/`` (the port's
    ``checkpoint.save_params`` layout) with the config, vocab, step and
    eval metrics in its metadata.json. A failed write is a warning. Under
    a mesh every rank calls it (the tensor-parallel slices are gathered)
    and the primary rank writes."""
    from audio_processor_tpu_torch.models.checkpoint import save_params

    sd = model.state_dict()
    if mesh is not None:
        from audio_processor_tpu_torch.parallel.distributed import (
            is_primary_host,
        )
        from audio_processor_tpu_torch.parallel.mesh import gather_params

        sd = gather_params(model, mesh) if mesh.axis_size("model") > 1 \
            else sd
        if not is_primary_host():
            return
    out = Path(output_dir) / f"step_{step}"
    meta = {"config": dataclasses.asdict(model.cfg),
            "vocab": vocab.vocab, "step": step}
    if metrics:
        meta["eval"] = metrics
    try:
        save_params(sd, out, metadata=meta)
        logger.info("checkpoint saved to %s", out)
    except OSError as e:
        logger.warning("checkpoint save failed: %s", e)


if __name__ == "__main__":
    import sys

    sys.exit(main())
