"""GPipe pipeline parallelism for the conformer encoder (port of
parallel/pipeline.py).

The encoder's layer stack splits into S stages; the process at 'stage'
coordinate s holds layers s*L/S .. (s+1)*L/S - 1 and the batch streams
through as M microbatches. Activations move stage -> stage with explicit
``send``/``recv`` (parallel/collectives.py), where the reference uses
``lax.ppermute`` inside a ``shard_map``.

Schedule: GPipe fill-drain. Stage s runs its layers on microbatch t - s at
tick t: each stage takes microbatches in order, receiving each from the
stage before and sending it on, so the ticks emerge from the blocking
transfers. The last stage computes the head (and the loss), and the
outputs are broadcast to every stage (the reference's ``psum``). The
backward runs the reverse schedule: the last stage backpropagates the loss
into each microbatch's input, and each stage before it receives the
gradient of its outputs, runs ``torch.autograd.backward`` and sends its
inputs' gradients upstream. Outputs and gradients equal the unpipelined
model's (the same per-row math in the same order).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from audio_processor_tpu_torch.models import wav2vec2bert as w2v
from audio_processor_tpu_torch.parallel import collectives as coll
from audio_processor_tpu_torch.parallel.mesh import Mesh, build_mesh


def make_stage_mesh(n_stages: int, devices: Optional[Sequence] = None,
                    device: Optional[str] = None) -> Mesh:
    """A mesh with one ``"stage"`` axis over ``n_stages`` processes (the
    launch's world; each on its card, or on ``device``), or one process's
    devices when given. Builds no CPU mesh unless asked."""
    return build_mesh({"stage": n_stages}, devices=devices, device=device)


def _stage_of(mesh: Mesh, cfg: w2v.W2VBertConfig) -> Tuple[int, int, range]:
    S = mesh.axis_size("stage")
    if cfg.num_hidden_layers % S:
        raise ValueError(f"{cfg.num_hidden_layers} layers over {S} stages")
    if S > 1 and not mesh.multi_process:
        raise ValueError(f"{mesh}: a pipeline runs one process per stage")
    s = mesh.coordinate("stage")
    per = cfg.num_hidden_layers // S
    return S, s, range(s * per, (s + 1) * per)


def stage_parameter_names(model: w2v.Wav2Vec2Bert, mesh: Mesh) -> list:
    """The parameters this stage computes with: its layers, the feature
    projection on the first stage, the head on the last."""
    S, s, layers = _stage_of(mesh, model.cfg)
    keep = [f"layers.{i}." for i in layers]
    if s == 0:
        keep.append("feature_projection.")
    if s == S - 1:
        keep.append("lm_head.")
    return [n for n, _ in model.named_parameters()
            if any(n.startswith(k) for k in keep)]


def _stage_forward(model: w2v.Wav2Vec2Bert, feats: torch.Tensor,
                   mask: torch.Tensor, mesh: Mesh, n_microbatches: int,
                   dtype: torch.dtype, grad: bool):
    """Run this stage over every microbatch. Returns (inputs, outputs):
    per microbatch the stage's input (a leaf that will hold its gradient
    on stages after the first) and its output."""
    cfg = model.cfg
    S, s, layers = _stage_of(mesh, cfg)
    ranks = mesh.group_ranks("stage")
    B, T, _ = feats.shape
    M = n_microbatches
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    mb = B // M
    pad_mask = mask.float()
    attn_bias = ((1.0 - pad_mask) * -1e9)[:, None, None, :]
    fp = model.feature_projection
    inputs, outputs = [], []
    for m in range(M):
        rows = slice(m * mb, (m + 1) * mb)
        if s == 0:
            h = w2v.dense(fp.projection,
                          w2v.layer_norm(fp.layer_norm,
                                         feats[rows].to(dtype)))
            h = h * pad_mask[rows, :, None].to(dtype)
            inputs.append(None)
        else:
            h = coll.recv((mb, T, cfg.hidden_size), dtype, feats.device,
                          ranks[s - 1], mesh.group("stage"))
            h.requires_grad_(grad)
            inputs.append(h)
        for i in layers:
            h = model.layers[i](h, attn_bias[rows], pad_mask[rows], "xla")
        if s < S - 1:
            coll.send(h, ranks[s + 1], mesh.group("stage"))
        outputs.append(h)
    return inputs, outputs


def pipelined_forward(model: w2v.Wav2Vec2Bert, input_features: torch.Tensor,
                      attention_mask: torch.Tensor, mesh: Mesh,
                      n_microbatches: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Encoder forward with the layer stack pipelined over the mesh's
    'stage' processes: [B, T, 160] (+ bool [B, T] mask) -> fp32 [B, T,
    vocab] logits on every stage, equal to the model's own forward.
    B must divide into n_microbatches, the layers into the stages."""
    S, s, _ = _stage_of(mesh, model.cfg)
    with torch.no_grad():
        _, outputs = _stage_forward(model, input_features, attention_mask,
                                    mesh, n_microbatches, dtype, grad=False)
        B, T, _ = input_features.shape
        if s == S - 1:
            logits = w2v.dense(model.lm_head, torch.cat(outputs).float())
        else:
            logits = torch.empty(B, T, model.cfg.vocab_size,
                                 device=input_features.device)
        ranks = mesh.group_ranks("stage")
        return coll.broadcast_(logits, ranks[-1], mesh.group("stage"))


def make_pipelined_forward(cfg: w2v.W2VBertConfig, mesh: Mesh,
                           n_microbatches: int,
                           dtype: torch.dtype = torch.float32) -> Callable:
    """The pipelined forward bound to a mesh: fn(model, input_features,
    attention_mask) -> logits."""
    _stage_of(mesh, cfg)

    def fn(model, input_features, attention_mask):
        return pipelined_forward(model, input_features, attention_mask,
                                 mesh, n_microbatches, dtype)

    return fn


def make_pipelined_train_step(cfg: w2v.W2VBertConfig, mesh: Mesh,
                              n_microbatches: int,
                              dtype: torch.dtype = torch.float32
                              ) -> Callable:
    """Pipeline-parallel CTC train step: step(state, batch) -> (state,
    loss), ``state`` from ``train_step.init_state(model, tx)``. Each stage
    computes gradients for its own parameters only (the optimizer skips
    parameters without one), so after the step each stage's parameters
    equal the unpipelined step's. The loss (the batch's mean CTC loss) is
    broadcast from the last stage. GPipe keeps S-1 bubbles per M
    microbatches; choose M >= 4*S to amortise them."""
    from audio_processor_tpu_torch.training.train_step import ctc_loss

    S, s, _ = _stage_of(mesh, cfg)
    ranks = mesh.group_ranks("stage")
    group = mesh.group("stage")

    def step(state, batch: Dict[str, torch.Tensor]):
        model = state.model
        feats, mask = batch["features"], batch["feature_mask"]
        state.optimizer.zero_grad(set_to_none=True)
        inputs, outputs = _stage_forward(model, feats, mask.bool(), mesh,
                                         n_microbatches, dtype, grad=True)
        if s == S - 1:
            logits = w2v.dense(model.lm_head, torch.cat(outputs).float())
            loss = ctc_loss(logits, 1.0 - mask.float(), batch["labels"],
                            1.0 - batch["label_mask"].float(),
                            blank_id=cfg.pad_token_id).mean()
            loss.backward()
            loss = loss.detach()
        else:
            for out in outputs:
                g = coll.recv(out.shape, out.dtype, out.device, ranks[s + 1],
                              group)
                torch.autograd.backward(out, g)
            loss = torch.empty((), device=feats.device)
        if s > 0:
            for h in inputs:
                coll.send(h.grad, ranks[s - 1], group)
        state.optimizer.step()
        state.step += 1
        return state, coll.broadcast_(loss, ranks[-1], group)

    return step
