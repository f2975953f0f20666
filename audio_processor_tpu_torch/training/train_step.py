"""CTC fine-tuning step (port of training/train_step.py).

CTC loss with ``optax.ctc_loss``'s per-sequence semantics, AdamW with
optax.adamw's defaults, SpecAugment, and an eager train step. The forward
always runs the plain ``"xla"`` attention, as the JAX train step does:
the attention kernels have no backward, and their wrappers refuse
operands that require grad.

Under a mesh of processes (parallel/mesh.py, one process per device) the
step is the JAX step's dp x sp x tp program with explicit collectives:
each rank takes its rows of the global batch ('data': DDP averages the
gradients over the group), 1/sp of their frames ('seq': gradients summed
over the group, whose ranks hold parts of the same rows) and H/tp heads
and FFN/tp columns ('model'). ``zero1`` partitions the Adam moments over
'data' (``ZeroRedundancyOptimizer``). The loss it returns is the global
batch's mean on every rank, as the JAX step's.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_processor_tpu_torch.models.wav2vec2bert import (
    W2VBertConfig, Wav2Vec2Bert, params_from_jax,
)
from audio_processor_tpu_torch.parallel import collectives as coll

# optax.ctc_loss's stand-in for log(0): a path that needs a forbidden
# transition pays this per transition instead of being impossible.
LOG_EPSILON = -1e5


@dataclasses.dataclass
class TrainState:
    """The model (this rank's shard under tensor parallel), its optimizer
    (a ``ZeroRedundancyOptimizer`` under ZeRO-1), the step, and under a
    mesh the mesh and the module that runs the forward (DDP's wrapper
    when 'data' has several ranks)."""

    model: Wav2Vec2Bert
    optimizer: torch.optim.Optimizer
    step: int = 0
    mesh: Any = None
    module: Optional[nn.Module] = None


class SpecAugment(NamedTuple):
    """SpecAugment spans on the fbank features (the training-time
    masking HF's Wav2Vec2Bert applies when apply_spec_augment=True)."""

    num_time_masks: int = 2
    time_mask_span: int = 10     # 10 x 20 ms frames = 200 ms
    num_freq_masks: int = 2
    freq_mask_span: int = 10     # mel bins (masked in BOTH sub-frames)
    mel_bins: int = 80           # the stacked-feature period (fbank)


def spec_augment(gen: torch.Generator, feats: torch.Tensor,
                 aug: SpecAugment, row_start: int = 0,
                 global_rows: Optional[int] = None) -> torch.Tensor:
    """Randomly zero time spans and mel bands of [B, T, F] feats, with
    span starts drawn from ``gen`` (on feats' device): the time starts
    [B, num_time_masks] first, then the band starts [B, num_freq_masks].
    When ``feats`` are rows ``row_start`` .. of a global batch of
    ``global_rows``, the starts of every global row are drawn and these
    rows keep theirs, so each data-parallel rank masks what a
    single-device step would.

    The 160-dim features are TWO stacked 80-mel frames, so a frequency
    band is masked modulo ``mel_bins``, zeroing both sub-frames."""
    B, T, F_ = feats.shape
    G = global_rows or B
    dev = feats.device
    bins = aug.mel_bins if F_ % aug.mel_bins == 0 else F_

    def span_mask(n_masks, span, size, idx_vals):
        if n_masks <= 0 or span <= 0:
            return torch.zeros((B,) + idx_vals.shape, dtype=torch.bool,
                               device=dev)
        starts = torch.randint(0, max(1, size - span + 1), (G, n_masks),
                               generator=gen, device=dev)
        starts = starts[row_start:row_start + B]
        idx = idx_vals[None, None, :]
        hit = (idx >= starts[:, :, None]) & (idx < starts[:, :, None] + span)
        return hit.any(dim=1)                            # [B, len(idx)]

    tmask = span_mask(aug.num_time_masks, aug.time_mask_span, T,
                      torch.arange(T, device=dev))
    fmask = span_mask(aug.num_freq_masks, aug.freq_mask_span, bins,
                      torch.arange(F_, device=dev) % bins)
    drop = tmask[:, :, None] | fmask[:, None, :]
    return feats.masked_fill(drop, 0.0)


def step_generator(augment_seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The SpecAugment generator of one step, seeded from (augment_seed,
    step) alone (the JAX step's ``fold_in(PRNGKey(augment_seed),
    step)``), so a resumed run draws what an unbroken one would."""
    seed = np.random.SeedSequence([augment_seed, step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def make_optimizer(learning_rate: float = 1e-5,
                   weight_decay: float = 0.01
                   ) -> Callable[[Any], torch.optim.AdamW]:
    """A factory of AdamW over given parameters with optax.adamw's
    defaults: betas (0.9, 0.999), eps 1e-8 outside the square root
    (optax's eps_root 0), decoupled decay on every parameter."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def _ctc_recursion(logprobs: torch.Tensor, logit_paddings: torch.Tensor,
                   labels: torch.Tensor, label_lengths: torch.Tensor,
                   blank_id: int) -> torch.Tensor:
    """optax.ctc_loss's forward recursion, step for step, in log space
    with its ``log_epsilon`` floor: finite where a row's labels cannot
    fit its frames, and for any padding pattern. One step per frame, so
    it is kept for the rows ``F.ctc_loss`` cannot take. It runs in
    float64: at a loss of ~1e5, fp32's step (2^-7) would make the
    gradients differ by ~1e-3 between two summation orders."""
    B, T, _ = logprobs.shape
    N = labels.shape[1]
    logprobs = logprobs.double()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).double(), (0, 1))
    lp_phi = logprobs[:, :, blank_id]                          # [B, T]
    lp_emit = logprobs.gather(2, labels[:, None, :].expand(B, T, N))
    phi = torch.full((B, N + 1), LOG_EPSILON, dtype=torch.float64,
                     device=logprobs.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), LOG_EPSILON, dtype=torch.float64,
                      device=logprobs.device)

    def add_phi(phi, score):             # phi[:, 1:] (+) score, in log space
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)],
                         dim=1)

    for t in range(T):
        prev_phi = add_phi(phi, emit + LOG_EPSILON * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[:, t],
                                    emit + lp_emit[:, t])
        next_phi = add_phi(prev_phi + lp_phi[:, t, None],
                           emit + lp_phi[:, t, None]
                           + LOG_EPSILON * (1.0 - repeat))
        pad = logit_paddings[:, t, None]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi + (1.0 - pad) * next_phi
    last = add_phi(phi, emit)
    return -last.gather(1, label_lengths[:, None]).squeeze(1).float()


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor,
             labels: torch.Tensor, label_paddings: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Per-sequence CTC loss [B] with ``optax.ctc_loss``'s semantics.

    logits [B, T, K]; logit_paddings [B, T] and label_paddings [B, N]
    (1.0 = padded); labels [B, N] right-padded. Computed on an fp32
    log_softmax(logits). Rows whose valid frames are a prefix and whose
    labels fit them (label length + adjacent repeats <= frames, frames >
    0) take ``F.ctc_loss``; the others, where ``F.ctc_loss`` would give
    inf and NaN gradients, take optax's recursion with its log-epsilon
    floor (finite, ~1e5 per forbidden transition; float64). The split is
    decided on the host from the paddings and labels."""
    B, T, _ = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    pad_t = logit_paddings.detach().float().cpu()
    lab = labels.detach().cpu()
    lab_len = N - label_paddings.detach().float().cpu().sum(1).long()
    frames = T - pad_t.sum(1).long()
    prefix = (pad_t[:, 1:] >= pad_t[:, :-1]).all(dim=1) if T > 1 \
        else torch.ones(B, dtype=torch.bool)
    repeats = ((lab[:, 1:] == lab[:, :-1])
               & (torch.arange(1, N)[None, :] < lab_len[:, None])).sum(1)
    fits = prefix & (frames > 0) & (lab_len + repeats <= frames)
    easy = torch.nonzero(fits).flatten()
    hard = torch.nonzero(~fits).flatten()
    parts = []
    if len(easy):
        e = easy.to(logits.device)
        parts.append(F.ctc_loss(logprobs[e].transpose(0, 1), labels[e],
                                frames[easy], lab_len[easy],
                                blank=blank_id, reduction="none"))
    if len(hard):
        h = hard.to(logits.device)
        parts.append(_ctc_recursion(logprobs[h], logit_paddings[h].double(),
                                    labels[h], lab_len[hard].to(h.device),
                                    blank_id))
    order = torch.cat([easy, hard]).argsort().to(logits.device)
    return torch.cat(parts)[order]


def ctc_loss_fn(model: Wav2Vec2Bert, batch: Dict[str, torch.Tensor],
                dtype: torch.dtype = torch.bfloat16, remat: bool = True,
                augment: Optional[SpecAugment] = None,
                gen: Optional[torch.Generator] = None,
                module: Optional[nn.Module] = None, row_start: int = 0,
                global_rows: Optional[int] = None) -> torch.Tensor:
    """Mean CTC loss over the batch.

    batch: features [B, T, 160], feature_mask [B, T] (1 = valid),
    labels [B, N] integer, label_mask [B, N] (1 = valid), all on the
    model's device; with ``augment``, ``gen`` draws the SpecAugment
    spans (of ``global_rows`` rows, these from ``row_start``). The
    forward runs through ``module`` (DDP's wrapper of ``model``) when
    given. The attention is always the plain ``"xla"`` path."""
    feats = batch["features"]
    if augment is not None:
        feats = spec_augment(gen, feats, augment, row_start, global_rows)
    mask = batch["feature_mask"]
    logits = (module or model)(feats, mask.bool(), dtype=dtype,
                               attention_impl="xla", remat=remat)
    per_seq = ctc_loss(logits, 1.0 - mask.float(), batch["labels"],
                       1.0 - batch["label_mask"].float(),
                       blank_id=model.cfg.pad_token_id)
    return per_seq.mean()


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _sum_grads(params, group) -> None:
    """Sum the gradients over ``group`` in one flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or coll.group_size(group) == 1:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    coll.all_reduce_(flat, group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               dtype: torch.dtype = torch.bfloat16,
               augment: Optional[SpecAugment] = None,
               augment_seed: int = 0, opt_shardings=None,
               times: Optional[dict] = None
               ) -> Tuple[TrainState, torch.Tensor]:
    """One AdamW step on the mean CTC loss (remat on, as in the JAX
    step); returns (state, loss), the loss a 0-dim tensor on the device.
    The step's gradients stay in the parameters' ``.grad``. With
    ``augment``, the SpecAugment generator comes from (augment_seed,
    state.step). With ``times`` (a dict), the device is synchronised at
    the step's start, after the backward and after the update, and
    ``times["fwd_bwd_s"]`` and ``times["opt_s"]`` are set (host clock).

    Under ``state.mesh`` the batch is this rank's rows of the global
    batch (``shard_batch``), whole in time; the loss returned is the
    global mean. ``opt_shardings`` (``mesh.opt_state_shardings``) must
    describe ``state.optimizer``'s partition."""
    mesh = state.mesh
    if opt_shardings is not None:
        from audio_processor_tpu_torch.parallel.mesh import (
            opt_state_shardings,
        )

        if mesh is None or opt_state_shardings(
                state.optimizer, state.model, mesh) != opt_shardings:
            raise ValueError("opt_shardings do not describe this state's "
                             "optimizer")
    dev = batch["features"].device
    B = batch["features"].shape[0]
    dp = mesh.axis_size("data") if mesh is not None else 1
    row_start = mesh.coordinate("data") * B if mesh is not None else 0
    gen = (step_generator(augment_seed, state.step, dev)
           if augment is not None else None)
    t0 = _sync(dev) if times is not None else 0.0
    state.optimizer.zero_grad(set_to_none=True)
    loss = ctc_loss_fn(state.model, batch, dtype=dtype, augment=augment,
                       gen=gen, module=state.module, row_start=row_start,
                       global_rows=B * dp)
    loss.backward()
    if mesh is not None:
        _sum_grads(state.model.parameters(), mesh.group("seq"))
    if times is not None:
        t1 = _sync(dev)
        times["fwd_bwd_s"] = t1 - t0
    state.optimizer.step()
    if times is not None:
        times["opt_s"] = _sync(dev) - t1
    state.step += 1
    loss = loss.detach()
    if dp > 1:
        loss = coll.all_reduce_(loss.clone(), mesh.group("data")) / dp
    return state, loss


def shard_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str,
                                                              torch.Tensor]:
    """This rank's rows of a global batch: the global batch's rows split
    into 'data' equal parts, in rank order (the JAX step's batch
    sharding over 'data')."""
    dp = mesh.axis_size("data")
    B = batch["features"].shape[0]
    if B % dp:
        raise ValueError(f"global batch of {B} rows over data={dp}")
    n = B // dp
    s = mesh.coordinate("data") * n
    return {k: v[s:s + n] for k, v in batch.items()}


def init_state(model: Wav2Vec2Bert, tx: Callable, mesh=None,
               zero1: bool = False) -> TrainState:
    """A TrainState over ``model`` with the optimizer ``tx`` builds
    (``make_optimizer``).

    With a mesh of processes, ``model`` (the whole weights, the same on
    every rank, on this rank's device) is sharded over 'model' and 'seq'
    (``mesh.shard_params``), wrapped in DDP over 'data' when that axis has
    several ranks, and ``zero1`` partitions the optimizer's moments over
    'data' (``ZeroRedundancyOptimizer`` around the same optimizer
    class and settings). A one-process mesh of several devices is refused:
    training runs one process per device."""
    if mesh is None or mesh.size == 1:
        return TrainState(model=model, optimizer=tx(model.parameters()))
    if not mesh.multi_process:
        raise ValueError(
            f"{mesh}: training over a mesh runs one process per device "
            "(launch with torchrun, or the JAX_* variables, and "
            "initialize_distributed)")
    from audio_processor_tpu_torch.parallel.mesh import shard_params

    shard_params(model, mesh)
    module = None
    dp = mesh.axis_size("data")
    if dp > 1:
        dev = next(model.parameters()).device
        module = nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            process_group=mesh.group("data"), broadcast_buffers=False,
            gradient_as_bucket_view=True)
    if zero1 and dp > 1:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        if not isinstance(tx, functools.partial):
            raise ValueError("zero1 needs the optimizer as a "
                             "functools.partial of its class "
                             "(make_optimizer)")
        optimizer = ZeroRedundancyOptimizer(
            list(model.parameters()), optimizer_class=tx.func,
            process_group=mesh.group("data"), **tx.keywords)
    else:
        optimizer = tx(model.parameters())
    return TrainState(model=model, optimizer=optimizer, mesh=mesh,
                      module=module)


def make_train_step(dtype: torch.dtype = torch.bfloat16,
                    augment: Optional[SpecAugment] = None,
                    augment_seed: int = 0, mesh=None,
                    opt_shardings=None) -> Callable:
    """``train_step`` with its settings bound: step(state, batch, times=
    None) -> (state, loss). With ``mesh``, the state must have been
    built over it (``init_state(mesh=...)``)."""
    step = functools.partial(train_step, dtype=dtype, augment=augment,
                             augment_seed=augment_seed,
                             opt_shardings=opt_shardings)
    if mesh is None:
        return step

    def sharded_step(state, batch, times=None):
        if state.mesh is not mesh:
            raise ValueError("the state was not built over this mesh")
        return step(state, batch, times=times)

    return sharded_step


def _local_optimizer(optimizer: torch.optim.Optimizer):
    """ZeRO-1's local optimizer (over this rank's partition), or the
    optimizer itself."""
    return getattr(optimizer, "optim", optimizer)


def named_moments(state: TrainState) -> Dict[str, Any]:
    """The optimizer's Adam state by parameter name: {"exp_avg": {name:
    tensor}, "exp_avg_sq": {...}, "step": int} (empty before the first
    step). Under ZeRO-1, the parameters this rank owns; under tensor
    parallel, this rank's slices."""
    out = {"exp_avg": {}, "exp_avg_sq": {}, "step": 0}
    opt = _local_optimizer(state.optimizer)
    for name, p in state.model.named_parameters():
        st = opt.state.get(p)
        if st:
            out["exp_avg"][name] = st["exp_avg"]
            out["exp_avg_sq"][name] = st["exp_avg_sq"]
            out["step"] = int(st["step"])
    return out


def moments_from_jax(opt_state_np: Any, cfg: W2VBertConfig
                     ) -> Dict[str, Any]:
    """optax.adamw's state (leaves as numpy arrays) -> the form of
    :func:`named_moments`: ``mu``/``nu`` mapped onto ``exp_avg``/
    ``exp_avg_sq`` by parameter name (through ``params_from_jax``) and
    ``count`` onto ``step``."""
    def find(tree):
        if hasattr(tree, "mu") and hasattr(tree, "nu"):
            return tree
        if isinstance(tree, (tuple, list)):
            for sub in tree:
                hit = find(sub)
                if hit is not None:
                    return hit
        return None

    adam = find(opt_state_np)
    if adam is None:
        raise ValueError("no Adam moments (mu, nu) in the optimizer state")
    return {"exp_avg": params_from_jax(adam.mu, cfg),
            "exp_avg_sq": params_from_jax(adam.nu, cfg),
            "step": int(np.asarray(adam.count))}


def gather_train_state(state: TrainState) -> Optional[Dict[str, Any]]:
    """The single-device resume point of a sharded state: {"model": the
    whole state dict, "optimizer": a state dict of the unsharded model's
    optimizer, "step"}, on global rank 0 (None elsewhere). Collective:
    every rank calls it. Under ZeRO-1 each parameter's moments are
    broadcast over 'data' from the rank that owns them (as tensors:
    ``ZeroRedundancyOptimizer.consolidate_state_dict`` pickles them,
    which takes minutes at 0.58 B parameters); tensor-parallel slices are
    gathered over 'model'."""
    mesh = state.mesh
    if mesh is None:
        return {"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}
    from audio_processor_tpu_torch.parallel.mesh import (
        opt_state_shardings, unshard_tensor, w2v_param_specs,
    )

    local = _local_optimizer(state.optimizer)
    named = list(state.model.named_parameters())
    zero = local is not state.optimizer
    # The owners of the moments, checked against this rank's partition.
    owners = (opt_state_shardings(state.optimizer, state.model, mesh)
              if zero else None)
    data_ranks = mesh.group_ranks("data")
    moments = []
    for name, p in named:
        st = local.state.get(p) or {}
        if zero and state.step > 0:
            src = data_ranks[owners[name]["owner"]]
            st = {k: coll.broadcast_(st[k] if st else torch.empty_like(p),
                                     src, mesh.group("data"))
                  for k in ("exp_avg", "exp_avg_sq")}
        moments.append(st)
    if mesh.coordinate("data") or mesh.coordinate("seq"):
        return None
    specs = w2v_param_specs(state.model.cfg)
    dev = mesh.local_device

    def whole(t, spec):
        return unshard_tensor(t.to(dev), spec, mesh).cpu()

    model_sd = {n: whole(t, specs[n]) if n in specs else t.cpu()
                for n, t in state.model.state_dict().items()}
    opt_state = {}
    for i, ((name, _), st) in enumerate(zip(named, moments)):
        if st:
            opt_state[i] = {"step": torch.tensor(float(state.step)),
                            **{k: whole(st[k], specs[name])
                               for k in ("exp_avg", "exp_avg_sq")}}
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": list(range(len(named)))}
              for g in local.param_groups]
    if mesh.coordinate("model"):
        return None
    return {"model": model_sd,
            "optimizer": {"state": opt_state, "param_groups": groups},
            "step": state.step}


def scatter_train_state(state: TrainState, blob: Dict[str, Any]
                        ) -> TrainState:
    """Load a single-device resume point (``gather_train_state``'s or one
    device's) into a sharded ``state``: each rank keeps its slices, and
    ZeRO-1 its partition of the moments."""
    from audio_processor_tpu_torch.parallel.mesh import (
        shard_tensor, w2v_param_specs,
    )

    mesh = state.mesh
    specs = w2v_param_specs(state.model.cfg)
    names = [n for n, _ in state.model.named_parameters()]
    state.model.load_state_dict({
        n: shard_tensor(t, specs[n], mesh) if n in specs else t
        for n, t in blob["model"].items()})
    osd = blob["optimizer"]
    local = {"state": {}, "param_groups": osd["param_groups"]}
    for i, st in osd["state"].items():
        local["state"][i] = {
            k: shard_tensor(v, specs[names[i]], mesh).contiguous()
            if torch.is_tensor(v) and v.dim() else v for k, v in st.items()}
    state.optimizer.load_state_dict(local)
    state.step = int(blob["step"])
    return state
