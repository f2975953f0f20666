"""Driver of the Kimi-Linear cell: the topics cell's driver
(:mod:`.batch_topics`: the production stack with ``topic_backend: local``,
its window, sweeps, set-up, spans and end-to-end metrics) with the topic
LM at Kimi-Linear-48B-A3B's widths (``models/moe_lm.py`` with the KDA
layers of ``models/kda.py``, NoPE MLA and 128 of the router's 256 experts
held), so that every analysis batch's calls are summarised and classified
by the hybrid on the card through ``SentimentAnalyzer`` →
``TopicClassifier.infer_batch``, selected by ``topic_model`` alone.

The KDA layer is imported first: a program without it fails here, at once.

What differs from :mod:`.batch_topics`, which this module's :func:`run`
hands over to for the whole run with two of its functions replaced (its
set-up's ``build_lm`` and its comparison's ``check_topics``):

- the weights (:func:`lm_layout`, :func:`draw`): the program's parameter
  names at the configuration's widths, each tensor from a generator of its
  own seeded by (seed, name), the KDA layers' A_log, dt_bias and conv
  kernels as ``models/kda.py::stand_in`` draws them;
- the comparison (:func:`check_kimi`) against the plain reference
  ``reference/kimi_linear.py`` (fp32, TF32 off, each sequence alone, the
  KDA layers token by token): the topics cell's checks on the sampled
  analysis batch's first tokens and ``STEPS`` tapped decode steps (the
  class prompt has two) and routes, over every summary row and
  :data:`CLASS_ROWS` seeded class rows (the recurrence over a ≈ 3,960-token
  class prompt takes seconds a row), and ``kda_state_rel_mse``: every KDA
  layer's state after the prefill of the first row of each prompt kind, Σ
  ||S − S_ref||² over Σ ||S_ref||², where S_ref is the reference's KDA
  layer run on the program's own input to that layer with its projections'
  outputs held in bf16, the configuration's dtype (``reference.kda``'s
  ``held``), so that the check sees the state's own arithmetic: against
  the whole fp32 forward the 27-layer bf16 residual stream's error, which
  reaches the states through every layer's input, hides a bf16 state
  (PERF.md; that comparison's ratio is kept as the reading
  ``kda_state_e2e_rel_mse``);
- the controls (``job.control``, chosen by the mix's ``control`` key,
  ``control_kimi.py``): ``bf16_state`` holds the KDA state in bf16
  between the prefill's chunks and between decode steps;
  ``skip_decay`` gives the prefill a state pass that skips the decay of
  each row's last chunk.
"""

from audio_processor_tpu_torch.models import kda   # noqa: I001 first

import contextlib
import math
import random
import time
from typing import Dict

import torch

from audio_processor_tpu_torch.models import moe_lm

from . import batch_topics, check, weights
from .batch import Run
from .job import Job
from .spans import Recorder
from ..reference import kimi_linear as ref_kimi

STEPS = batch_topics.STEPS
KINDS = batch_topics.KINDS
ROUTE_TIE_TOL = batch_topics.ROUTE_TIE_TOL
STD, WIDE_STD, BIAS_STD = (batch_topics.STD, batch_topics.WIDE_STD,
                           batch_topics.BIAS_STD)
CLASS_ROWS = 2        # seeded class rows the reference recomputes
CONTROLS = ("bf16_state", "skip_decay")


def lm_layout(m: moe_lm.MoELMConfig) -> weights.Layout:
    """Parameter names, shapes and kinds of the program's ``MoELM`` at
    Kimi-Linear's layout: "normal", "wide", "ones", "zeros", "bias",
    "conv", "a_log", "dt_bias"."""
    h, nh, f = m.hidden_size, m.num_attention_heads, m.moe_intermediate_size
    H, D, K = m.kda_num_heads, m.kda_head_dim, m.kda_conv_size
    W = H * D
    out = [("embed_tokens.weight", (m.vocab_size, h), "normal")]
    for i in range(m.num_hidden_layers):
        p = f"layers.{i}"
        a = f"{p}.self_attn"
        out += [(f"{p}.input_layernorm.weight", (h,), "ones"),
                (f"{p}.post_attention_layernorm.weight", (h,), "ones")]
        if m.is_kda(i):
            out += [(f"{a}.in_proj.weight", (3 * W + 2 * D + H, h), "normal"),
                    (f"{a}.conv_weight", (3 * W, K), "conv"),
                    (f"{a}.fg_b", (2, W, D), "normal"),
                    (f"{a}.g_bias", (W,), "zeros"),
                    (f"{a}.A_log", (H,), "a_log"),
                    (f"{a}.dt_bias", (W,), "dt_bias"),
                    (f"{a}.o_norm", (D,), "ones"),
                    (f"{a}.o_proj.weight", (h, W), "normal")]
        else:
            out += [(f"{a}.q_proj.weight", (nh * m.qk_head_dim, h), "wide"),
                    (f"{a}.kv_a_proj_with_mqa.weight", (m.latent_dim, h),
                     "normal"),
                    (f"{a}.kv_a_layernorm.weight", (m.kv_lora_rank,),
                     "ones"),
                    (f"{a}.kv_b_proj.weight",
                     (nh * (m.qk_nope_head_dim + m.v_head_dim),
                      m.kv_lora_rank), "wide"),
                    (f"{a}.o_proj.weight", (h, nh * m.v_head_dim), "wide")]
        if not m.is_moe(i):
            w = m.intermediate_size
            out += [(f"{p}.mlp.gate_up_proj.weight", (2 * w, h), "normal"),
                    (f"{p}.mlp.down_proj.weight", (h, w), "normal")]
            continue
        E, s = m.held_experts, f * m.n_shared_experts
        out += [(f"{p}.mlp.gate.weight", (m.n_routed_experts, h), "normal"),
                (f"{p}.mlp.gate.e_score_correction_bias",
                 (m.n_routed_experts,), "bias"),
                (f"{p}.mlp.experts.gate_up_proj", (E, 2 * f, h), "normal"),
                (f"{p}.mlp.experts.down_proj", (E, h, f), "normal"),
                (f"{p}.mlp.shared_experts.gate_up_proj.weight", (2 * s, h),
                 "normal"),
                (f"{p}.mlp.shared_experts.down_proj.weight", (h, s),
                 "normal")]
    out += [("norm.weight", (h,), "ones"),
            ("lm_head.weight", (m.vocab_size, h), "normal")]
    return out


def draw(name: str, shape, kind: str, seed: int, device) -> torch.Tensor:
    """One parameter, from a generator of its own seeded by (seed, name):
    bf16, the correction bias, A_log and dt_bias fp32."""
    if kind in ("ones", "zeros"):
        return (torch.ones if kind == "ones" else torch.zeros)(
            shape, dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(
        weights.sub_seed(seed, name))
    fp32 = kind in ("bias", "a_log", "dt_bias")
    t = torch.empty(shape, device=device,
                    dtype=torch.float32 if fp32 else torch.bfloat16)
    if kind == "a_log":
        kda.stand_in("A_log", t, gen)
    elif kind == "dt_bias":
        kda.stand_in("dt_bias", t, gen)
    elif kind == "conv":
        kda.stand_in("conv_weight", t, gen)
    else:
        std = {"normal": STD, "wide": WIDE_STD, "bias": BIAS_STD}[kind]
        t.normal_(0.0, std, generator=gen)
    return t


def build_lm(m: moe_lm.MoELMConfig, seed: int, device) -> moe_lm.MoELM:
    """The program's model over the drawn weights."""
    sd = {n: draw(n, s, k, seed, device) for n, s, k in lm_layout(m)}
    with torch.device("meta"):
        model = moe_lm.MoELM(m)
    model.cast(torch.bfloat16)
    model.load_state_dict(sd, assign=True, strict=True)
    del sd
    return model.eval()


class _Lazy(dict):
    def __init__(self, kinds, seed, device):
        super().__init__()
        self.kinds, self.seed, self.device = kinds, seed, device

    def __missing__(self, name):
        shape, kind = self.kinds[name]
        return draw(name, shape, kind, self.seed, self.device)


def lm_getter(m: moe_lm.MoELMConfig, seed: int, device):
    """``get(name)`` for the reference: each parameter drawn again from the
    seed and upcast to fp32, the last layer read kept."""
    kinds = {n: (s, k) for n, s, k in lm_layout(m)}
    return ref_kimi.layer_params(_Lazy(kinds, seed, device), device)


def check_kimi(job: Job, m: moe_lm.MoELMConfig, tapped: Dict, seed: int,
               device) -> Dict[str, Dict]:
    """The sampled analysis batch's logits, expert choices and KDA states
    against the reference (see the module's notes)."""
    t0 = time.perf_counter()
    lim = job.limits
    names = ("topic_logit_rel_mse", "topic_step_rel_mse_max",
             "topic_not_argmax", "route_mismatch", "kda_state_rel_mse")
    if any(tapped.get(kind) is None for kind in KINDS):
        job.say(f"[check] topic LM: taps of {sorted(tapped)}, not of both "
                f"{KINDS}")
        return {k: check._entry(math.inf, lim[k]) for k in names}
    rng = random.Random(weights.sub_seed(job.seed, "kimi-reference-rows"))
    seqs, at, hints, prog, served, keep, states = [], [], [], [], [], [], []
    chosen = {}
    for kind in KINDS:
        t = tapped[kind]
        ids = t["ids"]
        steps = sorted(t["steps"])
        last = max(steps, default=0)
        R = len(t["prompts"])
        rows = set(range(R)) if kind == "summary" else set(
            rng.sample(range(R), min(CLASS_ROWS, R)))
        chosen[kind] = sorted(rows)
        start = 0
        for r, p in enumerate(t["prompts"]):
            L = len(p)
            if r in rows:
                seqs.append(list(p) + ids[r, :last].tolist())
                at.append([L - 1] + [L - 1 + s for s in steps])
                keep.append(L - 1)
                pre = t["prefill_routes"][:, start:start + L]
                dec = t["decode_routes"][:last, :, r].transpose(0, 1)
                hints.append({layer: torch.cat([pre[j], dec[j]]).long()
                              for j, layer in enumerate(m.moe_layers)})
                prog.append(torch.stack([t["first_logits"][r]]
                                        + [t["steps"][s][r] for s in steps]))
                served.append([int(ids[r, 0])]
                              + [int(ids[r, s]) for s in steps])
                states.append(t["kda_state"][:, r])
            start += L
    with torch.inference_mode():
        r = ref_kimi.forward(lm_getter(m, seed, device), job.config, seqs,
                             at, hints, ROUTE_TIE_TOL, device=device,
                             keep_at=keep)
    err = ref_sq = step_err = step_sq = 0.0
    step_max = -math.inf
    not_argmax = 0
    for p, lg, sv in zip(prog, r["logits"], served):
        lg = lg.double().cpu()
        d = (p.double() - lg).pow(2).sum(-1)
        q = lg.pow(2).sum(-1)
        err += float(d.sum())
        ref_sq += float(q.sum())
        if len(d) > 1:
            step_err += float(d[1:].sum())
            step_sq += float(q[1:].sum())
            step_max = max(step_max, float((d[1:] / q[1:]).max()))
        not_argmax += sum(int(a) != b for a, b in
                          zip(p.argmax(-1).tolist(), sv))
    e2e = _rel_mse(states, r["kda_states"])
    # the first row's states, the reference's KDA layers on its inputs
    get = lm_getter(m, seed, device)
    forced, ref_forced = [], []
    with torch.inference_mode(), ref_kimi.no_tf32():
        for j, layer in enumerate(m.kda_layers):
            for kind in KINDS:
                t = tapped[kind]
                x = t["kda_inputs"][j]
                _, S = ref_kimi.kda(get, f"layers.{layer}.self_attn",
                                    job.config, x.to(device).float(),
                                    keep_at=x.shape[0] - 1,
                                    held=torch.bfloat16)
                forced.append(t["kda_state"][j, 0])
                ref_forced.append(S)
    state_err = _rel_mse(forced, ref_forced)
    out = {
        "topic_logit_rel_mse": check._entry(
            err / ref_sq if ref_sq > 0 else math.inf,
            lim["topic_logit_rel_mse"]),
        "topic_step_rel_mse_max": check._entry(
            step_max if step_sq > 0 else math.inf,
            lim["topic_step_rel_mse_max"]),
        "topic_not_argmax": check._entry(not_argmax,
                                         lim["topic_not_argmax"]),
        "route_mismatch": check._entry(r["route_mismatch"],
                                       lim["route_mismatch"]),
        "kda_state_rel_mse": check._entry(state_err,
                                          lim["kda_state_rel_mse"])}
    job.readings["kda_state_e2e_rel_mse"] = e2e
    job.readings["topic_step_rel_mse"] = step_err / step_sq \
        if step_sq > 0 else None
    job.readings["route_ties"] = r["route_ties"]
    gaps = r["route_gaps"]
    job.readings["route_gap_max"] = float(gaps.max()) if gaps.numel() \
        else 0.0
    job.readings["route_decisions"] = sum(
        len(s) for s in seqs) * len(m.moe_layers)
    job.say(f"[check] topic LM: {len(seqs)} sequences (summary rows "
            f"{chosen['summary']}, class rows {chosen['class']}), "
            f"{sum(len(s) for s in seqs)} tokens, route ties "
            f"{r['route_ties']}, reference {time.perf_counter() - t0:.2f} s")
    return out


def _rel_mse(got, want) -> float:
    """Σ ||got − want||² over Σ ||want||² of paired tensors (inf without
    any)."""
    err = sq = 0.0
    for a, b in zip(got, want):
        b = b.double()
        err += float((a.to(b.device).double() - b).pow(2).sum())
        sq += float(b.pow(2).sum())
    return err / sq if sq > 0 else math.inf


def state_pass_control(bf16_state: bool = False, skip_last: bool = False):
    """``kda.state_pass`` for a control: the state rounded to bf16 after
    every chunk, or the decay of each row's last chunk (the last whose
    decay is not 1: padding decays nothing) left out."""
    def state_pass(u, w, qg, aqk, kd, decay):
        C, R, H = u.shape[:3]
        S = u.new_zeros(R, H, kd.shape[-1], u.shape[-1])
        o = torch.empty_like(u)
        real = (decay < 1).any(-1).any(-1)             # [C, R]
        last = torch.where(real, torch.arange(C, device=u.device)[:, None],
                           -1).amax(0)
        for c in range(C):
            vn = u[c] - w[c] @ S
            o[c] = qg[c] @ S + aqk[c] @ vn
            d = decay[c, ..., None]
            if skip_last:
                d = torch.where((last == c)[:, None, None, None], 1.0, d)
            S = S * d + kd[c].transpose(-1, -2) @ vn
            if bf16_state:
                S = S.bfloat16().float()
        return o, S
    return state_pass


@contextlib.contextmanager
def _patched(job: Job):
    """This driver's weights and comparison in :mod:`.batch_topics`'s run,
    and the control's changes to the program under ``job.control``."""
    saved = [(batch_topics, "build_lm", build_lm),
             (batch_topics, "check_topics", check_kimi)]
    if job.control:
        which = job.mix.get("control", CONTROLS[0])
        if which not in CONTROLS:
            raise ValueError(f"control {which!r}: expected one of "
                             f"{CONTROLS}")
        job.say(f"[control] {which}")
        if which == "bf16_state":
            decode = kda.KimiDeltaAttention.decode

            def bf16_decode(self, x, state, conv_state):
                out = decode(self, x, state, conv_state)
                state.copy_(state.to(torch.bfloat16))
                return out

            saved += [(kda, "state_pass", state_pass_control(True)),
                      (kda.KimiDeltaAttention, "decode", bf16_decode)]
        else:
            saved.append((kda, "state_pass",
                          state_pass_control(skip_last=True)))
    old = [(obj, name, getattr(obj, name)) for obj, name, _ in saved]
    try:
        for obj, name, new in saved:
            setattr(obj, name, new)
        yield
    finally:
        for obj, name, value in old:
            setattr(obj, name, value)


def run(job: Job) -> Dict:
    """One run of the Kimi-Linear cell; returns the result object."""
    dev = torch.device(job.device)
    m_asr = dict(job.config["model"])
    rec = Recorder()
    runrec = Run(job, rec, m_asr)
    with _patched(job):
        return batch_topics._run(job, dev, dev.type == "cuda", m_asr,
                                 job.tmp, rec, runrec)
