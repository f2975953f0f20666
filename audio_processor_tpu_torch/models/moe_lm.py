"""A decoder-only mixture-of-experts language model with multi-head latent
attention: the DeepSeek-V3 block (HF ``model_type: deepseek_v3``) as
moonshotai/Moonlight-16B-A3B publishes it, decoded greedily.

Each of ``num_hidden_layers`` layers computes, for an input x,
``h = x + MLA(RMSNorm(x))`` and ``out = h + FFN(RMSNorm(h))``; FFN is a
SiLU-gated MLP of width ``intermediate_size`` in the first
``first_k_dense_replace`` layers and the MoE in the others. A final
RMSNorm and an untied head give the logits.

- :class:`RMSNorm`: normalised and times the gain in fp32, rounded once to
  the input's dtype (HF ``DeepseekV3RMSNorm`` rounds before the gain).
- :class:`LatentAttention` (MLA without a q LoRA): q = W_q x̂ split per head
  into q_nope and q_pe; [c, k_pe] = W_kva x̂, c = RMSNorm_kv(c); k_pe is
  shared by the heads. RoPE (``rope_theta``, no scaling) rotates q_pe and
  k_pe in DeepSeek-V3's pairing: each head vector's even and odd elements
  are first gathered into halves, then ``rotate_half``. [k_nope, v] =
  W_kvb c per head; the score is (q_nope·k_nope + q_pe·k_pe) / sqrt(nope +
  rope) under a causal softmax in fp32, then W_o. The cache holds c and
  the rotated k_pe, ``kv_lora_rank + qk_rope_head_dim`` values per token
  and layer. The prefill runs the expanded form (k_nope and v from c, one
  causal SDPA per row); a decode step runs the absorbed form: q̃ =
  q_nope·W_kvb,k[h], scores q̃·c + q_pe·k_pe over the row's cache, o_lat =
  P·c, o_h = W_kvb,v[h]·o_lat; on the card the RoPEs, the latent norm and
  the cache write are one kernel and the attention over the latent cache
  one more (``models/mla_decode.py``).
- :class:`MoE`: scores s = sigmoid(W_g x̂) in fp32; the top
  ``num_experts_per_tok`` by s + b (b the correction bias, ``noaux_tc``;
  with ``n_group`` = ``topk_group`` = 1 the group limit keeps every
  expert); each chosen expert weighted by its own s, renormalised over the
  chosen (``norm_topk_prob``) and times ``routed_scaling_factor``; plus the
  ``n_shared_experts`` shared experts as one MLP of their summed width. The
  routed experts run as two grouped GEMMs (``torch._grouped_mm``) over the
  token copies sorted by expert, with the group offsets on the device, so
  no step waits on the host.

The hybrid of Kimi-Linear-48B-A3B (HF ``model_type: kimi_linear``) runs on
the same block: the layers ``linear_attn_config`` names (1-based
``kda_layers``) mix tokens by Kimi Delta Attention (``models/kda.py``)
instead of MLA, and with ``mla_use_nope`` the MLA layers rotate nothing
(k_pe is still cached, unrotated). :meth:`MoELMConfig.from_dict` reads
Kimi's own key names.

The expert share: ``n_held_experts`` (Kimi's ``num_experts`` in a
configuration that states ``expert_parallel.router_experts``) of the
``n_routed_experts`` the router scores are held here, from
``first_held_expert`` on, as one chip of an expert-parallel deployment
holds them. The router keeps its published width and top k, the chosen
weights are normalised over all k, and then the copies whose expert is not
held are dropped: the layer gives the part of the routed result its own
experts give, plus the shared experts (which every chip runs). The
exchange with the chips that hold the others is not part of this module.

Generation (:meth:`MoELM.generate`): the prompts of a batch are ragged
rows, packed for every token-wise product (no padding) and attended one
row at a time in the prefill, which fills each row's latent cache and
gives its first token. Each row then decodes greedily to ``eos_token_id``
or to ``max_new`` tokens, whichever comes first, at its own position held
on the device; finished rows are frozen on the device, so the loop runs
``max_new - 1`` steps and no step waits on the card. On a CUDA device each
step replays one CUDA graph per (rows, cache capacity, dtype) key
(``models/cuda_graphs.py``, as the encoder and the s2t decoder do); the
capacity is the rows' longest prompt plus ``max_new``, rounded up to
:data:`CACHE_ALIGN` positions, never the prompt length itself, and a step
attends over that many positions of each row's cache. The rows of one
count share one cache of :attr:`MoELMConfig.positions` positions, which
every capacity's graph reads a leading part of. A prompt that needs more
than :attr:`MoELMConfig.positions` positions (``max_position_embeddings``,
at most the MLA kernel's :data:`MAX_POSITIONS`) is refused. The KDA layers
keep a fixed state a row instead: [H, D, D] fp32 and the last K−1 conv
inputs, written by the prefill and updated in place by each step.

Spans (``obs/profiler.py``): ``topics.prefill`` (``kind``, ``rows``,
``tokens`` real, ``padded`` the tokens the products ran over, ``lengths``
of the prompts), ``topics.decode`` (``kind``, ``rows``, ``steps``, ``cap``
the tokens a row may emit, ``lengths``, ``tokens`` emitted,
``experts_touched``: the distinct experts each step's rows routed to,
summed over the MoE layers and the steps, tallied on the device inside the
step and read once at the loop's end) and ``topics.graph`` (``mode``
capture / replay / eager, ``rows``, ``capacity``, ``steps``,
``mla_launches`` and ``kda_launches``: the MLA attention kernel's and the
KDA decode kernel's launches in its steps); ``topics.decode`` also carries
``state_bytes`` (the KDA states' bytes) and ``experts_held`` (per MoE
layer); each KDA layer's prefill is a ``topics.kda_prefill`` span
(``models/kda.py``).

Precision: the weights live in the compute dtype (bf16 on the card), but
the MoE correction bias stays fp32; the router, the RMSNorm statistics,
RoPE and the softmax run in fp32. Weights are the seeded stand-ins of
:func:`build_synthetic` until the published checkpoint is in the
repository.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import (Any, Callable, Collection, Dict, List, Optional,
                    Sequence, Tuple)

import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_processor_tpu_torch.models import (_cuda_call, cuda_graphs, kda,
                                              mla_decode)
from audio_processor_tpu_torch.obs import profiler

CACHE_ALIGN = 512     # the latent cache's capacity is a multiple of this
MAX_POSITIONS = mla_decode.MAX_CAPACITY   # positions a decode state holds
# With every weight N(0, 0.02) attention over a long prompt is near uniform
# and a cache or mask fault hardly moves the logits. The stand-in weights
# draw the attention's q, W_kvb and W_o this many times wider: peaked
# attention (scores of std ≈ 1.6 at the published widths) whose output
# weighs in the residual stream. Three times wider makes the scores so
# peaked (std ≈ 3.3) that bf16 rounding alone moves the logits as much as
# fp8 experts do (PERF.md).
ATTENTION_SCALE = 2.0
# Std of the stand-in correction bias: about a quarter of the spread of the
# sigmoid scores, so the biased choice and the unbiased weights differ.
BIAS_STD = 0.05


@dataclasses.dataclass(frozen=True)
class MoELMConfig:
    """The widths of HF ``DeepseekV3Config`` (defaults: Moonlight-16B-A3B's
    published ``config.json``) and the special ids the tokenizer reserves."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    bos_token_id: int = 163584
    eos_token_id: int = 163585
    # the expert share: experts held here (None: all), from this one on
    n_held_experts: Optional[int] = None
    first_held_expert: int = 0
    # the hybrid: 0-based layers of Kimi Delta Attention, its widths, and
    # MLA without rotation
    kda_layers: Tuple[int, ...] = ()
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    kda_conv_size: int = 4
    mla_use_nope: bool = False

    def __post_init__(self):
        object.__setattr__(self, "kda_layers",
                           tuple(sorted(int(i) for i in self.kda_layers)))
        unsupported = {
            "q_lora_rank": self.q_lora_rank is not None,
            "scoring_func": self.scoring_func != "sigmoid",
            "topk_method": self.topk_method != "noaux_tc",
            "n_group": self.n_group != 1 or self.topk_group != 1,
            "rope_scaling": bool(self.rope_scaling),
            "tie_word_embeddings": self.tie_word_embeddings,
            "attention_bias": self.attention_bias,
            "hidden_act": self.hidden_act != "silu",
            "moe_layer_freq": self.moe_layer_freq != 1,
            "num_key_value_heads": self.num_key_value_heads
            != self.num_attention_heads,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"moe_lm runs Moonlight-16B-A3B's block; unsupported: {bad}")
        held = self.held_experts
        if not (1 <= held and 0 <= self.first_held_expert
                and self.first_held_expert + held <= self.n_routed_experts):
            raise ValueError(
                f"experts held {self.first_held_expert} .. "
                f"{self.first_held_expert + held - 1} must lie among the "
                f"router's {self.n_routed_experts}")
        if any(not 0 <= i < self.num_hidden_layers for i in self.kda_layers):
            raise ValueError(f"kda_layers {self.kda_layers} outside "
                             f"{self.num_hidden_layers} layers")

    @property
    def held_experts(self) -> int:
        """Routed experts held here."""
        return self.n_routed_experts if self.n_held_experts is None \
            else self.n_held_experts

    @property
    def positions(self) -> int:
        """Positions a decode state holds: ``max_position_embeddings``, at
        most :data:`MAX_POSITIONS`."""
        return min(self.max_position_embeddings, MAX_POSITIONS)

    def is_kda(self, layer: int) -> bool:
        return layer in self.kda_layers

    @property
    def mla_layers(self) -> List[int]:
        return [i for i in range(self.num_hidden_layers)
                if not self.is_kda(i)]

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values per token and layer in the cache: c and the rotated
        k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace

    @property
    def moe_layers(self) -> List[int]:
        return [i for i in range(self.num_hidden_layers) if self.is_moe(i)]

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MoELMConfig":
        """The keys of ``d`` this class has (a ``config.json`` holds more),
        and Kimi-Linear's names for them: ``num_experts_per_token``,
        ``moe_router_activation_func``, ``moe_renormalize``,
        ``num_shared_experts``, ``num_expert_group``, ``model_max_length``,
        ``linear_attn_config`` (1-based ``kda_layers``, ``num_heads``,
        ``head_dim``, ``short_conv_kernel_size``) and ``num_experts``: the
        experts held here, of ``expert_parallel.router_experts`` (from
        ``expert_parallel.first_expert``) where the configuration states a
        share, else the router's width."""
        d = dict(d)
        for kimi, ours in (("num_experts_per_token", "num_experts_per_tok"),
                           ("moe_router_activation_func", "scoring_func"),
                           ("moe_renormalize", "norm_topk_prob"),
                           ("num_shared_experts", "n_shared_experts"),
                           ("num_expert_group", "n_group"),
                           ("model_max_length", "max_position_embeddings")):
            if kimi in d and ours not in d:
                d[ours] = d[kimi]
        if "num_experts" in d and "n_routed_experts" not in d:
            share = d.get("expert_parallel") or {}
            d["n_routed_experts"] = int(share.get("router_experts",
                                                  d["num_experts"]))
            d["n_held_experts"] = int(d["num_experts"])
            d["first_held_expert"] = int(share.get("first_expert", 0))
        lin = d.get("linear_attn_config")
        if lin and "kda_layers" not in d:
            d["kda_layers"] = [int(i) - 1 for i in lin["kda_layers"]]
            d["kda_num_heads"] = int(lin["num_heads"])
            d["kda_head_dim"] = int(lin["head_dim"])
            d["kda_conv_size"] = int(lin["short_conv_kernel_size"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """HF ``DeepseekV3RMSNorm`` as one fused kernel: fp32 statistics and
    gain, rounded once to x's dtype (HF rounds before the gain: the two
    differ by a rounding)."""
    return F.rms_norm(x, (x.shape[-1],), weight, eps)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def rope_tables(cfg: MoELMConfig, device: torch.device) -> tuple:
    """(cos, sin) [positions, qk_rope_head_dim] in fp32, as HF's rotary
    embedding builds them (frequencies repeated over the two halves)."""
    d = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                 device=device) / d))
    t = torch.arange(cfg.positions, dtype=torch.float32, device=device)
    emb = torch.cat([torch.outer(t, inv)] * 2, dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotation of x [..., d] (cos, sin broadcast to x): the
    even and odd elements gathered into halves, then x·cos +
    rotate_half(x)·sin, in fp32, rounded to x's dtype."""
    d = x.shape[-1]
    y = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    y1, y2 = y[..., :d // 2], y[..., d // 2:]
    rot = torch.cat([-y2, y1], dim=-1)
    return (y * cos + rot * sin).to(x.dtype)


class LatentAttention(nn.Module):
    """MLA without a q LoRA (HF ``DeepseekV3Attention``'s modules); with
    ``mla_use_nope`` q_pe and k_pe are not rotated, in prefill and decode
    alike."""

    def __init__(self, cfg: MoELMConfig):
        super().__init__()
        self.cfg = cfg
        h, nh = cfg.hidden_size, cfg.num_attention_heads
        self.nh = nh
        self.q_proj = nn.Linear(h, nh * cfg.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(h, cfg.latent_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(
            cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            bias=False)
        self.o_proj = nn.Linear(nh * cfg.v_head_dim, h, bias=False)
        self.scale = cfg.qk_head_dim ** -0.5
        self.rotate = not cfg.mla_use_nope

    def project(self, x, cos, sin):
        """x [T, H] at positions whose (cos, sin) are [T, rope] -> (q_nope
        [T, nh, nope], rotated q_pe [T, nh, rope], latent [T, kv_lora +
        rope]: the normalised c and the rotated k_pe, as cached; without
        rotation under ``mla_use_nope``)."""
        cfg = self.cfg
        q = F.linear(x, self.q_proj.weight).unflatten(-1, (self.nh, -1))
        q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
                               dim=-1)
        kv = F.linear(x, self.kv_a_proj_with_mqa.weight)
        c, k_pe = kv.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
        if self.rotate:
            q_pe = apply_rope(q_pe, cos[:, None], sin[:, None])
            k_pe = apply_rope(k_pe, cos, sin)
        latent = torch.cat([self.kv_a_layernorm(c), k_pe], dim=-1)
        return q_nope, q_pe, latent

    def expand(self, latent: torch.Tensor):
        """latent [T, kv_lora + rope] -> keys [T, nh, nope + rope] and
        values [T, nh, v] (the expanded form)."""
        cfg = self.cfg
        c, k_pe = latent.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim],
                               dim=-1)
        kv = F.linear(c, self.kv_b_proj.weight).unflatten(-1, (self.nh, -1))
        k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)
        k = torch.cat([k_nope, k_pe[:, None].expand(-1, self.nh, -1)], dim=-1)
        return k, v

    def prefill(self, x, cos, sin, rows: Sequence[tuple]):
        """Packed tokens x [N, H] of ragged rows ((start, length) each, in
        order) -> (attention output [N, H], latent [N, kv_lora + rope]),
        each row attending causally to itself alone."""
        q_nope, q_pe, latent = self.project(x, cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k, v = self.expand(latent)
        out = torch.empty(x.shape[0], self.nh, v.shape[-1], dtype=x.dtype,
                          device=x.device)
        for s, n in rows:
            sl = slice(s, s + n)
            out[sl] = F.scaled_dot_product_attention(
                q[sl].transpose(0, 1)[None], k[sl].transpose(0, 1)[None],
                v[sl].transpose(0, 1)[None], is_causal=True,
                scale=self.scale)[0].transpose(0, 1)
        return F.linear(out.flatten(1), self.o_proj.weight), latent

    def decode(self, x, cos, sin, cache, pos, visible):
        """One position of every row (absorbed form): x [R, H] at positions
        ``pos`` [R] (cos, sin [R, rope]); writes the rows' latents into
        ``cache`` [R, C, kv_lora + rope] at ``pos`` and attends over the
        positions ``visible`` [R, C] marks. -> [R, H].

        Between the projections it runs ``models/mla_decode.py``: the
        kernels on the card (which take bf16 at Moonlight's widths and
        raise on anything else), their plain versions on the CPU;
        q_nope·W_kvb,k and o_lat·W_kvb,v are batched products over the
        heads."""
        cfg = self.cfg
        norm = self.kv_a_layernorm
        q_nope, q_pe = mla_decode.mla_decode_prep(
            F.linear(x, self.q_proj.weight),
            F.linear(x, self.kv_a_proj_with_mqa.weight), cos, sin,
            norm.weight, norm.eps, cache, pos, self.nh, self.rotate)
        w = self.kv_b_proj.weight.unflatten(0, (self.nh, -1))
        w_k, w_v = w.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=1)
        o_lat = mla_decode.mla_decode_attention(
            torch.bmm(q_nope, w_k), q_pe, cache, visible,
            self.scale)                                     # [nh, R, 512]
        # W_kvb,v's product written straight in [R, nh, v]
        o = x.new_empty(x.shape[0], self.nh, cfg.v_head_dim)
        torch.bmm(o_lat, w_v.transpose(1, 2), out=o.transpose(0, 1))
        return F.linear(o.flatten(1), self.o_proj.weight)


class GatedMLP(nn.Module):
    """SiLU(gate) * up, then down; gate and up as one product."""

    def __init__(self, h: int, width: int):
        super().__init__()
        self.gate_up_proj = nn.Linear(h, 2 * width, bias=False)
        self.down_proj = nn.Linear(width, h, bias=False)

    def forward(self, x):
        g, u = F.linear(x, self.gate_up_proj.weight).chunk(2, dim=-1)
        return F.linear(F.silu(g) * u, self.down_proj.weight)


class Router(nn.Module):
    """HF ``DeepseekV3TopkRouter``: the gate weight and the correction bias
    (fp32)."""

    def __init__(self, cfg: MoELMConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts,
                                               cfg.hidden_size))
        self.e_score_correction_bias = nn.Parameter(
            torch.zeros(cfg.n_routed_experts))


class Experts(nn.Module):
    """The routed experts held here stacked: ``gate_up_proj`` [E, 2F, H]
    (each expert's gate rows, then its up rows) and ``down_proj`` [E, H,
    F], E = ``held_experts``, the router's experts ``first_held_expert``
    on."""

    def __init__(self, cfg: MoELMConfig):
        super().__init__()
        E, h, f = (cfg.held_experts, cfg.hidden_size,
                   cfg.moe_intermediate_size)
        self.total, self.first = cfg.n_routed_experts, cfg.first_held_expert
        self.gate_up_proj = nn.Parameter(torch.empty(E, 2 * f, h))
        self.down_proj = nn.Parameter(torch.empty(E, h, f))

    def forward(self, x: torch.Tensor, idx: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
        """x [T, H], chosen experts idx [T, k] (the router's numbering) and
        their weights [T, k] (fp32) -> sum over the k held here of weight ·
        expert(x), in x's dtype. The T·k token copies are sorted by expert
        (held experts first) and run as two grouped GEMMs whose group ends
        are counted on the device; a copy of an expert not held is
        dropped."""
        T, k = idx.shape
        E = self.gate_up_proj.shape[0]
        flat = idx.reshape(-1)
        if E < self.total:      # held experts 0 .. E-1, the others after
            flat = (flat - self.first) % self.total
        order = torch.argsort(flat, stable=True)
        counts = torch.zeros(self.total, dtype=torch.long, device=x.device) \
            .scatter_add_(0, flat, torch.ones_like(flat))
        offs = counts[:E].cumsum(0).to(torch.int32)
        xs = x.index_select(0, order // k)
        g, u = torch._grouped_mm(xs, self.gate_up_proj.transpose(-2, -1),
                                 offs=offs).chunk(2, dim=-1)
        ys = torch._grouped_mm((F.silu(g) * u).contiguous(),
                               self.down_proj.transpose(-2, -1), offs=offs)
        y = torch.empty_like(ys).index_copy_(0, order, ys)
        if E < self.total:      # rows past the last group are not computed
            y = torch.where((flat < E)[:, None], y, 0)
        return (y.view(T, k, -1).float() * weight[..., None]).sum(1) \
            .to(x.dtype)


class MoE(nn.Module):
    def __init__(self, cfg: MoELMConfig):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg)
        self.experts = Experts(cfg)
        self.shared_experts = GatedMLP(
            cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts)

    def route(self, x: torch.Tensor):
        """x [T, H] -> (chosen experts [T, k], their weights [T, k] fp32)."""
        cfg = self.cfg
        s = F.linear(x.float(), self.gate.weight.float()).sigmoid()
        idx = torch.topk(s + self.gate.e_score_correction_bias.float(),
                         cfg.num_experts_per_tok, dim=-1).indices
        w = s.gather(1, idx)
        if cfg.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, w * cfg.routed_scaling_factor

    def forward(self, x: torch.Tensor, routes: Optional[list] = None):
        """x [T, H] -> [T, H]; appends the chosen experts to ``routes``."""
        idx, w = self.route(x)
        if routes is not None:
            routes.append(idx)
        return self.experts(x, idx, w) + self.shared_experts(x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: MoELMConfig, i: int):
        super().__init__()
        self.kda = cfg.is_kda(i)
        self.self_attn = kda.KimiDeltaAttention(cfg) if self.kda \
            else LatentAttention(cfg)
        self.mlp = MoE(cfg) if cfg.is_moe(i) else GatedMLP(
            cfg.hidden_size, cfg.intermediate_size)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)

    def ffn(self, h, routes):
        x = self.post_attention_layernorm(h)
        if isinstance(self.mlp, MoE):
            return h + self.mlp(x, routes)
        return h + self.mlp(x)


class _DecodeState:
    """The static buffers of the decode loop of one (rows, dtype) key on one
    device, at the model's :attr:`MoELMConfig.positions`: every MLA layer's
    latent cache, every KDA layer's state (fp32) and conv inputs, each
    row's position, input token and done flag, the step index, the tokens
    emitted, the last step's logits, each step's chosen experts per MoE
    layer, the experts-touched tally; and the step graphs by cache
    capacity, which read and write only these. It lives among the model's
    graphs on its device (``dg``), so new weight storage drops it with
    them."""

    def __init__(self, lm: "MoELM", rows: int, dtype: torch.dtype,
                 dg: cuda_graphs.DeviceGraphs):
        cfg = lm.cfg
        n_moe = len(cfg.moe_layers)
        capacity = cfg.positions
        n_kda, D = len(cfg.kda_layers), cfg.kda_head_dim
        W = cfg.kda_num_heads * D
        with torch.inference_mode(False):   # written in place at any mode
            z = dict(device=dg.device)
            self.cache = torch.zeros(len(cfg.mla_layers), rows, capacity,
                                     cfg.latent_dim, dtype=dtype, **z)
            self.kda_state = torch.zeros(n_kda, rows, cfg.kda_num_heads, D,
                                         D, dtype=torch.float32, **z)
            self.conv_state = torch.zeros(n_kda, rows,
                                          cfg.kda_conv_size - 1, 3 * W,
                                          dtype=dtype, **z)
            self.pos = torch.zeros(rows, dtype=torch.long, **z)
            self.tok = torch.zeros(rows, dtype=torch.long, **z)
            self.done = torch.zeros(rows, dtype=torch.bool, **z)
            self.step = torch.zeros(1, dtype=torch.long, **z)
            self.ids = torch.zeros(rows, capacity, dtype=torch.long, **z)
            self.logits = torch.zeros(rows, cfg.vocab_size, dtype=dtype, **z)
            self.routes = torch.zeros(capacity, n_moe, rows,
                                      cfg.num_experts_per_tok,
                                      dtype=torch.int16, **z)
            self.touched = torch.zeros(1, dtype=torch.long, **z)
            self.slots = torch.arange(capacity, **z)
        self.dg = dg
        self.graphs: Dict[int, Optional[cuda_graphs.Graph]] = {}


class MoELM(nn.Module):
    """The model (HF ``DeepseekV3ForCausalLM``'s modules without the
    ``model.`` prefix) with its batched greedy generation."""

    def __init__(self, cfg: MoELMConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, h)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i) for i in
                                    range(cfg.num_hidden_layers))
        self.norm = RMSNorm(h, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(h, cfg.vocab_size, bias=False)
        # each layer's index among the layers of its kind (MLA or KDA)
        self.slot = [(cfg.kda_layers if cfg.is_kda(i) else cfg.mla_layers)
                     .index(i) for i in range(cfg.num_hidden_layers)]
        self._rope: Dict[torch.device, tuple] = {}
        self._graphs = cuda_graphs.GraphCache()   # decode states, graphs
        # tap(kind, rows, steps) -> decode steps whose logits generate keeps
        # in ``tapped`` (with the prompts, the first token's logits and
        # every chosen expert); None keeps nothing.
        self.tap: Optional[Callable[[str, int, int], Collection[int]]] = None
        self.tapped: Dict[str, Dict[str, Any]] = {}

    def cast(self, dtype: torch.dtype) -> "MoELM":
        """Every weight to ``dtype`` but the routers' correction bias and
        the KDA layers' A_log and dt_bias (fp32)."""
        self.to(dtype)
        fp32 = {Router: ("e_score_correction_bias",),
                kda.KimiDeltaAttention: ("A_log", "dt_bias")}
        for m in self.modules():
            for name in fp32.get(type(m), ()):
                p = getattr(m, name)
                p.data = p.data.float()
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.weight.dtype

    def rope(self, device: torch.device) -> tuple:
        t = self._rope.get(device)
        if t is None:
            with torch.inference_mode(False):
                t = self._rope[device] = rope_tables(self.cfg, device)
        return t

    def capacity(self, lengths: Sequence[int], max_new: int) -> int:
        """The cache capacity of rows of these prompt lengths decoding
        ``max_new`` tokens; raises ValueError when a row needs more
        positions than the model has."""
        need = max(lengths) + max_new - 1
        limit = self.cfg.positions
        if need > limit:
            raise ValueError(
                f"a prompt of {max(lengths)} tokens with {max_new} new "
                f"tokens needs {need} positions; the model has {limit}")
        return min(-(-need // CACHE_ALIGN) * CACHE_ALIGN, limit)

    def _state(self, rows: int, device) -> _DecodeState:
        dg = self._graphs.on(device, cuda_graphs.storage_key(self))
        key = (rows, self.dtype)
        with dg.lock:
            st = dg.entries.get(key)
            if st is None:
                st = dg.entries[key] = _DecodeState(self, rows, self.dtype,
                                                    dg)
        return st

    # ---- prefill -----------------------------------------------------
    def prefill(self, st: _DecodeState, prompts: Sequence[Sequence[int]],
                kind: str, routes: Optional[list] = None,
                kda_inputs: Optional[list] = None) -> torch.Tensor:
        """The ragged prompts through every layer (span ``topics.prefill``):
        fills each row's cache (or KDA state) at positions 0 .. len - 1,
        emits each row's first token (the greedy choice at its last
        position) into step 0 of ``st`` and returns those logits [R, V].
        ``routes`` gets each MoE layer's chosen experts [N, k] over the
        packed tokens, ``kda_inputs`` each KDA layer's input [len, H] of the
        first row."""
        cfg = self.cfg
        dev = st.pos.device
        lengths = [len(p) for p in prompts]
        n, R = sum(lengths), len(prompts)
        rows = list(zip(itertools.accumulate([0] + lengths[:-1]), lengths))
        with profiler.span("topics.prefill", kind=kind, rows=R, tokens=n,
                           padded=n, lengths=lengths):
            # one copy to the card: ids, positions, rows, last positions,
            # lengths
            idx = torch.tensor(
                [t for p in prompts for t in p]
                + [i for L in lengths for i in range(L)]
                + [r for r, L in enumerate(lengths) for _ in range(L)]
                + [s + L - 1 for s, L in rows] + lengths,
                dtype=torch.long).to(dev, non_blocking=True)
            ids, pos, row_of = idx[:n], idx[n:2 * n], idx[2 * n:3 * n]
            last, lens = idx[3 * n:3 * n + R], idx[3 * n + R:]
            cos_t, sin_t = self.rope(dev)
            cos, sin = cos_t.index_select(0, pos), sin_t.index_select(0, pos)
            x = F.embedding(ids, self.embed_tokens.weight)
            for i, layer in enumerate(self.layers):
                j, h = self.slot[i], layer.input_layernorm(x)
                if layer.kda:
                    if kda_inputs is not None:
                        kda_inputs.append(h[:lengths[0]].clone())
                    a = layer.self_attn.prefill(h, rows, st.kda_state[j],
                                                st.conv_state[j], i)
                else:
                    a, latent = layer.self_attn.prefill(h, cos, sin, rows)
                    st.cache[j].index_put_((row_of, pos), latent)
                x = layer.ffn(x + a, routes)
            h = self.norm(x.index_select(0, last))
            logits = F.linear(h, self.lm_head.weight)
            first = logits.argmax(dim=-1)
            st.pos.copy_(lens)
            st.tok.copy_(first)
            st.done.copy_(first == cfg.eos_token_id)
            st.ids.zero_()
            st.ids[:, 0] = first
            st.step.fill_(1)
            st.touched.zero_()
        return logits

    # ---- decode ------------------------------------------------------
    def _step(self, st: _DecodeState, cap: int) -> None:
        """One position of every row, all on the device: embed each row's
        input token at its position, run the layers (absorbed attention
        over the first ``cap`` positions of the row's cache, or the KDA
        step on the row's state), the head and the greedy choice; record
        the token (eos once a row is done), the chosen experts and the
        distinct held experts per MoE layer; advance every row."""
        cfg = self.cfg
        cos_t, sin_t = self.rope(st.pos.device)
        pos = st.pos
        cos, sin = cos_t.index_select(0, pos), sin_t.index_select(0, pos)
        visible = st.slots[None, :cap] <= pos[:, None]
        x = F.embedding(st.tok, self.embed_tokens.weight)
        routes: list = []
        for i, layer in enumerate(self.layers):
            j, h = self.slot[i], layer.input_layernorm(x)
            if layer.kda:
                x = x + layer.self_attn.decode(h, st.kda_state[j],
                                               st.conv_state[j])
            else:
                x = x + layer.self_attn.decode(h, cos, sin,
                                               st.cache[j, :, :cap], pos,
                                               visible)
            x = layer.ffn(x, routes)
        st.logits.copy_(F.linear(self.norm(x), self.lm_head.weight))
        nxt = st.logits.argmax(dim=-1)
        tok = torch.where(st.done, cfg.eos_token_id, nxt)
        st.ids.index_copy_(1, st.step, tok[:, None])
        chosen = torch.stack(routes)                    # [n_moe, R, k]
        st.routes.index_copy_(0, st.step, chosen.to(torch.int16)[None])
        used = torch.zeros(chosen.shape[0], cfg.n_routed_experts,
                           dtype=torch.bool, device=pos.device)
        first = cfg.first_held_expert
        st.touched += used.scatter_(1, chosen.flatten(1), True)[
            :, first:first + cfg.held_experts].sum()
        st.done |= nxt == cfg.eos_token_id
        st.tok.copy_(tok)
        st.pos += 1
        st.step += 1

    def decode(self, st: _DecodeState, cap: int, max_new: int, kind: str,
               lengths: Sequence[int],
               taps: Collection[int] = ()) -> Dict[str, Any]:
        """Steps 1 .. max_new - 1 after :meth:`prefill` over ``cap``
        positions (span ``topics.decode``): eagerly on the CPU or with
        autograd on, else on the step graph of (rows, ``cap``)
        (:meth:`_graph_loop`). Keeps the logits of the steps in ``taps``.
        -> the span's attributes and ``ids`` [R, max_new] on the host."""
        R = st.ids.shape[0]
        steps = max_new - 1
        tapped: Dict[int, torch.Tensor] = {}
        with profiler.span("topics.decode", kind=kind, rows=R, steps=steps,
                           cap=max_new, lengths=list(lengths)) as sp:
            if st.pos.device.type != "cuda" or torch.is_grad_enabled():
                for s in range(1, steps + 1):
                    self._step(st, cap)
                    if s in taps:
                        tapped[s] = st.logits.clone()
            else:
                self._graph_loop(st, cap, steps, taps, tapped)
            ids = st.ids[:, :max_new].to("cpu", copy=True)
            eos = self.cfg.eos_token_id
            emitted = [next((j + 1 for j in range(max_new)
                             if int(ids[r, j]) == eos), max_new)
                       for r in range(R)]
            attrs = {"tokens": sum(emitted),
                     "experts_touched": int(st.touched.item()),
                     "experts_held": self.cfg.held_experts,
                     "state_bytes": st.kda_state.numel()
                     * st.kda_state.element_size()}
            if sp is not None:
                sp.attrs.update(attrs)
        return dict(attrs, ids=ids, emitted=emitted, tapped=tapped)

    def _graph_loop(self, st, cap, steps, taps, tapped) -> None:
        """``steps`` steps by the step graph of (rows, ``cap``), in span
        ``topics.graph``: on the key's first use one eager step, the
        capture, then replays; later, replays only. A key whose capture
        failed runs eagerly. The span's ``mla_launches`` counts the MLA
        attention kernel's launches in these steps, a replay's being its
        capture's, and ``kda_launches`` the KDA decode kernel's."""
        R = st.ids.shape[0]
        launched = {mla_decode.mla_decode_attention: 0, kda.kda_decode: 0}
        with profiler.span("topics.graph", rows=R, capacity=cap,
                           steps=steps) as sp:
            g = st.graphs.get(cap, False)       # False: not yet captured
            mode = "replay" if g else "eager"
            for s in range(1, steps + 1):
                if g:
                    st.dg.replay(g)
                    n = g.launches
                else:
                    _, n = _cuda_call.counted(self._step, st, cap)
                    if g is False:
                        # the eager step made the lazy state (the rope
                        # tables) that a capture cannot make
                        g = st.dg.capture(
                            st.graphs, cap, lambda: self._step(st, cap),
                            f"an LM decode step ({R} rows, {cap} "
                            "positions)")
                        mode = "capture" if g else "eager"
                for wrapper in launched:
                    launched[wrapper] += n.get(wrapper, 0)
                if s in taps:
                    tapped[s] = st.logits.clone()
            if sp is not None:
                sp.attrs["mode"] = mode
                sp.attrs["mla_launches"] = launched[
                    mla_decode.mla_decode_attention]
                sp.attrs["kda_launches"] = launched[kda.kda_decode]

    # ---- generation --------------------------------------------------
    def generate(self, prompts: Sequence[Sequence[int]], max_new: int,
                 kind: str = "summary") -> Dict[str, Any]:
        """Greedy continuation of each prompt (token ids) to
        ``eos_token_id`` or ``max_new`` tokens: ``ids`` [R, max_new] on the
        host (each row's tokens, eos included, then eos), ``emitted``
        (tokens per row, eos included), ``tokens`` and
        ``experts_touched``. Under :attr:`tap`, ``tapped[kind]`` also keeps,
        on the device, every KDA layer's state after the prefill and its
        input of the first row."""
        if not prompts or max_new < 1 or min(len(p) for p in prompts) < 1:
            raise ValueError("generate needs non-empty prompts and "
                             "max_new >= 1")
        dev = self.embed_tokens.weight.device
        cap = self.capacity([len(p) for p in prompts], max_new)
        st = self._state(len(prompts), dev)
        taps = set(self.tap(kind, len(prompts), max_new - 1)) \
            if self.tap else set()
        routes: Optional[list] = [] if self.tap else None
        inputs: Optional[list] = [] if self.tap else None
        first = self.prefill(st, prompts, kind, routes, inputs)
        # each KDA layer's state after the prefill (the decode updates it)
        state = st.kda_state.clone() if self.tap else None
        out = self.decode(st, cap, max_new, kind,
                          [len(p) for p in prompts], taps)
        if self.tap:
            self.tapped[kind] = {
                "prompts": [list(p) for p in prompts],
                "first_logits": first.float().cpu(),
                "steps": {s: lg.float().cpu()
                          for s, lg in out["tapped"].items()},
                "prefill_routes": torch.stack(routes).cpu(),
                "decode_routes": st.routes[1:max_new].to("cpu", copy=True),
                "kda_state": state, "kda_inputs": inputs,
                "ids": out["ids"]}
        return out


def build_synthetic(cfg: MoELMConfig, device, seed: int = 0,
                    dtype: torch.dtype = torch.float32) -> MoELM:
    """Seeded stand-in weights made on ``device`` in ``dtype``: every
    product and the embedding N(0, 0.02), the MLA's q, W_kvb and W_o
    :data:`ATTENTION_SCALE` times wider, RMSNorm gains 1, the routers'
    correction bias N(0, :data:`BIAS_STD`) (fp32), the KDA layers' own as
    :func:`kda.stand_in` draws them."""
    device = torch.device(device)
    with torch.device("meta"):
        model = MoELM(cfg)
    model.cast(dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    wide = ("q_proj", "kv_b_proj", "o_proj")
    mixers = {f"layers.{i}.self_attn.": cfg.is_kda(i)
              for i in range(cfg.num_hidden_layers)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            mixer = name[:name.find("self_attn.") + 10]
            if mixers.get(mixer):
                kda.stand_in(name[len(mixer):], p, gen)
            elif "layernorm" in name or name.startswith("norm."):
                p.fill_(1.0)
            elif name.endswith("e_score_correction_bias"):
                p.normal_(0.0, BIAS_STD, generator=gen)
            else:
                std = 0.02 * (ATTENTION_SCALE if any(
                    f".{w}." in name for w in wide) else 1.0)
                p.normal_(0.0, std, generator=gen)
    return model.eval()
