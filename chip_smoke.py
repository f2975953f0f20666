"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit) on any error:

1. the card: name and power limit (nvidia-smi); no CUDA, no run;
2. build: the port's CUDA kernels from ``audio_processor_tpu_torch/csrc``
   (nvcc, sm_90a, one process per source, all at once; each kernel's
   ``-Xptxas -v`` lines printed) and, beside them, the port's native host
   I/O library (g++ over ``native/*.cpp`` into
   ``audio_processor_tpu_torch/io/_native/``); then ``cuobjdump -sass``
   must show warpgroup MMAs (HGMMA) in every bf16 tensor-core kernel and
   in every one of the nine instances of the ablation kernel;
3. kernel vs plain: the flash-rel attention kernel against its plain
   PyTorch version on the card, fp32 and bf16 with ragged kv masks at
   B=2 (L from 64 to 1280, 320 among them), and bf16 at every (B, L) the
   main path gives the kernel (up to B=48, H=16, L=1280) with a valid
   length per batch row; both times at B=48, H=16, L=1280 on the inputs
   just checked;
3b. the flash kernel against its plain version: fp32 and bf16 at B=2,
   L in {64, 256, 320, 512, 1280}, with the bias built as the model
   builds it (ragged kv mask, one batch row wholly masked), and without a
   bias (L in {64, 320, 1280}, and at B=48, L=1280 bf16); bf16 at every
   (B, L) of the batch path under ``flash``; both times at B=48, H=16,
   L=1280 bf16 with the bias, and beside them the library call of the
   same function (``scaled_dot_product_attention`` with the bias as its
   mask), which the port never calls;
3c. every flash-rel ablation kernel against its plain twin at H=16,
   L=1280, B=2 and B=48 (the wrong-by-design modes: the same NaN/inf
   pattern, equal where finite); both times of each at B=48, and beside
   them the library call of the same function
   (``scaled_dot_product_attention``: bare without a mask, full and
   kb640 with the additive mask of s_rel and kv_mask, norel with the kv
   mask's term alone), which the port never calls;
4. small reference: a tiny model through the port's ASR engine on the
   card (kernel path) and on the CPU (plain path), same weights and
   audio: masks equal, ids equal off near-ties, features close;
4b. the same under ``attention_impl: flash`` on both sides;
5. main path: 8 synthetic stereo calls of 100 s (3 at 8 kHz) through
   ``audio_processor_tpu_torch.pipeline.engine.DataProcessor`` at the
   full w2v-bert-2.0 width (random weights from the seed), bf16, CSV
   output; every file must succeed, every chunk must have its row, and
   the kernel must have run once per encoder layer per dispatched batch;
5b. the batch path under ``attention_impl: flash``: 4 calls of 100 s
   (1 at 8 kHz), the same checks with the flash kernel, and no
   flash_rel launch;
6. the ablation path: ``tools/profile_kernel_parts_torch.py`` over all
   its variants at B=48, H=16, L=1280; each ablation kernel launched.

Kernel launch counts are set to 0 just before each of the paths 5, 5b
and 6 and read just after. The second-to-last line is the kernels' JSON
record (per kernel: launches, error, ms, plain ms, the bound computed
from the timed inputs and what sets it, and the library call's ms or
null); the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX and nothing of the JAX package ``audio_processor_tpu``.
"""

from __future__ import annotations

import argparse
import csv
import importlib.util
import json
import logging
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
SOURCES = ("flash_rel_attention", "flash_attention", "flash_rel_parts")
# Kernel vs plain: fp32 holds the JAX tests' tolerance (only summation
# order differs); bf16 outputs may differ by one bf16 rounding (2^-8 to
# 2^-7 relative) since both sides compute in fp32 and round at the end.
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
MARGIN = 1e-3          # ids compared where the reference's top-2 margin is wider
FEAT_ATOL = 2e-4       # acoustic features, relative to max(|ref|, 1)
# (encoder rows B, frames L) of every kernel call in the main-path phase:
# 3 views x (16, 8 or 4 chunks) at the 25 s (1280) and 5 s (256) buckets.
MAIN_SHAPES = [(12, 256), (12, 1280), (24, 256), (24, 1280), (48, 1280)]
# Every (B, L) the flash kernel is checked at in bf16 (a superset of the
# batch path's shapes).
FLASH_SHAPES = [(b, n) for b in (12, 24, 48) for n in (256, 1280)]
# Ablation kernel vs twin (bf16 out, outputs ~0.5): one bf16 rounding of
# the output and of p, at the same kv steps on both sides.
PARTS_TOL = (4e-3, 1e-2)
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3 rate (NVIDIA's data sheet)
BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak (same)
ABLATION_VARIANTS = ("full", "noselect", "norel", "nomax", "nosoftmax",
                     "noexp", "kb640", "bare:ones", "bare:reduce",
                     "shipped", "stock")


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def card() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script runs only on a CUDA device")
    log(smi_line())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}")
    return torch.cuda.get_device_name(0)


def build() -> None:
    from audio_processor_tpu_torch import _build

    t0 = time.perf_counter()
    libs = _build.build_all(SOURCES, native=True)
    log(f"[build] {', '.join(SOURCES)} (parallel nvcc) and the native I/O "
        f"library (g++, beside them): {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        log(_build.build_log(name).rstrip())
    log(f"[build] native I/O library: {libs['native'].relative_to(REPO)}")
    from audio_processor_tpu_torch.io import native

    assert native.available(), "the port's native I/O library did not load"
    tensor_core_sass(libs)


def tensor_core_sass(libs: dict) -> None:
    """The bf16 attention kernels run on the tensor cores: count the
    warpgroup MMAs (HGMMA) and warp MMAs (HMMA) in each kernel's SASS
    (cuobjdump) and fail unless every tensor-core kernel has HGMMA; the
    ablation source holds only such kernels, one per config."""
    from audio_processor_tpu_torch import _build
    from audio_processor_tpu_torch.models.flash_rel_parts import MODES

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    for name in ("flash_rel_attention", "flash_attention", "flash_rel_parts"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[name])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
            elif fn is not None:
                ops = line.split("*/")[1].split()[:2] if "*/" in line else []
                for key in counts[fn]:
                    counts[fn][key] += any(op.startswith(key + ".")
                                           for op in ops)
        tc = {f: c for f, c in counts.items() if "_kernel_tc" in f}
        for f, c in counts.items():
            log(f"[build] SASS {name}: {f[:72]}: {c}")
        assert tc and all(c["HGMMA"] > 0 for c in tc.values()), counts
        if name == "flash_rel_parts":
            assert len(tc) == len(counts) == len(MODES), counts


def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(q, ab=None, extra_bytes: int = 0,
                    extra_flops: int = 0) -> tuple:
    """(bound ms, "bytes" or "operations") of one attention call on q's
    shape [B, H, L, 64]: q, k, v read once, o written once, ab (and the
    extra inputs) read once, over the card's 3.35 TB/s; the two products,
    4*B*H*L^2*d FLOP (plus extra_flops), over the 989 TFLOP/s bf16 peak
    (H100 SXM, NVIDIA's data sheet)."""
    B, H, L, d = q.shape
    nbytes = 4 * q.numel() * q.element_size() + extra_bytes
    if ab is not None:
        nbytes += ab.numel() * ab.element_size()
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = (4 * B * H * L * L * d + extra_flops) / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _inputs(gen, B: int, L: int, P: int, left: int, dtype, ragged: str):
    """q, k, v [B, 16, L, 64], E [P, 64] and a kv mask on the card.
    ``ragged``: "tail" masks the last 77 columns of row 1 (and all of
    row 0 when right = 0); "rows" gives every batch row its own valid
    length, as the main path's chunks of different lengths do."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(B, 16, L, 64, generator=gen).to(dev, dtype)
               for _ in range(3))
    E = torch.randn(P, 64, generator=gen).to(dev)
    mask = torch.ones(B, L)
    if ragged == "tail":
        mask[1, -min(77, L // 2):] = 0.0
        if P - 1 == left:
            mask[0] = 0.0                              # no valid kv at all
    else:
        valid = torch.randint(L // 8, L + 1, (B,), generator=gen)
        valid[0] = L                                   # one full row
        mask = (torch.arange(L)[None, :] < valid[:, None]).float()
    return q, k, v, E, mask.to(dev)


def _held(out, ref, live, tol, label: str) -> float:
    """Kernel output vs plain on the batch rows ``live`` selects, held to
    ``tol`` = (atol, rtol); the whole output must be finite. Logs and
    returns max_abs; raises on disagreement."""
    atol, rtol = tol
    err = (out[live].float() - ref[live].float()).abs()
    mag = ref[live].float().abs()
    max_abs = float(err.max())
    rel = (err / mag)[mag >= 0.1]
    max_rel = float(rel.max()) if rel.numel() else float("nan")
    used = float((err / (atol + rtol * mag)).max())
    ok = used <= 1.0 and bool(torch.isfinite(out).all())
    log(f"{label}: max_abs {max_abs:.3e}, max_rel {max_rel:.3e} where "
        f"|ref| >= 0.1; tol atol {atol:g} + rtol {rtol:g}, worst err/tol "
        f"{used:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with plain: {label}")
    return max_abs


def _compare(fra, args, left: int, P: int, label: str) -> float:
    """Kernel vs plain on the same inputs, held to TOL; returns max_abs."""
    q, _, _, _, mask = args
    out = fra.flash_rel_attention(*args, 0.125, left, P)
    ref = fra.flash_rel_attention_plain(*args, 0.125, left, P)
    torch.cuda.synchronize()
    # A batch row with no valid kv is finite but arbitrary on both sides
    # (every score sits at -1e9, where fp32 steps by 64), so only rows
    # with valid kv are compared.
    return _held(out, ref, mask.bool().any(dim=1), TOL[q.dtype],
                 f"[kernel] {str(q.dtype)[6:]:8s} {label}")


def _turns(kern, plain, label: str, reps=(20, 5)) -> tuple:
    """Kernel and plain times in turns (plain, kernel, kernel, plain);
    returns the best of each, in ms."""
    times = {"plain": [], "kernel": []}
    for name, fn, n in (("plain", plain, reps[1]), ("kernel", kern, reps[0]),
                        ("kernel", kern, reps[0]), ("plain", plain, reps[1])):
        times[name].append(_cuda_ms(fn, n))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    log(f"{label}: kernel {times['kernel']} ms, plain {times['plain']} ms "
        f"(best {ms:.3f} vs {plain_ms:.3f})")
    return ms, plain_ms


def kernel_vs_plain(seed: int) -> dict:
    from audio_processor_tpu_torch.models import flash_rel_attention as fra

    gen = torch.Generator().manual_seed(seed)
    worst = 0.0
    # (L, P, left) at B=2: the main path's table at three bucket lengths,
    # L = 64 and 320 (one q tile; an odd number of them), the largest
    # table, and two edges (one 64-row tile with a one-row table; right =
    # 0 with batch row 0 wholly masked).
    cases = [(L, 73, 64) for L in (64, 256, 320, 512, 1280)] + [
        (512, 128, 100), (64, 1, 0), (192, 9, 8)]
    for dtype in (torch.float32, torch.bfloat16):
        for L, P, left in cases:
            args = _inputs(gen, 2, L, P, left, dtype, "tail")
            worst = max(worst, _compare(
                fra, args, left, P,
                f"B= 2 H=16 L={L:4d} P={P:3d} left={left:3d} tail"))
    # Every (B, L) the main path gives the kernel (bf16, P=73, left=64),
    # each batch row with its own valid length; B=48, L=1280 last, whose
    # inputs the timing below reuses.
    for B, L in MAIN_SHAPES:
        args = _inputs(gen, B, L, 73, 64, torch.bfloat16, "rows")
        worst = max(worst, _compare(
            fra, args, 64, 73, f"B={B:2d} H=16 L={L:4d} P= 73 left= 64 rows"))

    # Time both at the production geometry in the main path's dtype, on
    # the inputs just checked, in turns (plain, kernel, kernel, plain).
    B, H, L, P = 48, 16, 1280, 73
    q, k, v, E, mask = args
    assert tuple(q.shape) == (B, H, L, 64) and tuple(E.shape) == (P, 64)

    def kern():
        fra.flash_rel_attention(q, k, v, E, mask, 0.125, 64, P)

    def plain():
        fra.flash_rel_attention_plain(q, k, v, E, mask, 0.125, 64, P)

    ms, plain_ms = _turns(kern, plain,
                          f"[kernel] time B={B} H={H} L={L} d=64 bf16")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,
            "bound": attention_bound(q, extra_bytes=E.numel() * 2
                                     + mask.numel() * 4,
                                     extra_flops=2 * q[..., 0].numel()
                                     * P * 64)}


def flash_vs_plain(seed: int) -> dict:
    """Phase 3b: the flash kernel against its plain version, with the
    bias the model builds (relative logits + kv mask, bf16)."""
    from audio_processor_tpu_torch.models import flash_attention as fa
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v

    cfg = w2v.W2VBertConfig()
    gen = torch.Generator().manual_seed(seed + 2)

    def case(B, L, dtype, ragged, bias=True):
        q, k, v, E, mask = _inputs(gen, B, L, 73, 64, dtype, ragged)
        if ragged == "tail":
            mask[0] = 0.0                          # a wholly masked row
        attn_bias = ((1.0 - mask) * -1e9)[:, None, None, :]
        ab = (w2v.flash_bias(cfg, q, E.to(dtype), attn_bias, 0.125)
              if bias else None)
        return q, k, v, ab, mask

    def check(args, label):
        q, k, v, ab, mask = args
        out = fa.flash_attention(q, k, v, ab, 0.125)
        ref = fa.flash_attention_plain(q, k, v, ab, 0.125)
        torch.cuda.synchronize()
        live = (mask.bool().any(dim=1) if ab is not None
                else torch.ones(q.shape[0], dtype=torch.bool))
        return _held(out, ref, live, TOL[q.dtype],
                     f"[flash] {str(q.dtype)[6:]:8s} B={q.shape[0]:2d} H=16 "
                     f"L={q.shape[2]:4d} {label}")

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for L in (64, 256, 320, 512, 1280):
            worst = max(worst, check(case(2, L, dtype, "tail"),
                                     "bias, ragged mask, row 0 masked"))
        for L in (64, 320, 1280):
            worst = max(worst, check(case(2, L, dtype, "tail", bias=False),
                                     "no bias"))
    # The no-bias instance at the ablation path's shape (its "stock").
    worst = max(worst, check(case(48, 1280, torch.bfloat16, "rows",
                                  bias=False), "no bias"))
    # Every (B, L) of the batch path under flash, bf16, each batch row
    # with its own valid length; B=48, L=1280 last, timed below.
    for B, L in FLASH_SHAPES:
        args = case(B, L, torch.bfloat16, "rows")
        worst = max(worst, check(args, "bias, rows"))
    q, k, v, ab, _ = args
    assert tuple(ab.shape) == (48, 16, 1280, 1280)
    ms, plain_ms = _turns(
        lambda: fa.flash_attention(q, k, v, ab, 0.125),
        lambda: fa.flash_attention_plain(q, k, v, ab, 0.125),
        "[flash] time B=48 H=16 L=1280 d=64 bf16, bf16 bias")
    # The one PyTorch call of the same function, on the same inputs, as a
    # yardstick (the port never calls it): SDPA computes q.k^T * scale +
    # mask, so the bias is scaled outside the timed call.
    mask_ab = ab * 0.125
    library_ms = min(_cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask_ab, scale=0.125), 20) for _ in range(2))
    log(f"[flash] library scaled_dot_product_attention(attn_mask=ab*scale):"
        f" {library_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound": attention_bound(q, ab=ab)}


def _same_nonfinite(out, ref, label: str) -> float:
    """A wrong-by-design ablation: the same NaN and signed-inf pattern,
    and PARTS_TOL where finite; returns max_abs over finite entries."""
    o, r = out.float(), ref.float()
    same = all(torch.equal(f(o), f(r)) for f in (
        torch.isnan, torch.isposinf, torch.isneginf))
    fin = torch.isfinite(r)
    atol, rtol = PARTS_TOL
    max_abs, used = 0.0, 0.0
    if fin.any():
        err = (o[fin] - r[fin]).abs()
        max_abs = float(err.max())
        used = float((err / (atol + rtol * r[fin].abs())).max())
    ok = same and used <= 1.0
    log(f"{label}: NaN {int(r.isnan().sum())}, inf {int(r.isinf().sum())}"
        f" of {r.numel()}, patterns equal {same}; finite {int(fin.sum())}:"
        f" max_abs {max_abs:.3e}, worst err/tol {used:.3f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with plain: {label}")
    return max_abs


def parts_vs_plain(seed: int) -> dict:
    """Phase 3c: every ablation kernel against its plain twin at B=2 and
    B=48 (H=16, L=1280), then both timed at B=48."""
    from audio_processor_tpu_torch.models import flash_rel_parts as frp

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)

    def inputs(B, offset=0.0):
        """bf16 q, k (+ offset), v ~ N(0, 1), s_rel ~ 4 N(0, 1), the last
        77 kv columns of batch row 1 masked."""
        q, k, v = (torch.randn(B, 16, 1280, 64, generator=gen,
                               device="cuda") for _ in range(3))
        q, k, v = ((t + o).to(torch.bfloat16)
                   for t, o in ((q, offset), (k, offset), (v, 0.0)))
        s_rel = 4.0 * torch.randn(B, 16, 1280, 128, generator=gen,
                                  device="cuda")
        mask = torch.ones(B, 1280, device="cuda")
        mask[1, -77:] = 0.0
        return q, k, v, s_rel, mask

    def kernel(name, args):
        if name.startswith("bare"):
            return frp.bare(*args[:3], rowsum=name.split(":")[1])
        if name == "kb640":
            return frp.kb640(*args)
        return frp.variant(*args, mode=name)

    worst = {name: 0.0 for name in frp.MODES}
    # At B=2, then at the ablation path's B=48, whose inputs are timed.
    for B in (2, 48):
        base, positive = inputs(B), inputs(B, offset=1.0)
        for name in frp.MODES:
            # nosoftmax on q.k > 0: unmasked rows finite, row 1 +-inf.
            args = positive if name == "nosoftmax" else base
            out, ref = kernel(name, args), frp.plain(name, *args)
            torch.cuda.synchronize()
            label = f"[parts] {name:11s} B={B:2d} H=16 L=1280 bf16"
            if name in ("nosoftmax", "noexp"):
                err = _same_nonfinite(out, ref, label)
            else:
                err = _held(out, ref, torch.ones(B, dtype=torch.bool),
                            PARTS_TOL, label)
            worst[name] = max(worst[name], err)
        del positive, out, ref
    times = {}
    for name in frp.MODES:
        times[name] = _turns(lambda: kernel(name, base),
                             lambda: frp.plain(name, *base),
                             f"[parts] time {name:11s} B=48 H=16 L=1280",
                             reps=(5, 2))
    q, _, _, s_rel, mask = base
    bounds = {"bare": attention_bound(q),
              "rel": attention_bound(q, extra_bytes=s_rel.numel() * 4
                                     + mask.numel() * 4)}
    return {"max_abs_err": worst, "times": times, "bounds": bounds,
            "library": parts_library(frp, base)}


def parts_library(frp, args) -> dict:
    """The one PyTorch call of each ablation function on the same inputs,
    as a yardstick (the port never calls it): SDPA computes
    softmax(q.k^T * scale + mask) v, so the mask is the twin's additive
    term, ``rel * scale + (kv_mask - 1) * 1e9`` in bf16 (as the flash
    row's call), built outside the timed call: full and kb640 (the same
    function) with the saturated bias, norel with the kv term alone
    (broadcast over heads and rows), bare with none. Each library output
    is logged against the twin, for information."""
    q, k, v, s_rel, kv_mask = args
    B, H, L, _ = q.shape
    pos = torch.arange(L, device=q.device)
    idx = (pos[None, :] - pos[:, None]).clamp(
        -frp.LEFT, frp.NUM_BUCKETS - 1 - frp.LEFT) + frp.LEFT
    kv_term = (kv_mask[:, None, None, :] - 1.0) * 1e9
    full_mask = torch.empty(B, H, L, L, dtype=torch.bfloat16,
                            device=q.device)
    for b in range(B):
        full_mask[b] = (s_rel[b].gather(-1, idx.expand(H, L, L))
                        * frp.SCALE + kv_term[b])
    masks = {"full": full_mask, "norel": kv_term.to(torch.bfloat16),
             "bare:ones": None}
    out = {}
    for name, mask in masks.items():
        def call(mask=mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=frp.SCALE)
        ref = frp.plain(name, q, k, v, s_rel, kv_mask)
        err = float((call().float() - ref.float()).abs().max())
        out[name] = min(_cuda_ms(call, 10) for _ in range(2))
        log(f"[parts] library scaled_dot_product_attention for {name:9s}: "
            f"{out[name]:.4f} ms; max_abs vs the twin {err:.3e}")
    del full_mask, masks
    out["kb640"] = out["full"]
    return out


def _write_calls(root: Path, seed: int, n: int, dur: float,
                 n_8k: int) -> float:
    """n stereo calls of ``dur`` seconds (the last n_8k at 8 kHz):
    tone bursts over noise, alternating speakers. Returns audio s."""
    from audio_processor_tpu_torch.io import wav

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for i in range(n):
        sr = 8000 if i >= n - n_8k else 16000
        t = np.arange(int(sr * dur)) / sr
        x = 0.02 * rng.standard_normal((2, t.size))
        on = (np.floor(t / 1.5) % 2).astype(bool)
        x[0] += 0.3 * on * np.sin(2 * np.pi * rng.uniform(120, 300) * t)
        x[1] += 0.3 * ~on * np.sin(2 * np.pi * rng.uniform(150, 350) * t)
        wav.write(root / f"call-{i:02d}.wav", x.astype(np.float32), sr)
    return n * dur


def small_reference(seed: int, impl: str) -> None:
    """A tiny model through the engine's fused program on the card
    (CUDA kernel) and on the CPU (plain path), fp32, same inputs.
    ``impl`` is the configured attention_impl: "auto" (flash_rel on the
    card, xla on the CPU) or "flash" (on both)."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.io.decode import load_audio
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.models.tokenizer import CTCVocab
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
    from audio_processor_tpu_torch.pipeline.chunker import (
        chunk_batch, prepare_and_split,
    )

    cfg = PipelineConfig.from_dict({
        "enable_mixed_precision": False, "chunk_duration_sec": 10.0,
        "overlap_sec": 1.0, "length_buckets_sec": [5.0, 10.0],
        "chunk_batch_size": 4, "attention_impl": impl})
    vocab = CTCVocab.darija_default()
    mcfg = w2v.W2VBertConfig(vocab_size=len(vocab), hidden_size=128,
                             num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=256)
    cpu_model = w2v.build_synthetic(mcfg, torch.device("cpu"), seed=seed)
    gpu_model = w2v.build_synthetic(mcfg, torch.device("cpu"), seed=seed)
    cpu = ASREngine(cfg, device="cpu", model=cpu_model, vocab=vocab)
    gpu = ASREngine(cfg, device="cuda", model=gpu_model, vocab=vocab)
    assert (gpu.attention_impl, cpu.attention_impl) == {
        "auto": ("flash_rel", "xla"), "flash": ("flash", "flash")}[impl]
    tag = "[reference]" if impl == "auto" else f"[reference {impl}]"
    with tempfile.TemporaryDirectory() as tmp:
        _write_calls(Path(tmp) / "in", seed + 1, 1, 23.0, 1)
        wave, sr = load_audio(Path(tmp) / "in" / "call-00.wav")
    _, _, chunks = prepare_and_split(wave, sr, "ref.wav", cfg)
    for batch in chunk_batch(chunks, cpu.bucket_samples):
        n = len(batch)
        buf, lengths = cpu._prepare_fused_buffer(batch,
                                                 cpu._tail_size(n))
        ids_c, mask_c, af_c = cpu._fused(torch.from_numpy(buf),
                                         torch.from_numpy(lengths),
                                         batch.bucket_len)
        ids_g, mask_g, af_g = (t.cpu() for t in gpu._fused(
            gpu._upload(buf), gpu._upload(lengths), batch.bucket_len))
        assert torch.equal(mask_c, mask_g), "masks differ"
        # Logits of the CPU run decide which frames are near ties.
        from audio_processor_tpu_torch.dsp.acoustic_features import PAD
        from audio_processor_tpu_torch.dsp.fbank import log_mel_frontend
        from audio_processor_tpu_torch.pipeline.asr_engine import pad_seq

        x = torch.from_numpy(buf).float() / 32768.0
        a = x[:, 0, PAD:PAD + batch.bucket_len]
        c = x[:, 1, PAD:PAD + batch.bucket_len]
        rows = torch.stack([(a + c) * 0.5, a, c], 1).reshape(
            -1, batch.bucket_len)
        feats, mask = pad_seq(*log_mel_frontend(
            rows, torch.from_numpy(lengths).repeat_interleave(3)))
        with torch.inference_mode():
            logits = cpu_model(feats, mask, attention_impl=cpu.attention_impl)
            logits_g = gpu.model(feats.cuda(), mask.cuda(),
                                 attention_impl=gpu.attention_impl).cpu()
        real = slice(0, 3 * n)
        top2 = logits.topk(2, dim=-1).values
        clear = ((top2[..., 0] - top2[..., 1]) > MARGIN)[real]
        dlog = float((logits_g - logits)[real][mask[real]].abs().max())
        same = bool(torch.equal(ids_c[real][clear], ids_g[real][clear]))
        scale = af_c[:n].abs().clamp_min(1.0)
        dfeat = float(((af_g[:n] - af_c[:n]) / scale)
                      .nan_to_num(0.0).abs().max())
        log(f"{tag} bucket {batch.bucket_len}, {n} chunk(s): logits "
            f"max_abs {dlog:.3e} (tol 1e-4); ids equal on "
            f"{int(clear.sum())}/{clear.numel()} clear frames: {same}; "
            f"features max rel {dfeat:.3e} (tol {FEAT_ATOL:g})")
        if not (dlog <= 1e-4 and same and dfeat <= FEAT_ATOL):
            raise AssertionError("card and CPU disagree on the small input")


def _counters() -> dict:
    """Kernel name -> the wrapper whose ``launches`` counts its launches."""
    from audio_processor_tpu_torch.models import flash_rel_parts as frp
    from audio_processor_tpu_torch.models.flash_attention import (
        flash_attention,
    )
    from audio_processor_tpu_torch.models.flash_rel_attention import (
        flash_rel_attention,
    )

    return {"flash_rel_attention": flash_rel_attention,
            "flash_attention": flash_attention, "kb640": frp.kb640,
            "bare": frp.bare, "variant": frp.variant}


def _reset_launches() -> None:
    for wrapper in _counters().values():
        wrapper.launches = 0


def _launches() -> dict:
    return {name: wrapper.launches for name, wrapper in _counters().items()}


def main_path(seed: int, impl: str, n_calls: int, n_8k: int) -> dict:
    """The batch path at full width under the configured attention_impl
    ("auto": the flash_rel kernel; "flash": the flash kernel on a
    materialised bias); launch counts set to 0 just before the run."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.dsp.fbank import max_num_frames
    from audio_processor_tpu_torch.models.wav2vec2bert import W2VBertConfig
    from audio_processor_tpu_torch.pipeline.engine import DataProcessor

    resolved = {"auto": "flash_rel", "flash": "flash"}[impl]
    kernel, other = (("flash_rel_attention", "flash_attention")
                     if resolved == "flash_rel"
                     else ("flash_attention", "flash_rel_attention"))
    tag = "[main]" if impl == "auto" else f"[main {impl}]"
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        audio_s = _write_calls(root / "input", seed, n_calls, 100.0, n_8k)
        cfg = PipelineConfig.from_dict({
            "input_folder": str(root / "input"),
            "output_folder": str(root / "output"),
            "logs_folder": str(root / "logs"),
            "temp_dir": str(root / "tmp"),
            "chunk_batch_size": 16, "enable_mixed_precision": True,
            "save_csv_results": True, "attention_impl": impl})
        proc = DataProcessor(cfg, device="cuda")
        try:
            t0 = time.perf_counter()
            proc.setup_models()
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            engine = proc.asr_engine
            mcfg = engine.model_cfg
            assert mcfg == W2VBertConfig(vocab_size=mcfg.vocab_size)
            assert engine.attention_impl == resolved
            assert engine.dtype == torch.bfloat16

            _reset_launches()
            engine.dispatches = 0
            t0 = time.perf_counter()
            succeeded = proc.run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = _launches()
            stats = dict(proc.stats)
        finally:
            proc.close()
        (csv_path,) = (root / "output").glob("optimized_results_*.csv")
        with open(csv_path, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))

    launches = counts[kernel]
    log(f"{tag} model: hidden {mcfg.hidden_size}, layers "
        f"{mcfg.num_hidden_layers}, heads {mcfg.num_attention_heads}, "
        f"ffn {mcfg.intermediate_size}, conv {mcfg.conv_depthwise_kernel_size}"
        f", vocab {mcfg.vocab_size}; setup {setup_s:.2f} s")
    shapes = sorted(  # (encoder rows, frames) per (bucket, chunks) shape
        (3 * n, -(-max_num_frames(b) // 2 // 256) * 256)
        for b, n in engine._warmed)
    log(f"{tag} files succeeded {succeeded}/{n_calls}, chunk rows "
        f"{len(rows)}, batches dispatched {engine.dispatches} (warmup "
        f"included), encoder batch shapes {shapes}")
    log(f"{tag} {resolved} launches {launches} = 24 x {engine.dispatches}"
        f": {launches == mcfg.num_hidden_layers * engine.dispatches}; "
        f"all launch counts {counts}")
    log(f"{tag} wall {wall_s:.2f} s for {audio_s:.0f} s of audio "
        f"(warmup included): RTFx {audio_s / wall_s:.1f}")
    per_file = {}
    for r in rows:
        per_file[r["file_name"]] = per_file.get(r["file_name"], 0) + 1
    assert succeeded == n_calls and stats["files_success"] == n_calls, stats
    assert stats["errors"] == 0, stats
    # 100 s calls, 25 s chunks with 1 s overlap: starts 0, 24, 48, 72, 96
    assert per_file == {f"call-{i:02d}.wav": 5
                        for i in range(n_calls)}, per_file
    assert not any(r["error"] for r in rows)
    assert (400000, 16) in engine._warmed      # full 48 x 1280 batches ran
    # The kernel phase checked the kernel at every shape this run gave it.
    checked = MAIN_SHAPES if resolved == "flash_rel" else FLASH_SHAPES
    assert set(shapes) <= set(checked), shapes
    assert launches > 0 and launches == mcfg.num_hidden_layers \
        * engine.dispatches
    assert all(n == 0 for name, n in counts.items() if name != kernel), \
        counts
    assert "jax" not in sys.modules
    return {"launches": launches, "other": counts[other]}


def ablation_path(seed: int) -> dict:
    """Phase 6: the ablation tool's entry point over all its variants at
    B=48, H=16, L=1280; launch counts set to 0 just before it."""
    spec = importlib.util.spec_from_file_location(
        "profile_kernel_parts_torch",
        REPO / "tools" / "profile_kernel_parts_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    _reset_launches()
    ms = tool.run(ABLATION_VARIANTS, seed=seed)
    torch.cuda.synchronize()
    counts = _launches()
    per = tool.REPS * (tool.ROUNDS + 1)      # a warm-up loop, then ROUNDS
    expect = {"flash_rel_attention": per, "flash_attention": per,
              "kb640": per, "bare": 2 * per, "variant": 6 * per}
    log(f"[ablation] launches {counts} (expected {expect})")
    assert counts == expect, counts
    return {"launches": counts, "ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    name = card()
    build()
    rel = kernel_vs_plain(args.seed)
    flash = flash_vs_plain(args.seed)
    parts = parts_vs_plain(args.seed)
    small_reference(args.seed, "auto")
    small_reference(args.seed, "flash")
    rel.update(main_path(args.seed, "auto", 8, 3))
    flash.update(main_path(args.seed, "flash", 4, 1))
    assert rel["other"] == 0 and flash["other"] == 0
    ablation = ablation_path(args.seed)
    assert "jax" not in sys.modules
    assert not any(m.split(".")[0] == "audio_processor_tpu"
                   for m in sys.modules), "the JAX package was imported"

    src = "audio_processor_tpu_torch/csrc/"
    tool = "tools/profile_kernel_parts.py"

    def row(name, source, replaces, launches, rec):
        bound_ms, bound_by = rec["bound"]
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": rec["library_ms"]}

    def parts_row(name, modes, timed, replaces):
        ms, plain_ms = parts["times"][timed]
        rec = {"max_abs_err": max(parts["max_abs_err"][m] for m in modes),
               "ms": ms, "plain_ms": plain_ms,
               "library_ms": parts["library"][timed],
               "bound": parts["bounds"]["bare" if name == "bare" else "rel"]}
        return row(f"flash_rel_parts.{name}", "flash_rel_parts.cu",
                   replaces, ablation["launches"][name], rec)

    from audio_processor_tpu_torch.models.flash_rel_parts import (
        VARIANT_MODES,
    )

    kernels = [
        row("flash_rel_attention (onepass)", "flash_rel_attention.cu",
            "audio_processor_tpu/models/flash_rel_attention.py:169",
            rel["launches"], rel),
        row("flash_rel_attention (stream)", "flash_rel_attention.cu",
            "audio_processor_tpu/models/flash_rel_attention.py:73",
            rel["launches"], rel),
        row("flash_attention", "flash_attention.cu",
            "audio_processor_tpu/models/wav2vec2bert.py:276",
            flash["launches"], flash),
        parts_row("kb640", ["kb640"], "kb640", f"{tool}:181"),
        parts_row("bare", ["bare:ones", "bare:reduce"], "bare:ones",
                  f"{tool}:134"),
        parts_row("variant", VARIANT_MODES, "full", f"{tool}:37"),
    ]
    assert all(k["launches"] > 0 for k in kernels), kernels
    log(smi_line())            # again here, beside the numbers it qualifies
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
