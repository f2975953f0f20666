#!/usr/bin/env python
"""Ablate the flash-rel attention kernel's cost components on one CUDA
card (the PyTorch port's counterpart of tools/profile_kernel_parts.py).

    python3 tools/profile_kernel_parts_torch.py [variants...] [--root DIR]

Variants (timing only; the numerics of the ablated ones are wrong by
design), default ``full noselect norel``:
  full       flash-rel from precomputed bucket logits s_rel: saturated
             bias gather, online softmax, 256-column kv steps
  noselect   the bias from a 256-wide wrapped table, no saturation
  norel      no bias (the same kernel structure)
  nomax      no running max: exp of the raw scores
  nosoftmax  no max, no exp: p = s
  noexp      exp replaced by a multiply
  kb640      full in two 640-column kv steps
  bare[:ones|reduce]  no bias, no mask; row sum of bf16 p or of fp32 p
  shipped    the main path's kernel (csrc/flash_rel_attention.cu), which
             computes its bucket logits from the [73, 64] table itself
  stock[:bq:bk]  the flash kernel (csrc/flash_attention.cu) without a
             bias; the Pallas block sizes do not apply to the CUDA
             kernel's fixed 64 x 64 tiles and are ignored

The ablation variants run csrc/flash_rel_parts.cu, which has the design
of ``shipped`` (tensor cores, wgmma for both products, p in registers)
but its step of 256 (kb640: 640) columns for one max and one rescale,
four score tiles live where ``shipped`` keeps one; kb640 computes each
step's scores twice (a max pass, then p). So a difference between two
variants prices a part of the main path's kernel, and ``shipped`` −
``full`` prices its in-kernel bucket logits together with that layout.

B=48, H=16, L=1280, D=64, bf16 q/k/v and fp32 s_rel ~ 0.05 N(0, 1), kv
mask all ones. Each timed point runs the kernel 8 times with a data
dependency (q += 0 * out) between CUDA events; best of 4, after one
warm-up. The dependency step alone (two elementwise passes over q) is
timed the same way and subtracted. Prints ms per call, net and gross,
and x24 (one per encoder layer); the last line is one JSON object with
the net times, the step, the card's name and power limit and the
package's directory. ``--root`` imports ``audio_processor_tpu_torch``
from another checkout (for example the parent commit unpacked with
``git archive``), whose kernels build into that tree, so that one
command can time two trees in turns: parent, change, change, parent,
each a process of its own. Imports nothing of JAX. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch

B, H, L, D = 48, 16, 1280, 64
NUM_BUCKETS, LEFT = 73, 64
REPS, ROUNDS, LAYERS = 8, 4, 24
DEFAULT = ("full", "noselect", "norel")


def inputs(seed: int = 0) -> tuple:
    """q, k, v [B, H, L, D] bf16, s_rel [B, H, L, 128] fp32, kv_mask
    [B, L] fp32 and the [73, D] bf16 table, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * 0.05).to(dtype)

    q, k, v = (normal(B, H, L, D) for _ in range(3))
    s_rel = normal(B, H, L, 128, dtype=torch.float32)
    kv_mask = torch.ones(B, L, device="cuda")
    E = normal(NUM_BUCKETS, D)
    return q, k, v, s_rel, kv_mask, E


def call_for(name: str, E: torch.Tensor):
    """The function ``(q, k, v, s_rel, kv_mask) -> out`` of a variant."""
    from audio_processor_tpu_torch.models import flash_rel_parts as frp
    from audio_processor_tpu_torch.models.flash_attention import (
        flash_attention,
    )
    from audio_processor_tpu_torch.models.flash_rel_attention import (
        flash_rel_attention,
    )

    if name == "shipped":
        return lambda q, k, v, s_rel, kv_mask: flash_rel_attention(
            q, k, v, E, kv_mask, frp.SCALE, LEFT, NUM_BUCKETS)
    if name == "kb640":
        return frp.kb640
    if name.startswith("bare"):
        rowsum = name.split(":")[1] if ":" in name else "ones"
        return lambda q, k, v, s_rel, kv_mask: frp.bare(q, k, v, rowsum)
    if name.startswith("stock"):
        if ":" in name:
            print(f"{name}: Pallas block sizes do not apply to the CUDA "
                  f"kernel's 64 x 64 tiles; ignored", flush=True)
        return lambda q, k, v, s_rel, kv_mask: flash_attention(
            q, k, v, sm_scale=frp.SCALE)
    if name in frp.VARIANT_MODES:
        return lambda q, k, v, s_rel, kv_mask: frp.variant(
            q, k, v, s_rel, kv_mask, mode=name)
    raise ValueError(f"unknown variant {name!r}")


def bench(call, args) -> float:
    """Best of ROUNDS CUDA-event timings of REPS dependent calls; ms per
    call, the dependency step included."""
    q, k, v, s_rel, kv_mask = args

    def looped():
        qq = q
        for _ in range(REPS):
            qq = qq + 0.0 * call(qq, k, v, s_rel, kv_mask)
        return qq

    looped()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        looped()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / REPS)
    return best


def run(variants, seed: int = 0) -> dict:
    """Time each variant; returns {variant: ms per call} net of the
    dependency step (under "step": the step alone)."""
    q, k, v, s_rel, kv_mask, E = inputs(seed)
    args = (q, k, v, s_rel, kv_mask)
    step = bench(lambda q, *_: q, args)
    print(f"{'step':12s}: {step:7.3f} ms (the dependency step alone; "
          f"subtracted below)", flush=True)
    net = {"step": step}
    for name in variants:
        gross = bench(call_for(name, E), args)
        net[name] = gross - step
        print(f"{name:12s}: {net[name]:7.3f} ms/layer-call (gross "
              f"{gross:.3f})  x{LAYERS} = {net[name] * LAYERS:7.1f} ms",
              flush=True)
    return net


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", default=list(DEFAULT))
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_kernel_parts_torch: needs a CUDA device")
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import audio_processor_tpu_torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]
    package = os.path.dirname(audio_processor_tpu_torch.__file__)
    print(f"{smi}; device: {torch.cuda.get_device_name(0)}; B={B} H={H} "
          f"L={L} D={D} bf16; package from {package}", flush=True)
    net = run(args.variants)
    assert "jax" not in sys.modules
    print(json.dumps({"package": package, "card": smi, "net_ms": net}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
