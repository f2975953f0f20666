#!/usr/bin/env python
"""The port's two attention kernels at the production geometry on one
CUDA card, beside their bound and the one PyTorch call that computes the
same function, with a check of each kernel against its plain version
first.

    python3 tools/bench_attention_torch.py [--root DIR] [--reps N]
        [--no-library] [--label TEXT]

``--root`` imports ``audio_processor_tpu_torch`` from another checkout
(for example the parent commit unpacked with ``git archive``), so that
one command can time two trees in turns: parent, change, change, parent,
each a process of its own. The kernels build into that tree.

At B=48, H=16, L=1280, d=64, bf16 (every main-path layer call), P=73,
left=64:

- ``flash_rel``: ``models/flash_rel_attention.py::flash_rel_attention``
  with every batch row's own valid kv length;
- ``flash_ab``: ``models/flash_attention.py::flash_attention`` on the
  bias the model materialises under ``attention_impl: flash`` (bf16
  relative logits + kv mask, ``wav2vec2bert.flash_bias``);
- ``flash``: the same kernel without a bias.

Each kernel is first held against its plain version (bf16 tolerance
atol 1e-2 + rtol 1e-2) at B=2 with L = 64, 320 and 1280, and at the
timed shape. Times are CUDA events over a loop of launches, the best of
``--reps`` loops. ``library``: ``F.scaled_dot_product_attention`` on the
same inputs (with ``attn_mask = ab * scale``, pre-scaled outside the
timed call, because the library computes ``q.k^T * scale + mask``; and
without a mask), and the backend it ran, read from the profiler's
kernel names. The flash_rel kernel builds its bias inside: no library
call takes the bucket table, so its ``library`` time is that of the
materialised bias, for reference only.

The last line is one JSON object with every number, the card's name and
power limit. Imports nothing of JAX. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

B, H, L, D = 48, 16, 1280, 64
P, LEFT = 73, 64
SCALE = 0.125
TOL = (1e-2, 1e-2)
HBM_BYTES_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
BF16_FLOPS = 989e12          # dense bf16 tensor-core peak, same source


def bound_ms(nbytes: float, flops: float) -> tuple:
    """(bound in ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_bounds(b, h, n, p) -> dict:
    """Bounds of the three functions at (b, h, n) bf16, d = 64: q, k, v
    read once and o written once; the bias, where it is an input, read
    once; the products 4*b*h*n^2*d FLOP (flash_rel adds q.E^T)."""
    qkvo = 4 * b * h * n * D * 2
    products = 4 * b * h * n * n * D
    return {
        "flash_rel": bound_ms(qkvo + p * D * 2 + b * n * 4,
                              products + 2 * b * h * n * p * D),
        "flash_ab": bound_ms(qkvo + b * h * n * n * 2, products),
        "flash": bound_ms(qkvo, products),
    }


def card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"smi": smi.splitlines()[0],
            "device": torch.cuda.get_device_name(0)}


def cuda_ms(fn, reps: int, loop: int = 10) -> list:
    """ms per call of ``loop`` back-to-back calls, ``reps`` times."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(loop):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / loop)
    return out


def held(out, ref, live, label: str) -> float:
    atol, rtol = TOL
    err = (out[live].float() - ref[live].float()).abs()
    used = float((err / (atol + rtol * ref[live].float().abs())).max())
    ok = used <= 1.0 and bool(torch.isfinite(out).all())
    print(f"[check] {label}: max_abs {float(err.max()):.3e}, worst err/tol "
          f"{used:.3f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"kernel disagrees with plain: {label}")
    return float(err.max())


def inputs(gen, b, n):
    """bf16 q, k, v [b, 16, n, 64], fp32 E [73, 64], every batch row its
    own valid kv length (row 0 full), and the model's flash bias."""
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v

    dev = torch.device("cuda")
    q, k, v = (torch.randn(b, H, n, D, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    E = torch.randn(P, D, generator=gen).to(dev)
    valid = torch.randint(max(1, n // 8), n + 1, (b,), generator=gen)
    valid[0] = n
    mask = (torch.arange(n)[None, :] < valid[:, None]).float().to(dev)
    ab = w2v.flash_bias(w2v.W2VBertConfig(), q, E.to(q.dtype),
                        ((1.0 - mask) * -1e9)[:, None, None, :], SCALE)
    return q, k, v, E, mask, ab


def backend_of(fn) -> str:
    """The device kernels one call of ``fn`` runs, by name."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    return "; ".join(n[:80] for n in names)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-library", action="store_true")
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_attention_torch: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from audio_processor_tpu_torch import _build
    from audio_processor_tpu_torch.models import flash_attention as fa
    from audio_processor_tpu_torch.models import flash_rel_attention as fra

    info = card()
    print(info["smi"], flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all(["flash_rel_attention", "flash_attention"])
    print(f"[build] {time.perf_counter() - t0:.1f} s: "
          f"{sorted(str(p) for p in libs.values())}", flush=True)
    gen = torch.Generator().manual_seed(args.seed)

    def rel(a):
        return fra.flash_rel_attention(a[0], a[1], a[2], a[3], a[4], SCALE,
                                       LEFT, P)

    def rel_plain(a):
        return fra.flash_rel_attention_plain(a[0], a[1], a[2], a[3], a[4],
                                             SCALE, LEFT, P)

    err = {"flash_rel": 0.0, "flash_ab": 0.0, "flash": 0.0}
    for b, n in ((2, 64), (2, 320), (2, 1280), (B, L)):
        a = inputs(gen, b, n)
        live = a[4].bool().any(dim=1)
        everyone = torch.ones(b, dtype=torch.bool)
        tag = f"B={b:2d} H=16 L={n:4d} bf16"
        err["flash_rel"] = max(err["flash_rel"], held(
            rel(a), rel_plain(a), live, f"flash_rel {tag}"))
        err["flash_ab"] = max(err["flash_ab"], held(
            fa.flash_attention(a[0], a[1], a[2], a[5], SCALE),
            fa.flash_attention_plain(a[0], a[1], a[2], a[5], SCALE), live,
            f"flash_ab  {tag}"))
        err["flash"] = max(err["flash"], held(
            fa.flash_attention(a[0], a[1], a[2], None, SCALE),
            fa.flash_attention_plain(a[0], a[1], a[2], None, SCALE),
            everyone, f"flash     {tag}"))
    q, k, v, E, mask, ab = a
    del a

    ms = {
        "flash_rel": cuda_ms(lambda: fra.flash_rel_attention(
            q, k, v, E, mask, SCALE, LEFT, P), args.reps),
        "flash_ab": cuda_ms(lambda: fa.flash_attention(q, k, v, ab, SCALE),
                            args.reps),
        "flash": cuda_ms(lambda: fa.flash_attention(q, k, v, None, SCALE),
                         args.reps),
    }
    for name, t in ms.items():
        print(f"[time] {name:9s} B={B} H={H} L={L} bf16: {t} ms "
              f"(best {min(t):.4f})", flush=True)
    out = {"label": args.label, "card": info["smi"],
           "device": info["device"], "torch": torch.__version__,
           "shape": [B, H, L, D], "max_abs_err": err,
           "ms": {name: min(t) for name, t in ms.items()},
           "ms_all": ms,
           "bound": {name: {"ms": b_ms, "by": by} for name, (b_ms, by)
                     in attention_bounds(B, H, L, P).items()}}
    if not args.no_library:
        mask_ab = ab * SCALE                   # outside the timed call
        calls = {
            "flash_ab": lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask_ab, scale=SCALE),
            "flash": lambda: F.scaled_dot_product_attention(
                q, k, v, scale=SCALE),
        }
        ref = fa.flash_attention_plain(q, k, v, ab, SCALE)
        live = mask.bool().any(dim=1)
        held(calls["flash_ab"](), ref, live, "library flash_ab vs plain")
        lib = {name: cuda_ms(fn, args.reps) for name, fn in calls.items()}
        out["library_ms"] = {name: min(t) for name, t in lib.items()}
        out["library_backend"] = {name: backend_of(fn)
                                  for name, fn in calls.items()}
        for name in calls:
            print(f"[library] {name:9s}: {lib[name]} ms, kernels: "
                  f"{out['library_backend'][name]}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
