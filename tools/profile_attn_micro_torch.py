#!/usr/bin/env python
"""The attention primitive at production geometry on one CUDA card (the
PyTorch port's counterpart of tools/profile_attn_micro.py): the
flash_rel kernel against the flash kernel without a bias (the flash
formulation's floor) and raw q.k^T and p.v products (torch.matmul, bf16
on the tensor cores: the bound a redesign of the kernel aims at), with
and without a softmax between them. Bounds how much headroom the
flash_rel kernel has.

    python3 tools/profile_attn_micro_torch.py [reps]

B=48, H=16, L=1280, D=64, bf16, ~0.05 N(0, 1) inputs. Each point is the
best of ``reps`` (default 5) CUDA-event timings of one call, after one
warm-up; ms per call and x24 (one per encoder layer). Imports nothing
of JAX. Needs CUDA.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch

B, H, L, D = 48, 16, 1280, 64
NUM_BUCKETS, LEFT = 73, 64
LAYERS = 24
SCALE = 1.0 / D ** 0.5


def bench(name: str, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    print(f"{name:28s}: {best:7.3f} ms/call  x{LAYERS} layers = "
          f"{best * LAYERS:7.1f} ms  (sum={float(out.float().sum()):.3e})",
          flush=True)
    return best


def main() -> int:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    if not torch.cuda.is_available():
        sys.exit("profile_attn_micro_torch: needs a CUDA device")
    from audio_processor_tpu_torch.models.flash_attention import (
        flash_attention,
    )
    from audio_processor_tpu_torch.models.flash_rel_attention import (
        flash_rel_attention,
    )

    print(f"device: {torch.cuda.get_device_name(0)}; B={B} H={H} L={L} "
          f"D={D} bf16", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * 0.05).to(torch.bfloat16)

    q, k, v = (normal(B, H, L, D) for _ in range(3))
    E = normal(NUM_BUCKETS, D)
    kv_mask = torch.ones(B, L, device="cuda")

    bench("flash_rel (kernel)", lambda: flash_rel_attention(
        q, k, v, E, kv_mask, SCALE, LEFT, NUM_BUCKETS), reps)
    bench("flash, no bias (kernel)", lambda: flash_attention(
        q, k, v, sm_scale=SCALE), reps)

    def raw():
        s = torch.matmul(q, k.transpose(-1, -2))
        return torch.matmul((s * SCALE).to(torch.bfloat16), v)

    def raw_softmax():
        s = torch.matmul(q, k.transpose(-1, -2)).float()
        p = torch.softmax(s * SCALE, dim=-1).to(torch.bfloat16)
        return torch.matmul(p, v)

    bench("raw qk+pv matmuls (bound)", raw, reps)
    bench("raw matmuls + softmax", raw_softmax, reps)
    assert "jax" not in sys.modules
    return 0


if __name__ == "__main__":
    sys.exit(main())
