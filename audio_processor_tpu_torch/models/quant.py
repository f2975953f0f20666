"""W8A8 int8 inference primitives (port of models/quant.py).

Symmetric per-output-channel int8 weights, made once at load, times
per-token dynamic int8 activations, made inside every product. Used by
the Wav2Vec2Bert encoder and the BERT classifiers when the pipeline
config sets ``quantization: int8``.

The int8 x int8 -> int32 product is ``torch._int_mm``, a library GEMM
(cuBLASLt on the card, the CPU's own on the host): the reference leaves
the same product to XLA's ``dot_general``, not to a Pallas kernel. On
CUDA it takes more than 16 rows and K and N that are multiples of 8;
:func:`dense_int8` refuses other shapes with a ValueError. Every product
of the batch path meets this: the encoder's rows are B x L with L a
multiple of 256 and K, N in {1024, 2048, 4096}, and the classifiers'
rows are a multiple of 16 times a length bucket >= 32 with K, N in
{768, 3072}.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
import torch.nn as nn


def quantize_kernel(kernel: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """[..., d_in, d_out] float kernel -> (int8 kernel, [..., d_out] fp32
    per-out-channel scales): absmax / 127 floored at 1e-12, then
    round-half-even (``torch.round``, as ``jnp.round``). Leading axes
    keep their own scales."""
    k = kernel.float()
    scale = (k.abs().amax(dim=-2, keepdim=True) / 127.0).clamp_min(1e-12)
    kq = torch.round(k / scale).to(torch.int8)
    return kq, scale.squeeze(-2)


class QuantLinear(nn.Module):
    """The int8 twin of an ``nn.Linear``: ``weight_q`` [out, in] int8,
    ``scale`` [out] fp32 and ``bias`` [out] fp32 (or None), as buffers."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.empty(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.empty(out_features))
        self.register_buffer("bias", torch.empty(out_features)
                             if bias else None)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "QuantLinear":
        q = cls(lin.in_features, lin.out_features, lin.bias is not None)
        kq, scale = quantize_kernel(lin.weight.detach().T)
        q.weight_q = kq.T.contiguous()
        q.scale = scale
        if lin.bias is not None:
            q.bias = lin.bias.detach().float()
        return q


def dense_int8(lin: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    """W8A8 ``x @ W^T + b`` with per-token dynamic activation scales, in
    x's dtype: the scales from fp32 x, the int32 product rescaled by
    ``sx`` then ``scale`` and the bias added in fp32."""
    x32 = x.float()
    sx = (x32.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    xq = torch.round(x32 / sx).to(torch.int8).reshape(-1, x.shape[-1])
    if x.is_cuda and (xq.shape[0] <= 16 or xq.shape[1] % 8
                      or lin.out_features % 8):
        raise ValueError(
            f"int8 product of {xq.shape[0]} rows, K={xq.shape[1]}, "
            f"N={lin.out_features}: on CUDA torch._int_mm needs more than "
            "16 rows and K, N multiples of 8")
    y = torch._int_mm(xq, lin.weight_q.t())
    y = y.reshape(*x.shape[:-1], -1).float() * sx * lin.scale
    if lin.bias is not None:
        y = y + lin.bias
    return y.to(x.dtype)


def quantize_linears(root: nn.Module, names: Iterable[str]) -> None:
    """Replace each named ``nn.Linear`` under ``root`` by its
    :class:`QuantLinear`, in place."""
    for name in names:
        parent, _, leaf = name.rpartition(".")
        owner = root.get_submodule(parent) if parent else root
        setattr(owner, leaf, QuantLinear.from_linear(getattr(owner, leaf)))


def is_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, QuantLinear) for m in model.modules())
