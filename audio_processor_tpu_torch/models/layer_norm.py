"""LayerNorm in fp32 statistics, and the conformer's LayerNorm fused with
the residual add before it and the padding mask or SiLU after it (CUDA).

:func:`layer_norm` is the port's LayerNorm: the input upcast to fp32,
normalised, and cast back to its dtype. :func:`add_layer_norm` computes

    r = branch * alpha + x          (r = x without a branch)
    y = layer_norm(ln, r)
    y = y * mask[..., None]  or  y = silu(y)       (optional)

and returns (r, y) over rows of the last dimension (r None when
``residual`` is False). Two implementations of it live here:

- :func:`add_layer_norm_plain`, in PyTorch: exactly the composition the
  conformer ran before the kernel, each op in the input's dtype;
- the CUDA kernel (``csrc/add_layer_norm.cu``): bf16 rows, fp32
  statistics, fp32 gamma and beta, each rounding to bf16 where the plain
  composition rounds, so r is the plain r bit for bit (for any alpha)
  and y is within one bf16 step of the plain y (the row's sums run in
  another order; near 0 that order's ~1e-6 exceeds a step).

:func:`add_layer_norm` runs the plain version on CPU tensors and launches
the kernel on CUDA tensors, or raises: on an fp32 row, and (as every
kernel wrapper of the port does) on an operand that requires grad while
autograd records, since the kernel has no backward. The caller chooses
between the two: the conformer takes the kernel where its input says so
(:func:`fused`: a bf16 CUDA input with autograd recording no gradient
of it or of the layer's parameters) and :func:`add_layer_norm_plain`
everywhere else, so fp32 compute (true fp32), CPU tensors, training and
remat's recompute run the plain composition.

``add_layer_norm.launches`` counts kernel launches; each replay of a CUDA
graph adds the launches its capture recorded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_processor_tpu_torch.models import _cuda_call

MAX_WIDTH = 4096      # the kernel's widest row (a multiple of 8)
EPILOGUES = {"none": 0, "mask": 1, "silu": 2}


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32, returned in x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def fused(x: torch.Tensor, module: nn.Module) -> bool:
    """Whether ``module``'s LayerNorms on ``x`` take the kernel
    (:func:`add_layer_norm`) rather than :func:`add_layer_norm_plain`: x
    is a bf16 CUDA tensor and autograd records no gradient of x or of
    ``module``'s parameters."""
    return (_on_card(x) and x.dtype == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and (x.requires_grad
                          or any(p.requires_grad
                                 for p in module.parameters()))))


def _epilogue(mask, silu: bool) -> str:
    if mask is not None and silu:
        raise ValueError("add_layer_norm takes a mask or silu, not both")
    return "mask" if mask is not None else "silu" if silu else "none"


def add_layer_norm_plain(ln: nn.LayerNorm, x: torch.Tensor,
                         branch: Optional[torch.Tensor] = None,
                         alpha: float = 1.0, *,
                         mask: Optional[torch.Tensor] = None,
                         silu: bool = False, residual: bool = True
                         ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The PyTorch version: the add (a product by ``alpha`` unless it is
    1, then the sum) in x's dtype, :func:`layer_norm`, then the mask
    product or SiLU in x's dtype."""
    _epilogue(mask, silu)
    r = x if branch is None else branch + x if alpha == 1 else \
        branch * alpha + x
    y = layer_norm(ln, r)
    if mask is not None:
        y = y * mask[..., None].to(y.dtype)
    elif silu:
        y = F.silu(y)
    return (r if residual else None), y


def columns(x: torch.Tensor) -> bool:
    """Whether x [B, L, C] is the transpose of a contiguous [B, C, L] (the
    depthwise convolution's output), which the kernel reads as it lies."""
    return (not x.is_contiguous() and x.dim() == 3
            and x.transpose(1, 2).is_contiguous())


def _check(ln, x, branch, mask, silu: bool) -> str:
    """Raise ValueError on operands the kernel does not take; returns the
    epilogue's name."""
    epilogue = _epilogue(mask, silu)
    if branch is not None and columns(x):
        raise ValueError("a branch needs x in rows (contiguous)")
    C = x.shape[-1] if x.dim() else 0
    if C % 8 or not 8 <= C <= MAX_WIDTH:
        raise ValueError(f"row width {C} must be a multiple of 8 in "
                         f"[8, {MAX_WIDTH}]")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if branch is not None and (branch.dtype != x.dtype
                               or branch.shape != x.shape):
        raise ValueError(f"branch must match x ({x.dtype} "
                         f"{tuple(x.shape)}), got {branch.dtype} "
                         f"{tuple(branch.shape)}")
    for name, p in (("weight", ln.weight), ("bias", ln.bias)):
        if p is None or p.dtype != torch.float32 or tuple(p.shape) != (C,):
            raise ValueError(f"the LayerNorm's {name} must be float32 "
                             f"({C},)")
    if mask is not None and (mask.dtype != torch.float32
                             or mask.shape != x.shape[:-1]):
        raise ValueError(f"mask must be float32 {tuple(x.shape[:-1])}, "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    named = [("x", x.transpose(1, 2) if columns(x) else x),
             ("branch", branch), ("weight", ln.weight), ("bias", ln.bias),
             ("mask", mask)]
    _cuda_call.check_tensors(x.device, [(n, t) for n, t in named
                                        if t is not None])
    return epilogue


def _launch(ln, x, branch, alpha, mask, silu, residual):
    epilogue = _check(ln, x, branch, mask, silu)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    r = torch.empty_like(y) if branch is not None and residual else None
    ptr = (lambda t: None if t is None else t.data_ptr())
    C = x.shape[-1]
    _cuda_call.call(
        "add_layer_norm", "pppppppiiiffi", x.device, x.data_ptr(),
        ptr(branch), ln.weight.data_ptr(), ln.bias.data_ptr(), ptr(mask),
        ptr(r), y.data_ptr(), x.numel() // C,
        x.shape[1] if columns(x) else 0, C, float(alpha), float(ln.eps),
        EPILOGUES[epilogue])
    _cuda_call.count_launch(add_layer_norm)
    if branch is None:
        r = x
    return (r if residual else None), y


def add_layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
                   branch: Optional[torch.Tensor] = None,
                   alpha: float = 1.0, *,
                   mask: Optional[torch.Tensor] = None, silu: bool = False,
                   residual: bool = True
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(r, y): r = branch * alpha + x (x itself without a branch; None
    when ``residual`` is False), y = ``ln``(r) in x's dtype, then times
    ``mask`` [...] (one value per row) or through SiLU.

    x and branch share a dtype. CPU tensors take the plain version. CUDA
    tensors launch the kernel, which takes bf16 rows of a multiple of 8
    up to ``MAX_WIDTH``, contiguous (or, without a branch, x [B, L, C] the
    transpose of a contiguous [B, C, L]: :func:`columns`), 16-byte
    aligned, fp32 gamma and beta and an fp32 mask, and raises on anything
    else; y comes back contiguous. Any other device raises. The kernel
    has no backward, so operands that require grad raise while autograd
    records, on every device."""
    _cuda_call.refuse_autograd("add_layer_norm", x, branch, ln.weight,
                               ln.bias, mask)
    if branch is not None and branch.dtype != x.dtype:
        raise ValueError(f"branch {branch.dtype} and x {x.dtype} differ")
    if _on_card(x):
        return _launch(ln, x, branch, alpha, mask, silu, residual)
    if x.device.type != "cpu":
        raise ValueError(f"add_layer_norm runs on cpu (plain) or cuda "
                         f"(kernel), not {x.device}")
    return add_layer_norm_plain(ln, x, branch, alpha, mask=mask, silu=silu,
                                residual=residual)


add_layer_norm.launches = 0
