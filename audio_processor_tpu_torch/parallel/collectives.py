"""Collectives over one process group, plain and inside autograd.

Every collective of the port goes through here. This is the one place
that knows what ``gloo`` lacks on CUDA tensors: it runs all-reduce and
broadcast on them directly, but neither all-gather nor point-to-point. So
on a gloo group :func:`all_gather`, :func:`send` and :func:`recv` stage a
CUDA tensor through the host (a copy to the CPU, the collective there, a
copy back); the computation around them stays on the card. NCCL groups
take every operation on the card. A group of one process (or ``None``
outside a launch) makes every operation the identity.

The autograd operations follow the tensor-parallel convention that the
loss is replicated on every rank of the group, so a gradient arriving at
a replicated tensor is already whole:

- :func:`copy_to_group`: identity forward, gradient summed over the group
  (a replicated input into a rank's shard of the work);
- :func:`reduce_from_group`: sum forward, identity backward (partial
  results of a row-parallel product);
- :func:`gather_partial`: all-gather forward; backward sums the gradient
  over the group and keeps this rank's slice (each rank's downstream work
  uses the gathered tensor differently, as keys and values gathered for
  local queries are);
- :func:`gather_replicated`: all-gather forward; backward keeps this
  rank's slice (every rank computes the same thing from the gathered
  tensor, as the CTC loss on gathered logits).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

ProcessGroup = Optional[dist.ProcessGroup]


def group_size(group: ProcessGroup) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group: ProcessGroup) -> int:
    if group is None or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _staged(t: torch.Tensor, group: ProcessGroup) -> bool:
    """True when ``t`` must go through the host: a CUDA tensor on gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group: ProcessGroup,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce (gloo runs it on CUDA tensors itself)."""
    if group_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group: ProcessGroup
               ) -> torch.Tensor:
    """In-place broadcast from the global rank ``src``."""
    if group_size(group) > 1:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group: ProcessGroup
               ) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order
    (equal shapes). On gloo a CUDA tensor is staged through the host."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.detach().contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def send(t: torch.Tensor, dst: int, group: ProcessGroup = None) -> None:
    """Blocking send to the global rank ``dst`` (staged through the host
    on gloo)."""
    t = t.detach().contiguous()
    if _staged(t, group):
        t = t.cpu()
    dist.send(t, dst=dst, group=group)


def recv(shape, dtype: torch.dtype, device: torch.device, src: int,
         group: ProcessGroup = None) -> torch.Tensor:
    """Blocking receive from the global rank ``src`` into a new tensor on
    ``device`` (staged through the host on gloo)."""
    buf = torch.empty(shape, dtype=dtype, device=device)
    if _staged(buf, group):
        host = torch.empty(shape, dtype=dtype)
        dist.recv(host, src=src, group=group)
        return host.to(device)
    dist.recv(buf, src=src, group=group)
    return buf


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, partial):
        ctx.dim, ctx.group, ctx.partial = dim, group, partial
        ctx.size = x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = all_reduce_(g.contiguous().clone(), ctx.group)
        start = group_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, start, ctx.size).contiguous(), None, None, \
            None


def copy_to_group(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def gather_partial(x: torch.Tensor, dim: int, group: ProcessGroup
                   ) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, dim, group, True)


def gather_replicated(x: torch.Tensor, dim: int, group: ProcessGroup
                      ) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, dim, group, False)
