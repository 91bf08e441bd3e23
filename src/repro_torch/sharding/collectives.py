"""The collectives the sharded model code calls, over one mesh axis of a
:class:`~repro_torch.sharding.axes.ShardCtx`: a tiled all-gather along a
dim, an all-reduce (sum or max) and a broadcast from the axis's first
rank. The residual stream stays whole on every rank, so no module ends
in a reduce-scatter yet (JAX's sequence-sharded stream and training
would want one).

Each is the identity on an axis of one rank (no process group is touched,
nothing is copied). Each runs on the backend that owns the tensor's
device, NCCL for CUDA tensors (inside a CUDA graph's capture too) and gloo
for tensors on the host, and raises on any other pairing: gloo would take
a CUDA tensor by copying it through the host, which the sharded path never
does quietly. A collective that fails raises, so a rank never goes on
with a partial result.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding.axes import ShardCtx

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _group(x: torch.Tensor, ctx: ShardCtx, axis: str):
    """The process group of ``axis``, checked against ``x``'s device."""
    group = ctx.group(axis)
    backend = str(dist.get_backend(group)).lower()
    want = _BACKEND.get(x.device.type)
    if want is None or want not in backend:
        raise ValueError(f"a {x.device.type} tensor cannot take a "
                         f"{backend} collective (it wants {want})")
    return group


def all_gather(x: torch.Tensor, dim: int, ctx: ShardCtx,
               axis: str = "model") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    n = ctx.axis_size(axis)
    if n == 1:
        return x
    group = _group(x, ctx, axis)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, ctx: ShardCtx, axis: str = "model",
               op: str = "sum") -> torch.Tensor:
    """The ranks' ``x`` reduced by ``op`` ("sum" or "max"): a new tensor,
    ``x`` is left as it was."""
    if ctx.axis_size(axis) == 1:
        return x
    group = _group(x, ctx, axis)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def broadcast(x: torch.Tensor, ctx: ShardCtx,
              axis: str = "model") -> torch.Tensor:
    """The first rank of ``axis``'s ``x`` on every rank of it, written
    into ``x`` (which must be contiguous)."""
    if ctx.axis_size(axis) == 1:
        return x
    group = _group(x, ctx, axis)
    if not x.is_contiguous():
        raise ValueError("broadcast writes in place: x must be contiguous")
    dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x
