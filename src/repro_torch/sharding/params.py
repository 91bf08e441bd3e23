"""Parameter blocks of a mesh (``repro/sharding/params.py``).

The port declares its parameters once, as :func:`~repro_torch.params.
param_specs`: each leaf a :class:`~repro_torch.params.ParamSpec` with its
shape, dtype, init and logical axes. From that declaration come the spec
of each leaf on a mesh (:func:`specs`), the shape of a rank's block
(:func:`local_shapes`), a rank's blocks of a whole tree (:func:`shard`),
and the counts (:func:`n_params`, :func:`param_bytes`). A rank's block of
a sharded dim is one equal part, taken in the order of the mesh axes of
its entry (``ShardCtx.block``), so the blocks of all ranks tile the whole
leaf as JAX's ``NamedSharding`` does. ``init_params(cfg, seed, device,
ctx=)`` draws each leaf whole and keeps the rank's block.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.params import (ParamSpec, init_params, n_params,
                                param_specs, tree_leaves, tree_map)
from repro_torch.sharding.axes import ShardCtx

__all__ = ["specs", "local_shapes", "shard", "n_params", "param_bytes",
           "init_params"]


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def specs(cfg: ModelConfig, ctx: ShardCtx):
    """The spec of every leaf on ``ctx``'s mesh (``axes.logical_to_spec``)."""
    return tree_map(lambda s: ctx.spec(s.axes, s.shape), param_specs(cfg),
                    is_leaf=_is_spec)


def local_shapes(cfg: ModelConfig, ctx: ShardCtx):
    """The shape of this rank's block of every leaf."""
    return tree_map(lambda s: ctx.local_shape(s.axes, s.shape),
                    param_specs(cfg), is_leaf=_is_spec)


def shard(tree, cfg: ModelConfig, ctx: ShardCtx):
    """This rank's block of every leaf of the whole tree ``tree`` (a copy
    of each, so the whole leaves can be freed)."""
    return tree_map(lambda t, s: ctx.block(t, s.axes).clone(), tree,
                    param_specs(cfg))


def param_bytes(cfg: ModelConfig, ctx: ShardCtx | None = None) -> int:
    """Bytes of the whole model's parameters, or of one rank's blocks with
    a ``ctx``."""
    total = 0
    for s in tree_leaves(param_specs(cfg), is_leaf=_is_spec):
        shape = s.shape if ctx is None else ctx.local_shape(s.axes, s.shape)
        total += math.prod(shape) * s.dtype.itemsize
    return total


def check_local(params, cfg: ModelConfig, ctx: ShardCtx) -> None:
    """Raise unless every leaf of ``params`` has this rank's block shape."""
    got = tree_map(lambda t: tuple(t.shape), params,
                   is_leaf=lambda x: isinstance(x, torch.Tensor))
    want = local_shapes(cfg, ctx)
    if got != want:
        raise ValueError(f"parameters are not this rank's blocks of "
                         f"{cfg.name} on a mesh of {ctx.sizes}: got {got}, "
                         f"want {want}")
