"""Logical-axis → mesh-axis sharding rules (``repro/sharding/axes.py``).

Every parameter dimension carries a *logical* axis name; a rule table maps
logical names to mesh axes. A rule drops a mesh axis when the dimension is
not divisible by the axis size (8 KV heads on a 16-way ``model`` axis stay
whole), so one table holds for every architecture.

Model code threads a :class:`ShardCtx` explicitly. On one device (no mesh)
every axis has size 1: nothing is sharded and no collective runs, so the
single-device path is the code that ran before the mesh existed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import torch

# Logical axis vocabulary (DESIGN.md §3):
#   batch     global batch                     → (pod, data)
#   seq       sequence (residual stream, SP)   → model
#   kv_seq    decode KV-cache sequence         → model   (flash-decoding)
#   embed     d_model (params; FSDP)           → data   [+ pod for huge models]
#   vocab     vocabulary                       → model
#   heads     query heads                      → model
#   kv_heads  kv heads                         → model (if divisible)
#   mlp       ffn hidden                       → model
#   experts   MoE expert axis                  → model (EP)
#   d_inner   mamba inner channels             → model
#   layers    stacked scan axis                → None
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": ("model",),
    "kv_seq": ("model",),
    "embed": ("data",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "qk": (),
    "v": (),
    "mlp": ("model",),
    "experts": ("model",),
    "layers": (),
    "d_inner": ("model",),
    "ssm_state": (),
    "ssm_heads": ("model",),
    "conv": (),
    "lora": (),
    "frontend": (),
    "null": (),
}

# For very large models (≳100 B params) optimizer state must shard over the
# pod axis too.
ZERO_POD_RULES = dict(DEFAULT_RULES, embed=("pod", "data"), experts=("model",))

Spec = tuple            # one entry per dim: None, an axis name or a tuple


def logical_to_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                    mesh_shape: Mapping[str, int],
                    rules: Mapping[str, tuple[str, ...]] | None = None
                    ) -> Spec:
    """Map logical axis names to a spec, one entry per dim: None, a mesh
    axis name, or a tuple of names. Each dim keeps the largest prefix of
    its rule's mesh axes whose product divides it (axes of size 1 are
    skipped), and a mesh axis serves at most one dim."""
    rules = rules or DEFAULT_RULES
    spec: list = []
    used: set[str] = set()
    for dim, name in zip(shape, axes):
        if name is None:
            spec.append(None)
            continue
        mesh_axes = [a for a in rules.get(name, ())
                     if a in mesh_shape and a not in used]
        keep: list[str] = []
        prod = 1
        for a in mesh_axes:
            if mesh_shape[a] > 1 and dim % (prod * mesh_shape[a]) == 0:
                keep.append(a)
                prod *= mesh_shape[a]
            elif mesh_shape[a] == 1:
                continue
            else:
                break
        used.update(keep)
        if not keep:
            spec.append(None)
        elif len(keep) == 1:
            spec.append(keep[0])
        else:
            spec.append(tuple(keep))
    return tuple(spec)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The mesh and the rule table threaded through the model code.

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` (None on one
    device). ``sizes`` and ``coords`` (each axis's size and this rank's
    coordinate on it) are read from the mesh; given without a mesh they
    describe a rank of a mesh that is not running, which is enough to cut
    that rank's parameter blocks but not to run a collective."""
    mesh: object = None
    rules: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    sizes: Optional[Mapping[str, int]] = None
    coords: Optional[Mapping[str, int]] = None

    def __post_init__(self):
        if self.mesh is not None:
            names = tuple(self.mesh.mesh_dim_names)
            object.__setattr__(self, "sizes", dict(zip(
                names, (int(s) for s in self.mesh.shape))))
            object.__setattr__(self, "coords", {
                n: int(self.mesh.get_local_rank(n)) for n in names})
        sizes = dict(self.sizes or {})
        coords = dict(self.coords or {n: 0 for n in sizes})
        if set(coords) != set(sizes) or any(
                not 0 <= coords[n] < sizes[n] for n in sizes):
            raise ValueError(f"coords {coords} do not lie on a mesh of "
                             f"{sizes}")
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "coords", coords)

    def axis_size(self, name: str) -> int:
        return self.sizes.get(name, 1)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (0 on an absent axis)."""
        return self.coords.get(name, 0)

    def group(self, name: str):
        """The process group of axis ``name`` (this rank's line of the
        mesh along it)."""
        if self.mesh is None:
            raise ValueError(f"axis {name!r} has no process group: the "
                             "context holds no running mesh")
        return self.mesh.get_group(name)

    def spec(self, axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> Spec:
        return logical_to_spec(axes, shape, self.sizes, self.rules)

    def local_shape(self, axes: Sequence[Optional[str]],
                    shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of this rank's block of a tensor of ``shape``."""
        spec = self.spec(axes, shape)
        return tuple(d // mesh_axis_size(self.sizes, _entry_axes(e))
                     for d, e in zip(shape, spec))

    def block(self, t: torch.Tensor,
              axes: Sequence[Optional[str]]) -> torch.Tensor:
        """This rank's block of the whole tensor ``t``, a view: each
        sharded dim cut into equal parts, the mesh axes of its entry
        major to minor, as JAX lays a ``PartitionSpec`` out."""
        spec = self.spec(axes, t.shape)
        for dim, entry in enumerate(spec):
            names = _entry_axes(entry)
            if not names:
                continue
            part, idx = 1, 0
            for n in names:
                part *= self.sizes[n]
                idx = idx * self.sizes[n] + self.coords[n]
            size = t.shape[dim] // part
            t = t.narrow(dim, idx * size, size)
        return t


def single_device_ctx() -> ShardCtx:
    """No mesh: every axis has size 1 (the smoke tests' context)."""
    return ShardCtx()


def mesh_axis_size(mesh, names: Sequence[str]) -> int:
    """The product of the sizes of ``names`` on ``mesh`` (a DeviceMesh, a
    mapping of axis sizes, or None for one device)."""
    if mesh is None:
        return 1
    if not isinstance(mesh, Mapping):
        mesh = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    return math.prod(mesh.get(n, 1) for n in names)


def model_shard(ctx: Optional[ShardCtx]) -> tuple[int, int]:
    """(size of the ``model`` axis, this rank's index on it); (1, 0) with
    no context."""
    if ctx is None:
        return 1, 0
    return ctx.axis_size("model"), ctx.axis_index("model")
