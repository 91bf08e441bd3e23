"""Parameter tree of the port (``repro/sharding/params.py`` +
``repro/models/model.py::model_defs``).

The tree keeps the JAX layouts leaf by leaf — ``wq`` (D,H,dh), ``wk``/``wv``
(D,Hkv,dh), ``wo`` (H,dh,D), ``w_up``/``w_gate`` (D,F), ``w_down`` (F,D),
the embedding (V,D), the unembedding (D,V), f32 norm weights — but holds
the blocks as a plain list ``layers`` in layer order instead of stacked
scan segments:

    {"embed": {"table"}, "layers": [{"norm1", "attn": {...}, "norm2",
     "mlp": {...}}, ...], "final_norm", "unembed": {"w"}}
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import check_supported, layer_schedule

F32 = torch.float32


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype
    init: str = "normal"          # normal | ones | zeros (caches)
    scale: float = 0.02


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def param_specs(cfg: ModelConfig):
    """The shape tree, with the JAX init scales: normal·0.02, out-projections
    normal·0.02/sqrt(2L), ones for the norms."""
    check_supported(cfg)
    D, H, Hkv, dh, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    pdt = cfg.pdtype
    out_scale = 0.02 / max(1.0, (2 * max(cfg.n_layers, 1)) ** 0.5)
    norm = ParamSpec((D,), F32, "ones")

    def layer():
        return {
            "norm1": norm,
            "attn": {"wq": ParamSpec((D, H, dh), pdt),
                     "wk": ParamSpec((D, Hkv, dh), pdt),
                     "wv": ParamSpec((D, Hkv, dh), pdt),
                     "wo": ParamSpec((H, dh, D), pdt, scale=out_scale)},
            "norm2": norm,
            "mlp": {"w_up": ParamSpec((D, Fd), pdt),
                    "w_down": ParamSpec((Fd, D), pdt, scale=out_scale),
                    "w_gate": ParamSpec((D, Fd), pdt)},
        }

    return {
        "embed": {"table": ParamSpec((cfg.vocab, D), pdt)},
        "layers": [layer() for _ in range(cfg.n_layers)],
        "final_norm": norm,
        "unembed": ({} if cfg.tie_embeddings
                    else {"w": ParamSpec((D, cfg.vocab), pdt)}),
    }


def n_params(cfg: ModelConfig) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(param_specs(cfg)))


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Seeded random weights made on ``device`` (the card unless
    ``device="cpu"``). Same scales as the JAX init, not the same numbers."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        x = torch.randn(spec.shape, generator=gen, dtype=F32, device=device)
        return x.mul_(spec.scale).to(spec.dtype)

    return tree_map(leaf, param_specs(cfg))


def _from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                    # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is opaque to torch.from_numpy: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """Carry a JAX parameter tree (``materialize(model_defs(cfg), key)``,
    leaves as numpy or array-likes) across. Its ``blocks`` — one entry per
    scan segment, leaves with a leading repeat axis — are unstacked into
    ``layers`` in layer order."""
    device = resolve_device(device)
    specs = param_specs(cfg)
    layers = []
    for seg, seg_tree in zip(layer_schedule(cfg), tree["blocks"]):
        for r in range(seg.repeat):
            for j in range(len(seg.pattern)):
                layers.append(tree_map(lambda a, r=r: np.asarray(a)[r],
                                       seg_tree[f"s{j}"]))
    flat = {"embed": tree["embed"], "layers": layers,
            "final_norm": tree["final_norm"], "unembed": tree["unembed"]}
    out = tree_map(lambda a: _from_numpy(a, device), flat)
    got = tree_map(lambda t: (tuple(t.shape), t.dtype), out)
    want = tree_map(lambda s: (s.shape, s.dtype), specs)
    if got != want:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"got {got}, want {want}")
    return out
