"""Error-feedback gradient compression (``repro/train/compression.py``).

Two codecs for a gradient exchange, both with error-feedback residuals so
the compression error is re-injected next step (Karimireddy et al. '19):

* ``int8`` — per-tensor absmax scaling to int8 (4x over f32 on the wire);
* ``topk`` — keep the top-k fraction of entries by magnitude (sparse).

``compress_decompress`` simulates the wire round trip inside the train step
(numerics); ``wire_bytes`` counts the bytes one exchange would send.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.params import tree_leaves, tree_map

F32 = torch.float32


@dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"          # none | int8 | topk
    topk_frac: float = 0.01


def init_residuals(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                          device=g.device), grads)


def _int8_roundtrip(x):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.to(F32) * scale


def _topk_roundtrip(x, frac):
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(x.abs() >= thresh, x, torch.zeros_like(x))


@torch.no_grad()
def compress_decompress(grads, residuals, ccfg: CompressionConfig):
    """→ (decompressed grads as seen after the exchange, new residuals)."""
    if ccfg.kind == "none":
        return grads, residuals

    def one(g, r):
        x = g.to(F32) + r
        if ccfg.kind == "int8":
            y = _int8_roundtrip(x)
        elif ccfg.kind == "topk":
            y = _topk_roundtrip(x, ccfg.topk_frac)
        else:
            raise ValueError(ccfg.kind)
        return y.to(g.dtype), x - y

    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     tree_leaves(residuals))]
    it_g, it_r = iter(o[0] for o in out), iter(o[1] for o in out)
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_r), grads))


def wire_bytes(grads, ccfg: CompressionConfig) -> int:
    """Bytes on the wire for one exchange (benchmark accounting)."""
    leaves = tree_leaves(grads)
    n = sum(x.numel() for x in leaves)
    if ccfg.kind == "int8":
        return n + 4 * len(leaves)
    if ccfg.kind == "topk":
        return int(n * ccfg.topk_frac) * (4 + 4)      # value + index
    return n * 4
