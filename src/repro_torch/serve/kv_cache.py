"""Paged KV-cache layout (``repro/serve/kv_cache.py``, full-attention pools).

Every full-attention GQA layer owns two pools ``(num_pages, page_size, Hkv,
dh)``, every MLA layer one latent pool ``{"ckv": (num_pages, page_size,
kv_lora + rope)}`` (the row is both key and value), addressed through the
engine's per-slot page table. Page 0 is the allocator's reserved trash
page.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import check_supported
from repro_torch.params import ParamSpec, tree_map


def page_pool_defs(cfg: ModelConfig, num_pages: int, page_size: int):
    """Pool leaves for one full-attention layer: (num_pages, page_size, …)."""
    if cfg.mla:
        R = cfg.mla.kv_lora + cfg.mla.rope_dim
        return {"ckv": ParamSpec((num_pages, page_size, R), cfg.pdtype,
                                 "zeros")}
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": ParamSpec(shape, cfg.pdtype, "zeros"),
            "v": ParamSpec(shape, cfg.pdtype, "zeros")}


def paged_cache_defs(cfg: ModelConfig, *, num_pages: int, page_size: int):
    check_supported(cfg)
    return {"layers": [page_pool_defs(cfg, num_pages, page_size)
                       for _ in range(cfg.n_layers)]}


def make_cache(defs, device) -> dict:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), defs)
