"""Paged cache layout (``repro/serve/kv_cache.py``: full-attention pools
beside dense per-slot Mamba-2 state).

Every full-attention GQA layer owns two pools ``(num_pages, page_size, Hkv,
dh)``, every MLA layer one latent pool ``{"ckv": (num_pages, page_size,
kv_lora + rope)}`` (the row is both key and value), addressed through the
engine's per-slot page table. Page 0 is the allocator's reserved trash
page. A Mamba-2 layer keeps its O(1) state densely per slot, beside the
pool: ``conv_x``/``conv_B``/``conv_C`` ``(max_slots, d_conv - 1, ·)`` in
the parameter dtype and ``ssm`` ``(max_slots, H, P, N)`` in f32. A model
may have no pooled layer at all.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba import mamba2_state_defs
from repro_torch.models.transformer import BlockCfg, block_cfgs, check_supported
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


def _is_pooled(bc: BlockCfg) -> bool:
    """Full-attention mixers go through the page pool; Mamba-2 layers keep
    their O(1) per-slot state."""
    return bc.mixer == "attn" and not bc.window


def paged_cache_defs(cfg: ModelConfig, *, num_pages: int, page_size: int,
                     max_slots: int):
    """Cache defs per layer: a page pool, or the per-slot Mamba-2 state of
    ``max_slots`` slots."""
    check_supported(cfg)
    return {"layers": [page_pool_defs(cfg, num_pages, page_size)
                       if _is_pooled(bc) else
                       mamba2_state_defs(cfg, max_slots)
                       for bc in block_cfgs(cfg)]}


def cache_kinds(cfg: ModelConfig) -> list[str]:
    """Per-layer layout label, "paged" or "dense": what the engine's admit
    does with the layer's prefill rows (scatter into pool pages, or write
    per slot)."""
    return ["paged" if _is_pooled(bc) else "dense" for bc in block_cfgs(cfg)]


def make_cache(defs, device) -> dict:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), defs)
