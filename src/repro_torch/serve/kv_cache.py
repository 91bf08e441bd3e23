"""Decode-cache layouts (``repro/serve/kv_cache.py``): dense per-slot rows,
sliding-window rings, page pools and per-slot Mamba state.

Dense engine (``cache_defs``): every attention layer keeps per-slot rows
``(max_slots, Sc, Hkv, dh)`` K and V for GQA, ``{"ckv": (max_slots, Sc,
kv_lora + rope)}`` for MLA (the row is both key and value), with ``Sc =
max_len`` for full attention and a ring of ``Sc = min(window, max_len)``
slots for a sliding-window layer (position p lands in slot p mod Sc), as
``attn_cache_len`` sizes them.

Paged engine (``paged_cache_defs``): every full-attention layer owns pools
``(num_pages, page_size, Hkv, dh)`` (MLA: one latent pool), addressed
through the engine's per-slot page table; page 0 is the allocator's
reserved trash page. On a model axis of m ranks each rank's pools hold
its ``page_size / m`` in-page offsets of every page. Ring layers keep their dense per-slot rings beside
the pools: they are already bounded per slot.

Either way a Mamba layer keeps its O(1) state densely per slot: Mamba-2
``conv_x``/``conv_B``/``conv_C`` ``(max_slots, d_conv - 1, ·)`` in the
parameter dtype and ``ssm`` ``(max_slots, H, P, N)`` in f32; Mamba-1
``conv_x`` ``(max_slots, d_conv - 1, C)`` and ``ssm`` ``(max_slots, C,
N)`` in f32. In a hybrid (jamba) the attention layers keep their K/V in
the pool (or dense rows) beside their Mamba neighbours' state.

Encoder-decoder (``encdec_cache_defs``, whisper): each decoder layer keeps
dense self rows ``k``/``v`` (batch, max_decoder_len, Hkv, dh) and the
cross K/V ``xk``/``xv`` (batch, enc_len, Hkv, dh) over the encoder frames,
written once by ``whisper_prefill``.

Memory (JAX's helpers on one device): ``cache_bytes`` sizes the dense
layout of any registered model (whisper's self and cross rows included),
``page_bytes`` one page across every pooled layer; an engine's
``reserved_cache_bytes`` is the sum of its leaves.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba import mamba_state_defs
from repro_torch.models.transformer import BlockCfg, block_cfgs, check_supported
from repro_torch.params import ParamSpec, tree_leaves, tree_map


def attn_cache_len(window: int, seq_len: int) -> int:
    """Rows of an attention layer's per-slot cache: a ring of
    ``min(window, seq_len)`` slots for a windowed layer, ``seq_len``
    otherwise (one device: no padding to a model axis)."""
    return min(window, seq_len) if window else seq_len


def block_cache_defs(cfg: ModelConfig, bc: BlockCfg, batch: int,
                     seq_len: int):
    """Dense cache defs of one layer for ``batch`` slots of ``seq_len``
    tokens: rows (or a ring) for attention, the state for a Mamba layer."""
    if bc.mixer == "mamba":
        return mamba_state_defs(cfg, batch)
    Sc = attn_cache_len(bc.window, seq_len)
    if cfg.mla:
        R = cfg.mla.kv_lora + cfg.mla.rope_dim
        return {"ckv": ParamSpec((batch, Sc, R), cfg.pdtype, "zeros")}
    shape = (batch, Sc, cfg.n_kv_heads, cfg.head_dim)
    return {"k": ParamSpec(shape, cfg.pdtype, "zeros"),
            "v": ParamSpec(shape, cfg.pdtype, "zeros")}


def cache_defs(cfg: ModelConfig, *, max_slots: int, max_len: int):
    """The dense engine's cache defs: :func:`block_cache_defs` per layer."""
    check_supported(cfg)
    return {"layers": [block_cache_defs(cfg, bc, max_slots, max_len)
                       for bc in block_cfgs(cfg)]}


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
    """Full-attention mixers go through the page pool; ring (sliding-window)
    and Mamba layers keep their dense / O(1) per-slot layouts."""
    return bc.mixer == "attn" and not bc.window


def paged_cache_defs(cfg: ModelConfig, *, num_pages: int, page_size: int,
                     max_slots: int, max_len: int, msize: int = 1):
    """Cache defs per layer: a page pool for full attention, else the dense
    per-slot ring or Mamba state of ``max_slots`` slots of ``max_len``
    tokens. On a model axis of ``msize`` ranks a rank's pool holds its
    ``page_size / msize`` in-page offsets of every page, (N, ps/m, Hkv,
    dh), as JAX's ``kv_seq``-sharded pools; ``page_size`` must be a
    multiple of ``msize``."""
    check_supported(cfg)
    if page_size <= 0 or page_size % msize:
        raise ValueError(f"page_size {page_size} must be a positive "
                         f"multiple of the model-axis size {msize}")
    return {"layers": [page_pool_defs(cfg, num_pages, page_size // msize)
                       if _is_pooled(bc) else
                       block_cache_defs(cfg, bc, max_slots, max_len)
                       for bc in block_cfgs(cfg)]}


def cache_kinds(cfg: ModelConfig, *, paged: bool = True) -> list[str]:
    """Per-layer layout label, "paged" or "dense": what the engine's admit
    does with the layer's prefill rows (scatter into pool pages, or write
    per slot)."""
    return ["paged" if paged and _is_pooled(bc) else "dense"
            for bc in block_cfgs(cfg)]


def encdec_cache_defs(cfg: ModelConfig, batch: int, enc_len: int):
    """Whisper's cache defs, a list over the decoder layers: self rows of
    ``max_decoder_len`` and cross K/V over ``enc_len`` encoder frames, in
    the parameter dtype (one device: no padding to a model axis)."""
    def rows(n):
        return ParamSpec((batch, n, cfg.n_kv_heads, cfg.head_dim),
                         cfg.pdtype, "zeros")
    slot = {"k": rows(cfg.max_decoder_len), "v": rows(cfg.max_decoder_len),
            "xk": rows(enc_len), "xv": rows(enc_len)}
    return {"dec_layers": [slot] * cfg.n_layers}


def defs_bytes(defs) -> int:
    """Bytes of the tensors a def tree describes."""
    return sum(math.prod(d.shape) * d.dtype.itemsize
               for d in tree_leaves(defs, is_leaf=lambda x: isinstance(
                   x, ParamSpec)))


def cache_bytes(cfg: ModelConfig, batch: int, seq_len: int) -> int:
    """Bytes of the dense decode cache of ``batch`` slots of ``seq_len``
    tokens (JAX ``cache_bytes`` at one model shard): per-slot rows, rings
    and Mamba state for a decoder, whisper's self rows and cross K/V over
    ``seq_len`` encoder frames for an encoder-decoder."""
    if cfg.enc_dec:
        return defs_bytes(encdec_cache_defs(cfg, batch, seq_len))
    return defs_bytes([block_cache_defs(cfg, bc, batch, seq_len)
                       for bc in block_cfgs(cfg)])


def page_bytes(cfg: ModelConfig, page_size: int) -> int:
    """Bytes one page of ``page_size`` rows occupies across every pooled
    (full-attention) layer: the allocator's granularity (JAX
    ``page_bytes``)."""
    return sum(defs_bytes(page_pool_defs(cfg, 1, page_size))
               for bc in block_cfgs(cfg) if _is_pooled(bc))


def make_cache(defs, device) -> dict:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), defs)
