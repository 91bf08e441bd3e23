"""GQA and MLA projections and prefill attention
(``repro/models/attention.py``).

``attend`` keeps the contract of the JAX ``attend_chunked`` (causal,
sliding window, softcap; q (B,Tq,Hkv,G,dh), k (B,Tk,Hkv,dh), v
(B,Tk,Hkv,dv)) and runs the hand-written flash kernel
(``kernels/flash_attention``) on the card. The kernel takes strided views,
so neither the head transpose nor the GQA broadcast is materialized.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, rmsnorm, rope_tables


def gqa_project(cfg: ModelConfig, p, x: torch.Tensor, positions):
    """x (B,S,D) → q (B,S,Hkv,G,dh), k,v (B,S,Hkv,dh). Applies rope."""
    B, S, D = x.shape
    q = (x @ p["wq"].reshape(D, -1)).view(B, S, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"].reshape(D, -1)).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"].reshape(D, -1)).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    G = cfg.n_heads // cfg.n_kv_heads
    return q.reshape(B, S, cfg.n_kv_heads, G, cfg.head_dim), k, v


def attend(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
           softcap: float = 0.0):
    """q (B,Tq,Hkv,G,dh), k (B,Tk,Hkv,dh), v (B,Tk,Hkv,dv) → (B,Tq,Hkv,G,dv)."""
    B, Tq, Hkv, G, dh = q.shape
    qh = q.reshape(B, Tq, Hkv * G, dh).permute(0, 2, 1, 3)   # views
    out = flash_ops.attend(qh, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                           scale=scale, causal=causal, window=window,
                           softcap=softcap)
    return out.permute(0, 2, 1, 3).reshape(B, Tq, Hkv, G, v.shape[-1])


# --------------------------------------------------------------- MLA block
def mla_latents(cfg: ModelConfig, p, x: torch.Tensor, positions):
    """Compressed latents: c_kv (B,S,kv_lora), k_rope (B,S,1,rope) — this
    pair is the MLA cache row."""
    m = cfg.mla
    c_kv = rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    k_r = (x @ p["wkr"])[:, :, None, :]
    cos, sin = rope_tables(positions, m.rope_dim, cfg.rope_theta)
    return c_kv, apply_rope(k_r, cos, sin)


def mla_queries(cfg: ModelConfig, p, x: torch.Tensor, positions):
    """x (B,S,D) → qn (B,S,H,nope), qr (B,S,H,rope) with rope applied."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"].reshape(m.q_lora, -1)).view(
        B, S, cfg.n_heads, m.nope_dim + m.rope_dim)
    qn, qr = q[..., :m.nope_dim], q[..., m.nope_dim:]
    cos, sin = rope_tables(positions, m.rope_dim, cfg.rope_theta)
    return qn, apply_rope(qr, cos, sin)
