"""Plain PyTorch versions of the paged flash-decode kernels (GQA and
absorbed MLA).

Same contract as ``repro/kernels/paged_attention/ref.py``: they gather the
slot's pages into a position-ordered view and take a single-max softmax,
returning the unnormalized ``(o, m, l)`` f32 partials over the live prefix.
"""
from __future__ import annotations

import torch

NEG = -1e30
F32 = torch.float32


def _gathered(pool, page_table, base, page_size):
    """pool (N, ps, …) + pt (B, T) → (view (B, T·ps, …), gpos (T·ps,))."""
    ps = pool.shape[1]
    B, T = page_table.shape
    g = pool[page_table.long()]                        # (B, T, ps, …)
    g = g.reshape((B, T * ps) + tuple(pool.shape[2:]))
    gpos = (torch.arange(T, device=pool.device)[:, None] * page_size + base
            + torch.arange(ps, device=pool.device)[None]).reshape(-1)
    return g, gpos


def paged_flash_decode_gqa_ref(q, pool_k, pool_v, page_table, pos, base, *,
                               page_size: int, scale: float,
                               softcap: float = 0.0):
    """q (B,Hkv,G,dh), pools (N,ps,Hkv,dh) → (o (B,Hkv·G,dh), m (B,Hkv·G),
    l (B,Hkv·G)) f32 partials."""
    B, hkv, grp, dh = q.shape
    gk, gpos = _gathered(pool_k, page_table, base, page_size)
    gv, _ = _gathered(pool_v, page_table, base, page_size)
    valid = gpos[None] <= pos[:, None]                 # (B, S)
    s = torch.einsum("bhgd,bshd->bhgs", q.to(F32) * scale, gk.to(F32))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    neg = torch.tensor(NEG, dtype=F32, device=q.device)
    s = torch.where(valid[:, None, None], s, neg)
    m = s.amax(-1)                                     # (B, Hkv, G)
    m_safe = torch.where(m <= NEG / 2, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(valid[:, None, None], p, torch.zeros_like(p))
    o = torch.einsum("bhgs,bshd->bhgd", p, gv.to(F32))
    l = p.sum(-1)
    H = hkv * grp
    return o.reshape(B, H, dh), m.reshape(B, H), l.reshape(B, H)


def paged_flash_decode_mla_ref(q, pool, page_table, pos, base, *,
                               page_size: int, kv_lora: int, scale: float):
    """q (B,H,R); pool (N, ps, R): the row is the key (all R dims) and its
    first ``kv_lora`` dims the value → (o (B,H,kv_lora), m (B,H), l (B,H))
    f32 partials."""
    g, gpos = _gathered(pool, page_table, base, page_size)  # (B, S, R)
    valid = gpos[None] <= pos[:, None]                 # (B, S)
    s = torch.einsum("bhr,bsr->bhs", q.to(F32) * scale, g.to(F32))
    neg = torch.tensor(NEG, dtype=F32, device=q.device)
    s = torch.where(valid[:, None], s, neg)
    m = s.amax(-1)                                     # (B, H)
    m_safe = torch.where(m <= NEG / 2, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(valid[:, None], p, torch.zeros_like(p))
    o = torch.einsum("bhs,bsr->bhr", p, g[..., :kv_lora].to(F32))
    return o, m, p.sum(-1)
