"""Plain PyTorch versions of the flash-attention kernels (O(T²) memory).

Same contract as ``repro/kernels/flash_attention/ref.py::flash_attention_ref``
plus GQA: ``k``/``v`` may carry ``Hk`` heads with ``H % Hk == 0``; query
head ``h`` reads kv head ``h // (H // Hk)``. The training pair
(``flash_attention_fwd_lse_ref``, ``flash_attention_bwd_ref``) computes
what ``flash_attention_bwd.py`` computes, with the lse of
``repro/models/attention.py::_attend_fwd`` (0 + log 1e-30 for a row with no
live key).
"""
from __future__ import annotations

import torch

NEG = -1e30
F32 = torch.float32


def _expand(x, H):
    return x if x.shape[1] == H else x.repeat_interleave(H // x.shape[1], 1)


def _scores(q, k, *, scale, causal, window, softcap):
    """f32 scores (B,H,Tq,Tk) with the mask applied (NEG where dead), the
    tanh of the softcap (or None) and the live mask (Tq, Tk)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32) * scale,
                     _expand(k, q.shape[1]).to(F32))
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    Tq, Tk = q.shape[2], k.shape[2]
    iq = torch.arange(Tq, device=q.device)[:, None]
    jk = torch.arange(Tk, device=q.device)[None, :]
    ok = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= jk <= iq
    if window:
        ok &= jk > iq - window
    s = torch.where(ok, s, torch.tensor(NEG, dtype=F32, device=q.device))
    return s, t, ok


def flash_attention_ref(q, k, v, *, scale, causal=True, window=0,
                        softcap=0.0):
    """q (B,H,Tq,dh), k (B,Hk,Tk,dh), v (B,Hk,Tk,dv) → (B,H,Tq,dv)."""
    s, _, _ = _scores(q, k, scale=scale, causal=causal, window=window,
                      softcap=softcap)
    p = torch.softmax(s, dim=-1)
    v = _expand(v, q.shape[1])
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32)).to(q.dtype)


def flash_attention_fwd_lse_ref(q, k, v, *, scale, causal=True, window=0,
                                softcap=0.0):
    """→ (o (B,H,Tq,dv) in q's dtype, lse (B,H,Tq) f32)."""
    s, _, ok = _scores(q, k, scale=scale, causal=causal, window=window,
                       softcap=softcap)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG / 2, torch.zeros_like(m), m)
    p = torch.where(ok, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l,
                     _expand(v, q.shape[1]).to(F32)).to(q.dtype)
    return o, (m_safe + torch.log(l))[..., 0]


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, scale, causal=True,
                            window=0, softcap=0.0):
    """The recompute formula of ``flash_attention_bwd.py::_p_and_ds`` in
    f32, without autograd: q/k (B,H|Hk,T,dh), v/o/do (B,H|Hk,T,dv), lse
    (B,H,Tq) → (dq, dk, dv) in the dtypes of q, k, v; dk and dv are summed
    over each kv head's group of query heads."""
    B, H, Tq, _ = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    s, t, ok = _scores(q, k, scale=scale, causal=causal, window=window,
                       softcap=softcap)
    p = torch.where(ok, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    do32 = do.to(F32)
    delta = (do32 * o.to(F32)).sum(-1, keepdim=True)
    kf, vf = _expand(k, H).to(F32), _expand(v, H).to(F32)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do32, vf) - delta)
    if softcap:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(F32)) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    if Hk != H:
        dk = dk.view(B, Hk, H // Hk, Tk, -1).sum(2)
        dv = dv.view(B, Hk, H // Hk, Tk, -1).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
