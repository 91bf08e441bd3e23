"""Plain PyTorch version of the flash-attention kernel (O(T²) memory).

Same contract as ``repro/kernels/flash_attention/ref.py::flash_attention_ref``
plus GQA: ``k``/``v`` may carry ``Hk`` heads with ``H % Hk == 0``; query
head ``h`` reads kv head ``h // (H // Hk)``.
"""
from __future__ import annotations

import torch

NEG = -1e30
F32 = torch.float32


def flash_attention_ref(q, k, v, *, scale, causal=True, window=0,
                        softcap=0.0):
    """q (B,H,Tq,dh), k (B,Hk,Tk,dh), v (B,Hk,Tk,dv) → (B,H,Tq,dv)."""
    H, Hk = q.shape[1], k.shape[1]
    if Hk != H:
        k = k.repeat_interleave(H // Hk, dim=1)
        v = v.repeat_interleave(H // Hk, dim=1)
    Tq, Tk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32) * scale, k.to(F32))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    iq = torch.arange(Tq, device=q.device)[:, None]
    jk = torch.arange(Tk, device=q.device)[None, :]
    ok = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= jk <= iq
    if window:
        ok &= jk > iq - window
    s = torch.where(ok, s, torch.tensor(NEG, dtype=F32, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32)).to(q.dtype)
