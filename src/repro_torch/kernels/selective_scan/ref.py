"""Plain PyTorch version of the Mamba-1 selective scan.

What ``repro/models/mamba.py::mamba1_mixer``'s ``chunk_body`` computes
across all chunks, with its chunking: a loop over chunks carries the
state h, and the steps within a chunk are combined by a log-step
(Hillis-Steele) scan of the pairs (decay, input) under the associative
operator (l, r) ↦ (l₀·r₀, r₀·l₁ + r₁), as JAX's ``associative_scan``.
The tail is padded to a whole chunk as JAX pads it: zero x and dt give
decay exp(0) = 1 and input 0, exact no-op steps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def _scan(a, u):
    """Inclusive scan over dim 1 of h_t = a_t · h_{t-1} + u_t from h = 0,
    in ceil(log2 Q) doubling steps → h (B,Q,C,N)."""
    Q = a.shape[1]
    d = 1
    while d < Q:
        a_prev, u_prev = a[:, :-d], u[:, :-d]
        u = torch.cat([u[:, :d], a[:, d:] * u_prev + u[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return u


def selective_scan_ref(x, dt, A, Bm, Cm, h0, chunk: int):
    """x, dt (B,S,C), A (C,N) (negative), Bm, Cm (B,S,N), h0 (B,C,N), all
    f32 → y (B,S,C), h_last (B,C,N): h_t = exp(dt_t·A)·h_{t-1} +
    (dt_t·x_t)·B_t and y_t = Σ_n h_t[:, n]·C_t[n]."""
    x, dt, A, Bm, Cm, h0 = (t.to(F32) for t in (x, dt, A, Bm, Cm, h0))
    B, S, C = x.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x, dt = F.pad(x, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    h, ys = h0, []
    for c0 in range(0, S + pad, Q):
        dq, xq = dt[:, c0:c0 + Q], x[:, c0:c0 + Q]
        bq, cq = Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]
        da = torch.exp(dq[..., None] * A)                    # (B,Q,C,N)
        u = (dq * xq)[..., None] * bq[:, :, None, :]         # (B,Q,C,N)
        # fold the incoming state into the first step
        u = torch.cat([u[:, :1] + da[:, :1] * h[:, None], u[:, 1:]], dim=1)
        h_all = _scan(da, u)
        ys.append(torch.einsum("bqcn,bqn->bqc", h_all, cq))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1)[:, :S], h
