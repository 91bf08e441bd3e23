"""Plain PyTorch version of the Mamba-1 selective scan.

What ``repro/models/mamba.py::mamba1_mixer``'s ``chunk_body`` computes
across all chunks, with its chunking: a loop over chunks carries the
state h, and the steps within a chunk are combined by a log-step
(Hillis-Steele) scan of the pairs (decay, input) under the associative
operator (l, r) ↦ (l₀·r₀, r₀·l₁ + r₁), as JAX's ``associative_scan``.
The tail is padded to a whole chunk as JAX pads it: zero x and dt give
decay exp(0) = 1 and input 0, exact no-op steps.

The backward (``selective_scan_bwd_ref``, the CPU path of
``ops.SelectiveScan``) is the kernels' reverse recurrence over the states
saved every ``TILE`` steps: each tile, last to first, recomputes its
states and decays from the saved state and walks its steps in reverse
with those decays, as the backward kernel does. Autograd through
``selective_scan_ref`` is the independent oracle of both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
TILE = 16          # steps between the states the forward saves (csrc TS)


def _work_dtype(x) -> torch.dtype:
    """f32, or f64 for f64 operands (the tests' yardstick)."""
    return torch.float64 if x.dtype == torch.float64 else F32


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


def selective_scan_ref(x, dt, A, Bm, Cm, h0, chunk: int, tile: int = 0):
    """x, dt (B,S,C), A (C,N) (negative), Bm, Cm (B,S,N), h0 (B,C,N), all
    f32 (f64 stays f64) → y (B,S,C), h_last (B,C,N): h_t = exp(dt_t·A)·h_{t-1} +
    (dt_t·x_t)·B_t and y_t = Σ_n h_t[:, n]·C_t[n]. With ``tile`` > 0 also
    hs (B, ceil(S/tile), C, N), the state entering each tile of ``tile``
    steps (h0 first)."""
    wd = _work_dtype(x)
    x, dt, A, Bm, Cm, h0 = (t.to(wd) for t in (x, dt, A, Bm, Cm, h0))
    B, S, C = x.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x, dt = F.pad(x, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    h, ys, hs = h0, [], [h0]
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
        if tile:        # the states after steps tile·k - 1 of this chunk
            ends = range(-(-(c0 + 1) // tile) * tile, min(c0 + Q + 1, S),
                         tile)
            hs += [h_all[:, t - 1 - c0] for t in ends]
    y = torch.cat(ys, dim=1)[:, :S]
    if tile:
        return y, h, torch.stack(hs, dim=1)
    return y, h


def selective_scan_bwd_ref(x, dt, A, Bm, Cm, hs, dy, dh_last,
                           tile: int = TILE):
    """The scan's gradients from the states ``hs`` saved every ``tile``
    steps (``selective_scan_ref(..., tile=tile)``) and the cotangents dy
    (B,S,C), dh_last (B,C,N) → dx, ddt (B,S,C), dA (C,N), dB, dC (B,S,N),
    dh0 (B,C,N), all f32 (f64 for f64 operands). With g = dL/dh_t, from g = dh_last backwards:
    g_t = C_t·dy_t + a_{t+1}·g_{t+1}, a_t = exp(dt_t·A); dx_t = dt_t·Σ_n
    B_t·g_t, ddt_t = x_t·Σ_n B_t·g_t + Σ_n A·a_t·h_{t-1}·g_t, dA = Σ_{b,t}
    dt_t·a_t·h_{t-1}·g_t, dB_t = Σ_c dt_t·x_t·g_t, dC_t = Σ_c h_t·dy_t,
    dh0 = a_0·g_0. Each tile recomputes its states from its saved one,
    never by dividing by a_t (which underflows)."""
    wd = _work_dtype(x)
    x, dt, A, Bm, Cm, hs, dy, g = (t.to(wd) for t in
                                   (x, dt, A, Bm, Cm, hs, dy, dh_last))
    B, S, C = x.shape
    K = hs.shape[1]
    assert K == -(-S // tile), (K, S, tile)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    for k in reversed(range(K)):
        t0, t1 = k * tile, min(S, (k + 1) * tile)
        states, decays = [hs[:, k]], []
        for t in range(t0, t1):
            a = torch.exp(dt[:, t, :, None] * A)                 # (B,C,N)
            u = (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
            decays.append(a)
            states.append(a * states[-1] + u)
        for t in reversed(range(t0, t1)):
            a, h_prev, h = decays[t - t0], states[t - t0], states[t - t0 + 1]
            g = g + Cm[:, t, None, :] * dy[:, t, :, None]
            dC[:, t] = torch.einsum("bcn,bc->bn", h, dy[:, t])
            dB[:, t] = torch.einsum("bcn,bc->bn", g, dt[:, t] * x[:, t])
            sbg = torch.einsum("bcn,bn->bc", g, Bm[:, t])
            w = a * h_prev * g
            dA = dA + torch.einsum("bcn,bc->cn", w, dt[:, t])
            dx[:, t] = dt[:, t] * sbg
            ddt[:, t] = x[:, t] * sbg + (w * A).sum(-1)
            g = a * g
    return dx, ddt, dA, dB, dC, g
