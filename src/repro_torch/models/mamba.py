"""Mamba-2 mixer (the SSD half of ``repro/models/mamba.py``).

The sequence is split into chunks; within a chunk the SSD quadratic form is
the hand-written intra-chunk kernel (``kernels/ssd``), and a Python loop over
chunks carries the SSM state across them, as JAX's ``lax.scan`` does (linear
in T, bounded memory); the mixer trains through it (``mamba_mixer``).
Single-token decode (``mamba2_step``) carries
(conv_state, ssm_state): an O(1)-state decoder. Mamba-1 (selective scan)
is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import rmsnorm

F32 = torch.float32


# ------------------------------------------------------------------ common
def causal_conv(x, w, b):
    """Depthwise causal conv. x (B,S,C), w (K,C), b (C,)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return y + b


def conv_step(conv_state, xt, w, b):
    """conv_state (B,K-1,C), xt (B,C) → (new_state, yt (B,C))."""
    full = torch.cat([conv_state, xt[:, None, :]], dim=1)        # (B,K,C)
    yt = torch.einsum("bkc,kc->bc", full, w) + b
    return full[:, 1:], yt


# ------------------------------------------------------------------ mamba2
def _mamba2_inputs(cfg, p, x):
    """Shared projections for prefill & decode. x (B,S,D)."""
    z = x @ p["wz"]
    xs = x @ p["wx"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt = (x @ p["wdt"]).to(F32)
    return z, xs, Bm, Cm, dt


def ssd_scan(xh, dt_a, Bm, Cm, chunk: int):
    """Chunked SSD (state-space duality) core.

    xh (B,S,H,P) [dt already folded in], dt_a (B,S,H) [= dt·A, negative],
    Bm/Cm (B,S,N). Returns y (B,S,H,P) and final state (B,H,P,N), f32.
    The intra-chunk part is ``kernels/ssd/ops.py::intra_chunk`` (under
    autograd :class:`~repro_torch.kernels.ssd.ops.SsdIntraChunk`); the
    chunk loop builds new tensors only, so the scan trains.
    """
    B, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S0 = S
    pad = (-S) % Q
    if pad:  # zero x + zero dt·A are exact no-ops for the recurrence
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_a = F.pad(dt_a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    xc = xh.reshape(B * nc, Q, H, Pd).to(F32)
    ac = dt_a.reshape(B * nc, Q, H).to(F32)
    Bc = Bm.reshape(B * nc, Q, N).to(F32)
    Cc = Cm.reshape(B * nc, Q, N).to(F32)

    cs = torch.cumsum(ac, dim=1)                       # (B·nc,Q,H) inclusive
    # intra-chunk (quadratic in Q) on the kernel: heads as the second grid
    # dim, B and C shared by all heads (stride 0)
    y_diag, states = ssd_ops.intra_chunk_autograd(
        xc.permute(0, 2, 1, 3), cs.permute(0, 2, 1),
        Bc[:, None].expand(-1, H, -1, -1), Cc[:, None].expand(-1, H, -1, -1))
    y_diag = y_diag.permute(0, 2, 1, 3).reshape(B, nc, Q, H, Pd)
    states = states.transpose(2, 3).reshape(B, nc, H, Pd, N)
    chunk_decay = torch.exp(cs[:, -1, :]).reshape(B, nc, H)

    h = xh.new_zeros((B, H, Pd, N), dtype=F32)
    h_in = []
    for c in range(nc):                    # emit the state *entering* chunk c
        h_in.append(h)
        h = states[:, c] + chunk_decay[:, c, :, None, None] * h
    h_in = torch.stack(h_in, dim=1)                    # (B,nc,H,P,N)

    y_off = torch.einsum("bctn,bchpn,bcth->bcthp", Cc.reshape(B, nc, Q, N),
                         h_in, torch.exp(cs).reshape(B, nc, Q, H))
    y = (y_diag + y_off).reshape(B, S, H, Pd)
    return y[:, :S0], h


def mamba2_mixer(cfg: ModelConfig, p, x, return_state: bool = False):
    """x (B,S,D) → (B,S,D) (full prefill); with ``return_state`` also the
    decode state {conv_x, conv_B, conv_C (pre-conv tails, pdtype), ssm
    (B,H,P,N) f32}."""
    s = cfg.ssm
    B, S, D = x.shape
    C = cfg.d_inner
    H, Pd = C // s.head_dim, s.head_dim

    z, xs, Bm, Cm, dt = _mamba2_inputs(cfg, p, x)
    xs_pre, Bm_pre, Cm_pre = xs, Bm, Cm               # pre-conv (decode state)
    xs = F.silu(causal_conv(xs, p["conv_x"], p["conv_x_b"]))
    Bm = F.silu(causal_conv(Bm, p["conv_B"], p["conv_B_b"]))
    Cm = F.silu(causal_conv(Cm, p["conv_C"], p["conv_C_b"]))

    dt = F.softplus(dt + p["dt_bias"])                 # (B,S,H) f32
    a = -torch.exp(p["A_log"].to(F32))                 # (H,)
    xh = xs.reshape(B, S, H, Pd).to(F32) * dt[..., None]
    y, h_last = ssd_scan(xh, dt * a, Bm, Cm, s.chunk)
    y = y + p["D_skip"][None, None, :, None] * \
        xs.reshape(B, S, H, Pd).to(F32)
    y = y.reshape(B, S, C).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gn"], cfg.norm_eps)
    out = y @ p["wo"]
    if not return_state:
        return out
    K = s.d_conv - 1
    state = {"conv_x": xs_pre[:, S - K:, :].to(cfg.pdtype),
             "conv_B": Bm_pre[:, S - K:, :].to(cfg.pdtype),
             "conv_C": Cm_pre[:, S - K:, :].to(cfg.pdtype),
             "ssm": h_last}
    return out, state


def mamba_mixer(cfg: ModelConfig, p, x):
    """The training mixer (``repro/models/mamba.py::mamba_mixer``): Mamba-2,
    x (B,S,D) → (B,S,D); Mamba-1 is not ported."""
    if cfg.ssm.version != 2:
        raise NotImplementedError(f"{cfg.name}: Mamba-1 is not ported")
    return mamba2_mixer(cfg, p, x)


def mamba2_step(cfg: ModelConfig, p, xt, state):
    """Decode step. xt (B,D); state dict with conv_{x,B,C} + ssm (B,H,P,N)
    → (out (B,D), new state)."""
    s = cfg.ssm
    C = cfg.d_inner
    H, Pd = C // s.head_dim, s.head_dim
    z, xs, Bm, Cm, dt = _mamba2_inputs(cfg, p, xt)
    st_x, xs = conv_step(state["conv_x"], xs, p["conv_x"], p["conv_x_b"])
    st_B, Bm = conv_step(state["conv_B"], Bm, p["conv_B"], p["conv_B_b"])
    st_C, Cm = conv_step(state["conv_C"], Cm, p["conv_C"], p["conv_C_b"])
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)

    dt = F.softplus(dt + p["dt_bias"]).to(F32)                   # (B,H)
    a = -torch.exp(p["A_log"].to(F32))
    da = torch.exp(dt * a)                                       # (B,H)
    xh = xs.reshape(-1, H, Pd).to(F32) * dt[..., None]
    h = state["ssm"] * da[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", Bm.to(F32), xh)
    y = torch.einsum("bn,bhpn->bhp", Cm.to(F32), h)
    y = y + p["D_skip"][None, :, None] * xs.reshape(-1, H, Pd).to(F32)
    y = y.reshape(-1, C).to(xt.dtype)
    y = rmsnorm(y * F.silu(z), p["gn"], cfg.norm_eps)
    out = y @ p["wo"]
    new_state = {"conv_x": st_x, "conv_B": st_B, "conv_C": st_C, "ssm": h}
    return out, new_state


def mamba2_state_defs(cfg: ModelConfig, batch: int):
    """Per-slot decode state: conv tails in the parameter dtype, the SSM
    state (batch, H, P, N) in f32."""
    from repro_torch.params import ParamSpec    # params imports the stack
    s = cfg.ssm
    C = cfg.d_inner
    H, Pd = C // s.head_dim, s.head_dim
    K = s.d_conv - 1
    return {
        "conv_x": ParamSpec((batch, K, C), cfg.pdtype, "zeros"),
        "conv_B": ParamSpec((batch, K, s.d_state), cfg.pdtype, "zeros"),
        "conv_C": ParamSpec((batch, K, s.d_state), cfg.pdtype, "zeros"),
        "ssm": ParamSpec((batch, H, Pd, s.d_state), F32, "zeros"),
    }
