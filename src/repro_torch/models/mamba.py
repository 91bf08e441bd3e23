"""Mamba mixers (``repro/models/mamba.py``): Mamba-2 (SSD) and Mamba-1
(selective scan, Jamba).

Mamba-2: the sequence is split into chunks; within a chunk the SSD
quadratic form is the hand-written intra-chunk kernel (``kernels/ssd``),
and a Python loop over chunks carries the SSM state across them, as JAX's
``lax.scan`` does (linear in T, bounded memory); the mixer trains through
it (``mamba_mixer``). Mamba-1: the recurrence over the whole sequence is
the hand-written selective scan (``kernels/selective_scan``), which keeps
the (C, N) state of a row in registers and walks the steps in order; the
projections, the causal conv, the D skip and the ``silu(z)`` gate are
plain torch around it, as in JAX. Single-token decode (``mamba2_step``,
``mamba1_step``) carries (conv_state, ssm_state): an O(1)-state decoder.
``mamba_mixer``, ``mamba_step`` and ``mamba_state_defs`` dispatch by
``cfg.ssm.version``. Mamba-1 trains through the scan's autograd
function (``selective_scan.ops.SelectiveScan``: the forward saves a state
every ``ops.TS`` steps, a hand-written backward walks them in reverse);
the conv, softplus, D skip and gate stay plain torch under autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.selective_scan import ops as scan_ops
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


# ------------------------------------------------------------------ mamba1
def _mamba1_inputs(cfg, p, x):
    """The input projections. x (B,S,D) → z, xs (B,S,C)."""
    return x @ p["wz"], x @ p["wx"]


def _mamba1_ssm_params(cfg, p, xs):
    """xs: post-conv (B,S,C) → dt (B,S,C) f32, Bm/Cm (B,S,N) f32."""
    N = cfg.ssm.d_state
    dt_rank = p["w_dt"].shape[0]
    bcdt = xs @ p["w_bcdt"]
    dt_r, Bm, Cm = (bcdt[..., :dt_rank], bcdt[..., dt_rank:dt_rank + N],
                    bcdt[..., dt_rank + N:])
    dt = (dt_r @ p["w_dt"]).to(F32)
    dt = F.softplus(dt + p["dt_bias"])
    return dt, Bm.to(F32), Cm.to(F32)


def mamba1_mixer(cfg: ModelConfig, p, x, return_state: bool = False):
    """x (B,S,D) → (B,S,D) (full prefill) through the selective scan (its
    forward alone when no gradient is wanted, else ``SelectiveScan``);
    with ``return_state`` also the decode state {conv_x (pre-conv tail,
    pdtype), ssm (B,C,N) f32}."""
    s = cfg.ssm
    B, S, D = x.shape
    C, N = cfg.d_inner, s.d_state
    z, xs = _mamba1_inputs(cfg, p, x)
    xs_pre = xs
    xs = F.silu(causal_conv(xs, p["conv_x"], p["conv_x_b"]))
    dt, Bm, Cm = _mamba1_ssm_params(cfg, p, xs)
    A = -torch.exp(p["A_log"].to(F32))                      # (C,N)
    xs32 = xs.to(F32)
    h0 = torch.zeros((B, C, N), dtype=F32, device=x.device)
    y, h_last = scan_ops.selective_scan(
        xs32.contiguous(), dt.contiguous(), A.contiguous(),
        Bm.contiguous(), Cm.contiguous(), h0, s.chunk)
    y = y + p["D_skip"] * xs32
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["wo"]
    if not return_state:
        return out
    # the conv tail: the last K pre-conv inputs, zeros before the prompt
    K = s.d_conv - 1
    tail = F.pad(xs_pre[:, max(S - K, 0):, :], (0, 0, max(K - S, 0), 0))
    return out, {"conv_x": tail.to(cfg.pdtype), "ssm": h_last}


def mamba1_step(cfg: ModelConfig, p, xt, state):
    """Decode step in plain torch. xt (B,D); state: conv_x (B,K-1,C), ssm
    (B,C,N) f32 → (out (B,D), new state)."""
    z, xs = _mamba1_inputs(cfg, p, xt)
    st_x, xs = conv_step(state["conv_x"], xs, p["conv_x"], p["conv_x_b"])
    xs = F.silu(xs)
    dt, Bm, Cm = _mamba1_ssm_params(cfg, p, xs)              # (B,C),(B,N)
    A = -torch.exp(p["A_log"].to(F32))
    da = torch.exp(dt[..., None] * A)                        # (B,C,N)
    h = state["ssm"] * da + (dt * xs.to(F32))[..., None] * Bm[:, None, :]
    y = torch.einsum("bcn,bn->bc", h, Cm)
    y = y + p["D_skip"] * xs.to(F32)
    y = y.to(xt.dtype) * F.silu(z)
    out = y @ p["wo"]
    return out, {"conv_x": st_x, "ssm": h}


def mamba1_state_defs(cfg: ModelConfig, batch: int):
    """Per-slot decode state: the conv tail (batch, d_conv - 1, C) in the
    parameter dtype, the SSM state (batch, C, N) in f32."""
    from repro_torch.params import ParamSpec    # params imports the stack
    s = cfg.ssm
    C, N = cfg.d_inner, s.d_state
    return {"conv_x": ParamSpec((batch, s.d_conv - 1, C), cfg.pdtype,
                                "zeros"),
            "ssm": ParamSpec((batch, C, N), F32, "zeros")}


# ---------------------------------------------------------------- dispatch
def mamba_mixer(cfg: ModelConfig, p, x, return_state: bool = False):
    """The mixer of ``cfg.ssm.version``: x (B,S,D) → (B,S,D) (and the
    decode state with ``return_state``)."""
    fn = mamba2_mixer if cfg.ssm.version == 2 else mamba1_mixer
    return fn(cfg, p, x, return_state=return_state)


def mamba_step(cfg: ModelConfig, p, xt, state):
    """The decode step of ``cfg.ssm.version``."""
    fn = mamba2_step if cfg.ssm.version == 2 else mamba1_step
    return fn(cfg, p, xt, state)


def mamba_state_defs(cfg: ModelConfig, batch: int):
    """The per-slot decode state of ``cfg.ssm.version``."""
    fn = mamba2_state_defs if cfg.ssm.version == 2 else mamba1_state_defs
    return fn(cfg, batch)
