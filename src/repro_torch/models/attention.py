"""GQA and MLA projections, prefill attention, the training blocks and
cross attention (``repro/models/attention.py``).

``attend`` keeps the contract of the JAX ``attend_chunked`` (causal,
sliding window, softcap; q (B,Tq,Hkv,G,dh), k (B,Tk,Hkv,dh), v
(B,Tk,Hkv,dv)) and runs the hand-written flash kernels
(``kernels/flash_attention``) on the card. The kernels take strided views,
so neither the head transpose nor the GQA broadcast is materialized. When a
gradient is wanted, :class:`FlashAttention` (the custom VJP
``_attend_fwd``/``_attend_bwd``) saves the forward's lse and runs the
backward kernel.

On a mesh (a ``ctx`` whose ``model`` axis has m > 1 ranks) each rank holds
its H/m query heads and Hkv/m KV heads (``wq``/``wk``/``wv`` cut on
``heads``/``kv_heads``, ``wo`` on its first dim) and one all-reduce after
``wo`` sums the ranks' heads. Heads that do not divide m take JAX's
context-parallel path, which the port refuses
(``transformer.py::check_sharded``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, rmsnorm, rope_tables
from repro_torch.sharding.axes import model_shard
from repro_torch.sharding.collectives import all_reduce


def gqa_project(cfg: ModelConfig, p, x: torch.Tensor, positions):
    """x (B,S,D) → q (B,S,Hkv,G,dh), k,v (B,S,Hkv,dh) over the heads the
    weights hold (a rank's H/m and Hkv/m on a mesh). Applies rope."""
    B, S, D = x.shape
    H, Hkv, dh = p["wq"].shape[1], p["wk"].shape[1], cfg.head_dim
    q = (x @ p["wq"].reshape(D, -1)).view(B, S, H, dh)
    k = (x @ p["wk"].reshape(D, -1)).view(B, S, Hkv, dh)
    v = (x @ p["wv"].reshape(D, -1)).view(B, S, Hkv, dh)
    if cfg.use_rope:
        cos, sin = rope_tables(positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q.reshape(B, S, Hkv, H // Hkv, dh), k, v


def out_project(o: torch.Tensor, wo: torch.Tensor, ctx=None) -> torch.Tensor:
    """The attention's out-projection: o (…, H·dv) @ wo (H, dv, D), the
    ranks' heads summed by one all-reduce on a mesh."""
    out = o @ wo.reshape(-1, wo.shape[-1])
    return all_reduce(out, ctx) if model_shard(ctx)[0] > 1 else out


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward: the forward keeps (q, k, v,
    o, lse), the backward recomputes p from lse (``_attend_fwd`` /
    ``_attend_bwd``). Tensors are (B, H|Hk, T, d) views."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
        o, lse = flash_ops.attend_fwd_lse(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_ops.attend_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def attend(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
           softcap: float = 0.0):
    """q (B,Tq,Hkv,G,dh), k (B,Tk,Hkv,dh), v (B,Tk,Hkv,dv) → (B,Tq,Hkv,G,dv).
    Runs :class:`FlashAttention` when an input wants a gradient, else the
    forward alone (serving launches no lse)."""
    B, Tq, Hkv, G, dh = q.shape
    qh = q.reshape(B, Tq, Hkv * G, dh).permute(0, 2, 1, 3)   # views
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = FlashAttention.apply(qh, kh, vh, scale, causal, window,
                                   softcap)
    else:
        out = flash_ops.attend(qh, kh, vh, scale=scale, causal=causal,
                               window=window, softcap=softcap)
    return out.permute(0, 2, 1, 3).reshape(B, Tq, Hkv, G, v.shape[-1])


def gqa_attention(cfg: ModelConfig, p, x: torch.Tensor, *, window: int,
                  positions, causal: bool = True, ctx=None) -> torch.Tensor:
    """The GQA block with no cache (training, whisper's encoder and
    decoder): project, attention (causal unless told), out-project. x
    (B,S,D) → (B,S,D)."""
    B, S, D = x.shape
    q, k, v = gqa_project(cfg, p, x, positions)
    out = attend(q, k, v, scale=cfg.head_dim ** -0.5, causal=causal,
                 window=window, softcap=cfg.attn_softcap)
    return out_project(out.reshape(B, S, -1), p["wo"], ctx)


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


def mla_qkv(cfg: ModelConfig, p, x: torch.Tensor, positions):
    """MLA in the expanded form: the latents up-projected to full heads.
    x (B,S,D) → q (B,S,H,1,nope+rope) (G = 1), k (B,S,H,nope+rope) (k_rope
    broadcast over the heads), v (B,S,H,v) (a view of the up-projection),
    and the cache pair c_kv (B,S,kv_lora), k_rope (B,S,1,rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    qn, qr = mla_queries(cfg, p, x, positions)
    c_kv, k_r = mla_latents(cfg, p, x, positions)
    kv = (c_kv @ p["wukv"].reshape(m.kv_lora, -1)).view(
        B, S, H, m.nope_dim + m.v_dim)
    kn, v = kv[..., :m.nope_dim], kv[..., m.nope_dim:]
    k = torch.cat([kn, k_r.expand(B, S, H, m.rope_dim).to(kn.dtype)], dim=-1)
    q = torch.cat([qn, qr], dim=-1)[:, :, :, None, :]
    return q, k, v, c_kv, k_r


def mla_attention(cfg: ModelConfig, p, x: torch.Tensor, *, window: int,
                  positions) -> torch.Tensor:
    """The training MLA block with no cache (JAX ``mla_attention``): the
    expanded heads through :func:`attend` at G = 1, scale (nope +
    rope)^-0.5, then the out-projection. x (B,S,D) → (B,S,D)."""
    m = cfg.mla
    B, S, D = x.shape
    q, k, v, _, _ = mla_qkv(cfg, p, x, positions)
    out = attend(q, k, v, scale=(m.nope_dim + m.rope_dim) ** -0.5,
                 causal=True, window=window, softcap=cfg.attn_softcap)
    return out.reshape(B, S, -1) @ p["wo"].reshape(-1, D)


def attention(cfg: ModelConfig, p, x: torch.Tensor, *, window: int,
              positions, causal: bool = True, ctx=None) -> torch.Tensor:
    """The attention block of a layer with no cache: MLA (causal, one
    device) or GQA, head-parallel on a mesh (JAX ``attention``; its
    context-parallel branch is refused before this is reached)."""
    if cfg.mla:
        return mla_attention(cfg, p, x, window=window, positions=positions)
    return gqa_attention(cfg, p, x, window=window, positions=positions,
                         causal=causal, ctx=ctx)


# --------------------------------------------------------- cross attention
def cross_kv(cfg: ModelConfig, p, enc_out: torch.Tensor):
    """The cross attention's K and V of the encoder states: enc_out
    (B,Se,D) → k, v (B,Se,Hkv,dh), plain GEMMs as JAX's einsums."""
    B, Se, D = enc_out.shape
    k = (enc_out @ p["wk"].reshape(D, -1)).view(B, Se, cfg.n_kv_heads,
                                                cfg.head_dim)
    v = (enc_out @ p["wv"].reshape(D, -1)).view(B, Se, cfg.n_kv_heads,
                                                cfg.head_dim)
    return k, v


def cross_attention(cfg: ModelConfig, p, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Decoder states x (B,Td,D) over precomputed encoder K/V (B,Te,Hkv,dh):
    project q, attention with no mask (the flash forward at ``causal=False``
    on the card), out-project → (B,Td,D)."""
    B, Td, D = x.shape
    G = cfg.n_heads // cfg.n_kv_heads
    q = (x @ p["wq"].reshape(D, -1)).view(B, Td, cfg.n_kv_heads, G,
                                          cfg.head_dim)
    out = attend(q, k, v, scale=cfg.head_dim ** -0.5, causal=False)
    return out.reshape(B, Td, -1) @ p["wo"].reshape(-1, D)
