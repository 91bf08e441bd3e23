"""Shared layer primitives (``repro/models/layers.py``): norm, rope, the
gated and non-gated MLP, embedding, the f32 logits and the chunked
cross-entropy.

On a mesh (a ``ctx`` whose ``model`` axis has m > 1 ranks) the residual
stream stays whole on every rank, where JAX scatters it over ``seq``; the
results are the same up to the order of the sums. The MLP is Megatron's
column- and row-parallel pair (``w_up``/``w_gate`` cut on ``mlp``,
``w_down`` on its first dim, one all-reduce after ``w_down``); the
embedding and the logits take the vocab axis cut in m parts (a masked
lookup and an all-reduce; the logits' parts gathered)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.axes import model_shard
from repro_torch.sharding.collectives import all_gather, all_reduce

F32 = torch.float32


# ----------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(F32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


# ------------------------------------------------------------------ rope
def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """positions (…,) int → cos/sin (…, dim/2) fp32."""
    half = dim // 2
    exponent = torch.arange(half, dtype=F32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, dh); cos/sin (S, dh/2) or (B, S, dh/2). NeoX half-rotation
    in f32."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    if cos.dim() == 2:  # (S, half) → broadcast over batch & heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:               # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


# ------------------------------------------------------------ activations
def activation(name: str):
    """The non-gated activations: relu2 (squared ReLU, nemotron) and gelu
    (the tanh approximation)."""
    if name in ("swiglu", "geglu"):
        raise ValueError("gated activations are handled inside mlp()")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def is_gated(act: str) -> bool:
    return act in ("swiglu", "geglu")


def gate_fn(act: str):
    return F.silu if act == "swiglu" else (
        lambda x: F.gelu(x, approximate="tanh"))


# ------------------------------------------------------------- dense MLP
def mlp(cfg: ModelConfig, p, x: torch.Tensor, ctx=None) -> torch.Tensor:
    """Gated (``w_gate``) or non-gated MLP, x (…, D) → (…, D), in the JAX
    order: up-projection, then the gate's product or the activation, then
    the down-projection; projections on cuBLAS. On a mesh each rank holds
    its columns of ``w_up``/``w_gate`` and rows of ``w_down``, and one
    all-reduce sums the ranks' products."""
    h = x @ p["w_up"]
    if is_gated(cfg.act):
        h = gate_fn(cfg.act)(x @ p["w_gate"]) * h
    else:
        h = activation(cfg.act)(h)
    out = h @ p["w_down"]
    return all_reduce(out, ctx) if model_shard(ctx)[0] > 1 else out


# -------------------------------------------------------------- embedding
def _vocab_lookup(table: torch.Tensor, tokens: torch.Tensor,
                  ctx) -> torch.Tensor:
    """Rows of the vocab-sharded ``table`` (V/m, D): each rank looks up the
    tokens in its part, zero elsewhere, and an all-reduce sums the parts
    (each token's row comes from one rank, so the sum is exact)."""
    m, i = model_shard(ctx)
    rel = tokens.long() - i * table.shape[0]
    mine = (rel >= 0) & (rel < table.shape[0])
    h = table[rel.clamp(0, table.shape[0] - 1)]
    h = torch.where(mine[..., None], h, torch.zeros((), dtype=h.dtype,
                                                     device=h.device))
    return all_reduce(h, ctx)


def embed(cfg: ModelConfig, p, tokens: torch.Tensor,
          frontend_embed: torch.Tensor | None = None,
          ctx=None) -> torch.Tensor:
    """tokens (…) int → (…, D) in the parameter dtype, times sqrt(d) with
    ``embed_scale``. A front end (VLM): ``frontend_embed`` (B, F,
    frontend_dim) is projected by ``frontend_proj`` in the parameter dtype
    (and scaled alike), and replaces the first F positions of tokens (B, S)
    (the tokens there are a pad id). On a mesh the table is cut on vocab
    (:func:`_vocab_lookup`)."""
    if model_shard(ctx)[0] > 1:
        h = _vocab_lookup(p["table"], tokens, ctx).to(cfg.pdtype)
    else:
        h = p["table"][tokens].to(cfg.pdtype)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    if frontend_embed is not None:
        fe = frontend_embed.to(cfg.pdtype) @ p["frontend_proj"]
        if cfg.embed_scale:
            fe = fe * torch.tensor(cfg.d_model ** 0.5, dtype=fe.dtype)
        h = torch.cat([fe, h[:, fe.shape[1]:]], dim=1)
    return h


# ----------------------------------------------------------------- logits
def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(h, w, out_dtype=float32)`` on the card, which has no
    derivative of its own. The backward rounds the f32 cotangent to the
    operands' dtype and takes the two products in it (f32 sums)."""

    @staticmethod
    def forward(ctx, h2, w):
        ctx.save_for_backward(h2, w)
        return torch.mm(h2, w, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        h2, w = ctx.saved_tensors
        g = g.to(h2.dtype)
        return g @ w.T, h2.T @ g


def matmul_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(…, D) @ (D, V) with f32 products and sums, f32 out, without an f32
    copy of ``w``: on the card ``torch.mm(..., out_dtype=float32)``
    (``aten::mm.dtype``, CUDA only); on the host the operands are upcast."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if h.dtype == F32 and w.dtype == F32:
        out = h2 @ w
    elif h.is_cuda:
        out = _MatmulF32.apply(h2, w)
    else:
        out = h2.to(F32) @ w.to(F32)
    return out.reshape(*lead, w.shape[-1])


def logits_fn(cfg: ModelConfig, embed_p, unembed_p,
              h: torch.Tensor, ctx=None) -> torch.Tensor:
    """h (…, D) → logits (…, V) fp32. On a mesh each rank computes its
    part of the vocab and the parts are gathered in rank order, so every
    rank holds the whole row (and a greedy argmax picks the lowest index
    of a tie, as JAX's)."""
    w = embed_p["table"].T if cfg.tie_embeddings else unembed_p["w"]
    out = _softcap(matmul_f32(h, w.to(h.dtype)), cfg.final_softcap)
    return all_gather(out, -1, ctx) if model_shard(ctx)[0] > 1 else out


def chunked_ce_loss(cfg: ModelConfig, embed_p, unembed_p, h: torch.Tensor,
                    targets: torch.Tensor, mask: torch.Tensor,
                    chunk: int = 512):
    """Cross-entropy without materialising (B, S, V): sequence chunks of
    ``chunk``, each under activation checkpointing, f32 logits, the label
    logit gathered. h (B,S,D), targets (B,S) int, mask (B,S) f32 →
    (sum_loss, sum_count) f32 scalars."""

    def chunk_loss(hc, tc, mc):
        logits = logits_fn(cfg, embed_p, unembed_p, hc)      # (B,c,V) f32
        lse = torch.logsumexp(logits, dim=-1)
        lab = logits.gather(-1, tc[..., None].long())[..., 0]
        return torch.sum((lse - lab) * mc), torch.sum(mc)

    S = h.shape[1]
    sum_l = h.new_zeros((), dtype=F32)
    sum_c = h.new_zeros((), dtype=F32)
    for s0 in range(0, S, min(chunk, S)):
        sl = slice(s0, s0 + chunk)
        args = (h[:, sl], targets[:, sl], mask[:, sl])
        if torch.is_grad_enabled():
            l, c = checkpoint(chunk_loss, *args, use_reentrant=False)
        else:
            l, c = chunk_loss(*args)
        sum_l, sum_c = sum_l + l, sum_c + c
    return sum_l, sum_c
