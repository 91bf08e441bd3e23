"""Mixture-of-Experts FFN (``repro/models/moe.py``), expert-parallel on a
mesh.

The JAX block runs inside a ``shard_map`` over the ``model`` axis, each
shard computing its local experts. On one device that axis has size 1, so
``E_loc = E`` and ``e0 = 0`` and no collective remains. On a mesh of m
ranks each rank holds experts [e0, e0 + E/m): the router is whole on every
rank and so are the tokens (the port's residual stream is whole, so JAX's
token all-gather over ``model`` has nothing to gather), each rank routes
every token, dispatches only the slots of its own experts, runs them
through the grouped GEMM, and one all-reduce sums the ranks' outputs
(JAX: a reduce-scatter back to its seq-sharded stream in prefill, a psum
in decode). The capacity ``Ce`` counts every token of the batch, so the
same tokens drop as on one device. The routing keeps the JAX semantics
exactly: router product with f32 result, softmax, top-k, renormalized
gates, a stable sort by expert, a fixed capacity ``Ce`` per expert over
EVERY row of the (padded) batch, Switch-style dropping past it.

The expert products (up, gate and down for a gated FFN; up and down
around the activation for a non-gated one, as JAX's ``is_gated``
branches) go through the hand-written grouped GEMM
(``kernels/grouped_gemm``), one launch per product, and under
autograd through :class:`~repro_torch.kernels.grouped_gemm.ops.GroupedGemm`
(two more launches a product in the backward); the router and the shared
experts are plain ``torch.matmul``, as XLA computes them in JAX. The
dispatch and combine are index writes that autograd differentiates, and
the routing is a pure function of the block's input, so a layer's
checkpoint recompute routes every token as its forward did.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.grouped_gemm.ops import grouped_gemm_autograd
from repro_torch.models.layers import activation, gate_fn, is_gated, matmul_f32
from repro_torch.sharding.axes import model_shard
from repro_torch.sharding.collectives import all_reduce

F32 = torch.float32


def _route(cfg: ModelConfig, p, xf: torch.Tensor):
    """xf (T, D) → (probs (T,E) f32, gates (T,k) f32, eidx (T,k) int64)."""
    logits = matmul_f32(xf, p["router"].to(xf.dtype))
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, gates / gates.sum(-1, keepdim=True), eidx


def _experts(cfg: ModelConfig, p, buf: torch.Tensor) -> torch.Tensor:
    """buf (E, M, D) → (E, M, D): the expert FFN, three grouped GEMMs when
    gated, two around the activation when not."""
    h = grouped_gemm_autograd(buf, p["w_up"])
    if is_gated(cfg.act):
        h = gate_fn(cfg.act)(grouped_gemm_autograd(buf, p["w_gate"])) * h
    else:
        h = activation(cfg.act)(h)
    return grouped_gemm_autograd(h, p["w_down"])


def _shared(cfg: ModelConfig, p, xf: torch.Tensor) -> torch.Tensor:
    hs = xf @ p["ws_up"]
    if is_gated(cfg.act):
        hs = gate_fn(cfg.act)(xf @ p["ws_gate"]) * hs
    else:
        hs = activation(cfg.act)(hs)
    return hs @ p["ws_down"]


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert capacity ``Ce`` for a batch of ``n_tokens`` rows."""
    m = cfg.moe
    return max(1, math.ceil(n_tokens * m.top_k * m.capacity_factor /
                            m.n_experts))


def _local_experts(p, ctx) -> tuple[int, int]:
    """(E_loc, e0): how many experts this rank holds and the first one."""
    E_loc = p["w_up"].shape[0]
    return E_loc, model_shard(ctx)[1] * E_loc


def moe_block(cfg: ModelConfig, p, x: torch.Tensor, ctx=None):
    """x (B, S, D) → (out (B, S, D), router stats (2, E) f32).

    Stats rows: the mean softmax probability per expert and the fraction of
    the ``T·k`` routing slots per expert (``moe.py::aux_loss_from_stats``).
    Capacity counts every row of ``x``, pad rows and pad tokens included, as
    the JAX engine's padded prefill does. On a mesh the slots of other
    ranks' experts sort past a sentinel expert ``E_loc`` and are dropped
    here (JAX's ``key_e``)."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    E_loc, e0 = _local_experts(p, ctx)
    b, S, D = x.shape
    T = b * S
    xf = x.reshape(T, D)
    probs, gates, eidx = _route(cfg, p, xf)
    counts = torch.bincount(eidx.reshape(-1), minlength=E)
    stats = torch.stack([probs.mean(0), counts.to(F32) / (T * k)])

    # dispatch: stable sort by expert, position within the expert, capacity
    flat_e = eidx.reshape(-1)                                   # (T·k,)
    if E_loc < E:      # another rank's expert: the sentinel E_loc
        flat_e = flat_e - e0
        flat_e = torch.where((flat_e >= 0) & (flat_e < E_loc), flat_e,
                             torch.full_like(flat_e, E_loc))
        counts = torch.bincount(flat_e, minlength=E_loc + 1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    offsets = torch.cumsum(counts, 0) - counts                  # (E,)
    slot_pos = torch.arange(T * k, device=x.device) - offsets[sorted_e]
    Ce = capacity(cfg, T)
    keep = slot_pos < Ce
    if E_loc < E:
        keep &= sorted_e < E_loc
    tok = order // k
    rows = torch.where(keep, sorted_e * Ce + slot_pos,
                       torch.full_like(sorted_e, E_loc * Ce))   # drop row
    buf = x.new_zeros((E_loc * Ce + 1, D))
    buf[rows] = xf[tok]
    eo = _experts(cfg, p, buf[:E_loc * Ce].view(E_loc, Ce, D)).reshape(
        E_loc * Ce, D)
    eo = torch.cat([eo, eo.new_zeros((1, D))])

    # combine: each routing slot's gated output goes back to its (token, j)
    # place — a permutation, so no atomics — then the k slots are summed
    slot = eo[rows] * (gates.reshape(-1)[order] * keep).unsqueeze(1).to(
        eo.dtype)
    per_slot = torch.empty_like(slot)
    per_slot[order] = slot
    out = per_slot.view(T, k, D).sum(1)
    if m.n_shared:
        out = out + _shared(cfg, p, xf)
    if E_loc < E:
        out = all_reduce(out, ctx)
    return out.reshape(b, S, D), stats


def moe_decode(cfg: ModelConfig, p, x: torch.Tensor, ctx=None) -> torch.Tensor:
    """Decode-path MoE, x (T, D) → (T, D): every expert computes every token
    (no capacity), weighted by the token's renormalized gate (0 off its
    top-k). The tokens reach the grouped GEMM broadcast over the experts with
    stride 0, so each product is one launch over (E, T, D). On a mesh each
    rank runs its own E/m experts and one all-reduce sums the ranks'
    outputs."""
    m = cfg.moe
    T, D = x.shape
    E_loc, e0 = _local_experts(p, ctx)
    _, gates, eidx = _route(cfg, p, x)
    w_tok = torch.zeros((T, m.n_experts), dtype=F32, device=x.device)
    w_tok.scatter_(1, eidx, gates)                 # top-k experts are distinct
    o = _experts(cfg, p, x.unsqueeze(0).expand(E_loc, T, D))
    w_loc = w_tok[:, e0:e0 + E_loc]
    out = (o * w_loc.t().unsqueeze(-1).to(o.dtype)).sum(0)
    if m.n_shared:
        out = out + _shared(cfg, p, x)
    return all_reduce(out, ctx) if E_loc < m.n_experts else out


def aux_loss_from_stats(cfg: ModelConfig, stats: torch.Tensor) -> torch.Tensor:
    """The load-balancing loss of router stats (2, E), or (n, 2, E) averaged
    over n: aux_weight · E · Σ mean_prob · frac, with no gradient through
    the slot fractions (JAX ``stop_gradient``)."""
    m = cfg.moe
    if stats.dim() == 3:
        stats = stats.mean(0)
    return m.aux_weight * m.n_experts * torch.sum(stats[0]
                                                  * stats[1].detach())
