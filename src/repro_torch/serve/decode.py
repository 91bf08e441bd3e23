"""Single-token decode and the fused decode quantum
(``repro/serve/decode.py``: GQA attention, full or sliding-window, or MLA,
with a dense or MoE FFN, pre- or post-norm, or Mamba-1 or Mamba-2 mixers
with or without an FFN, alone or interleaved with attention, on one
device).

A full-attention layer of a paged engine writes the new token's K/V (GQA)
or latent row (MLA) into its page pools in place (``_paged_write``), then a
hand-written paged kernel (``kernels/paged_attention``) walks the page
table and returns the unnormalized ``(o, m, l)`` partials, which
``_combine`` normalizes. With ``paged_kernel=False`` (the gathered-view
decode, JAX's escape hatch) the write is the same, but each slot's whole
page table is gathered into contiguous rows (``_gathered``) and attended
in plain torch by the dense rows' own ``_dense_attend``: no paged kernel
and no kernel's plain version runs. A layer with dense per-slot rows
(every attention layer of the dense engine, and the sliding-window rings
of either engine)
writes its row in place at ``pos`` (a ring at ``pos mod Sc``,
``_local_write``) and attends over the rows in plain torch, as JAX does
with an einsum (no TPU kernel computes it): a ring slot j holds position
``p_j = pos - ((pos - j) mod Sc)``, live while ``p_j > pos - window``. MLA
decodes in the latent space with the absorbed weights: the cache row is
both key and value (MQA-style, dim kv_lora + rope). A Mamba layer steps
its per-slot state (``mamba_step``, plain torch) for every slot, active or
not, as JAX does: a slot's state is overwritten by the admit that next
fills it.

``decode_loop`` runs a quantum of ``num_steps`` tokens as a Python loop
whose state (tokens, positions, masks, cache) never leaves the device; it
is the functional reference. ``decode_quantum`` runs the same loop and
writes the carry, the Mamba states and the packed result back into the
tensors it was given, so a CUDA graph of it (``serve/graphs.py``) reads
and writes the same storage at every replay; the engine reads the packed
result back once per quantum. Per-step constants (the rope tables, the
page and offset of ``pos``, the write row and live keys of each shape of
dense rows) are computed once per step for all layers.

Speculative big/little decode: a round runs ``spec_k`` serial draft steps
(``decode_step`` of the draft on its own dense cache), one batched target
verify of the K = spec_k + 1 positions (``decode_verify``: the cache
read-only; each query sees the committed history, from the paged kernels
on B·K repeated rows (or the gathered pages) or from dense rows and rings
in plain torch, merged with the staged K×K block's partials; a Mamba-1 or
Mamba-2 layer steps its state K times and stages the K states), the
emission law (``spec_candidates``:
greedy acceptance, or rejection sampling against the filtered
distributions) and the commit of the accepted prefix (``decode_commit``).
``spec_decode_loop`` is its functional reference and
``spec_decode_quantum`` the same loop in place, one CUDA graph per width
like ``decode_quantum``. ``plan_resume`` is the tier pool's retry law
(``serve/multi_engine.py``).

On a mesh of m ranks on ``model`` (``ctx``; GQA with a dense or MoE FFN
through the paged kernel, ``transformer.py::check_sharded``) each rank
projects its H/m query and Hkv/m KV heads, one all-gather makes every
head whole on every rank, and each rank's pools hold the in-page offsets
[i·ps/m, (i+1)·ps/m) of every page (JAX's ``kv_seq`` sharding): the write
lands on the rank that owns ``pos mod ps`` (the others route it to the
trash page 0), the kernel attends the whole query over the rank's offsets
(``base = i·ps/m``, ``page_size = ps``), and ``_combine`` merges the
ranks' partials exactly (an all-reduce MAX of ``m``, then one SUM of
``o·c`` and ``l·c``). The out-projection, the MLP and the MoE each end in
one all-reduce; the logits' vocab parts are gathered before sampling.

An encoder-decoder (whisper) steps through ``whisper_decode_step``: each
decoder layer writes its self row at ``pos`` into dense rows of
``max_decoder_len`` (a ``pos`` past them writes nothing) and attends over
them and over the prefilled cross K/V, both in plain torch as JAX's
einsum (no TPU kernel computes either). ``serve_step_fn`` dispatches
between it and ``decode_step``, as JAX's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models.attention import out_project
from repro_torch.models.layers import (apply_rope, embed, logits_fn, mlp,
                                       rmsnorm, rope_tables)
from repro_torch.models.mamba import mamba_step
from repro_torch.models.moe import moe_decode
from repro_torch.models.transformer import BlockCfg, block_cfgs
from repro_torch.sharding.axes import model_shard
from repro_torch.sharding.collectives import all_gather, all_reduce

F32 = torch.float32
NEG = -1e30


# ------------------------------------------------------------ flash decode
def combine_shards(o, m, l, pmax, psum):
    """Exact softmax of the shards' unnormalized (o, m, l) partials (JAX
    ``_combine``): ``pmax(m)`` the largest ``m`` over the shards, each
    shard's partial rescaled by ``c = exp(m - max)`` (a shard with no live
    key, ``m <= NEG/2``, weighs 0), ``psum(o·c, l·c)`` their sums, then
    o / l. The mesh reduces with collectives (:func:`_combine`); one card
    holding the shards' partials stacked on a leading dim reduces over
    it."""
    m_g = pmax(m)
    m_safe = torch.where(m_g <= NEG / 2, 0.0, m_g)
    c = torch.exp(torch.where(m <= NEG / 2, NEG, m) - m_safe)
    o, l = psum(o * c[..., None], l * c)
    return o / torch.clamp(l, min=1e-30)[..., None]


def _psum_pair(o, l, ctx):
    """(o, l) summed over the model axis in one all-reduce."""
    ol = all_reduce(torch.cat([o, l[..., None]], dim=-1), ctx)
    return ol[..., :-1], ol[..., -1]


def _combine(o, m, l, ctx=None):
    """Exact softmax from (o, m, l) partials: o / l for the one partial of
    a row on one rank; on a mesh the ranks' partials of the row, merged by
    :func:`combine_shards` over the model axis."""
    if model_shard(ctx)[0] == 1:
        return o / torch.clamp(l, min=1e-30)[..., None]
    return combine_shards(o, m, l,
                          lambda t: all_reduce(t, ctx, op="max"),
                          lambda a, b: _psum_pair(a, b, ctx))


def _local_write(cache, new_row, rel):
    """Write ``new_row`` (B,…) at row ``rel`` (B,) of each slot of ``cache``
    (B, S, …), IN PLACE; a ``rel`` outside [0, S) writes nothing (the slot
    keeps its row)."""
    B, S = cache.shape[0], cache.shape[1]
    in_range = (rel >= 0) & (rel < S)
    relc = rel.clamp(0, S - 1).long()
    b = torch.arange(B, device=cache.device)
    cur = cache[b, relc]                                   # (B, …)
    mask = in_range.reshape((B,) + (1,) * (cache.dim() - 2))
    cache.index_put_((b, relc), torch.where(mask, new_row.to(cache.dtype),
                                            cur))
    return cache


def _dense_rows(pos, S: int, window: int):
    """(write row (B,), live mask (B, S)) of a layer of S dense rows per slot
    at positions ``pos`` (B,), the new token's row included: a ring (a
    window) writes at ``pos mod S`` and its slot j holds position ``p_j =
    pos - ((pos - j) mod S)``, live while ``p_j >= 0`` and ``p_j > pos -
    window``; full rows write at ``pos`` and see rows ``<= pos``."""
    gpos = torch.arange(S, device=pos.device)
    p = pos.long()[:, None]
    if window:
        p_j = p - torch.remainder(p - gpos[None], S)
        return torch.remainder(pos.long(), S), (p_j >= 0) & (p_j > p - window)
    return pos.long(), gpos[None] <= p


def _dense_attend(q, k, v, live, *, scale: float, softcap: float = 0.0):
    """Attention of one query row per (slot, head) over dense rows, in f32 as
    the JAX einsum: q (B,Hk,G,d), k (B,S,Hk,d), v (B,S,Hk,dv) (MLA: Hk 1,
    v the rows' first dims), live (B,S) → (B,Hk,G,dv); softcap before the
    mask."""
    s = torch.einsum("bhgd,bshd->bhgs", q.to(F32) * scale, k.to(F32))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    live = live[:, None, None]
    s = torch.where(live, s, NEG)
    m = torch.amax(s, -1)
    m_safe = torch.where(m <= NEG / 2, 0.0, m)
    p = torch.where(live, torch.exp(s - m_safe[..., None]), 0.0)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.to(F32))
    return _combine(o, m, torch.sum(p, -1))


def _gathered(pool, page_table):
    """The gathered view of a page pool (N, ps, …) through ``page_table``
    (B, T): each slot's T pages as contiguous rows (B, T·ps, …), row r
    holding logical position r (JAX ``kernels/paged_attention/ref.py::
    _gathered``)."""
    B, T = page_table.shape
    g = pool[page_table.long()]                            # (B, T, ps, …)
    return g.reshape((B, T * pool.shape[1]) + tuple(pool.shape[2:]))


def _page_slot(pt, pos, ps_loc: int, i: int = 0, msize: int = 1):
    """(page, offset) int64 (B,) of this rank's pool where logical position
    ``pos`` (B,) is written, through page table ``pt`` (B,T) of pages of
    ``ps = ps_loc · msize`` rows, rank ``i`` holding in-page offsets
    [i·ps_loc, (i+1)·ps_loc): computed once per step for every layer's
    write. A rank that does not own ``pos mod ps`` writes the trash page 0
    (JAX masks that write out)."""
    T = pt.shape[1]
    ps = ps_loc * msize
    idx = torch.clamp(pos // ps, max=T - 1).long()
    page = pt.gather(1, idx[:, None])[:, 0]
    # a slot frozen at pos == max_len still scribbles each step; route it
    # to the trash page, never a live one
    page = torch.where(pos < T * ps, page, torch.zeros_like(page))
    if msize == 1:
        return page.long(), (pos % ps).long()
    rel = pos % ps - i * ps_loc
    mine = (rel >= 0) & (rel < ps_loc)
    page = torch.where(mine, page, torch.zeros_like(page))
    return page.long(), rel.clamp(0, ps_loc - 1).long()


def _paged_write(pool, new_row, pt, pos, i: int = 0, msize: int = 1,
                 slot=None):
    """Write ``new_row`` (B,…) at logical position ``pos`` (B,) through page
    table ``pt`` (B,T) into rank ``i``'s ``pool`` (N, ps/msize, …) of a
    model axis of ``msize`` (JAX ``_paged_write``), IN PLACE
    (``index_put_``), at ``slot`` (:func:`_page_slot`) when the caller has
    it. Distinct live slots hold disjoint pages (allocator invariant), so
    only the trash page 0 can receive duplicate writes."""
    if slot is None:
        slot = _page_slot(pt, pos, pool.shape[1], i, msize)
    pool.index_put_(slot, new_row)
    return pool


def _check_paged_args(page_table, pos, *, update: bool = True,
                      window: int = 0) -> None:
    """Typed validation of the paged decode entry point."""
    if not update:
        raise ValueError(
            "paged decode always writes the new token's K/V; attend-only "
            "(update=False) callers must use the dense cache path")
    if window:
        raise ValueError(
            f"paged cache is full-attention only (window={window}); "
            "sliding-window layers keep their dense ring buffers")
    if page_table.dim() != 2:
        raise ValueError(
            f"page_table must be (batch, table_width) int32, got shape "
            f"{tuple(page_table.shape)}")
    if page_table.shape[0] != pos.shape[0]:
        raise ValueError(
            f"page_table batch {page_table.shape[0]} != pos batch "
            f"{pos.shape[0]}")


def flash_decode_gqa(q, k_new, v_new, pool_k, pool_v, pos, *, scale: float,
                     softcap: float, page_table=None, window: int = 0,
                     slot=None, rows=None, update: bool = True, ctx=None):
    """q (B,Hkv,G,dh); k_new/v_new (B,Hkv,dh); pos (B,) int32 → (out
    (B,Hkv,G,dh), k, v), the cache written in place.

    With ``page_table`` (B,T) int32 the cache is the pools (N, ps, Hkv, dh)
    and ``slot`` the write's :func:`_page_slot`: the paged kernel, or, when
    ``rows`` is given (the gathered decode, :class:`StepConsts`), the
    gathered view (:func:`_gathered`) with ``rows``' live mask through
    :func:`_dense_attend`. Without a table it is
    dense rows (B, S, Hkv, dh), a ring of S slots with ``window``, and
    ``rows`` the layer's :func:`_dense_rows`: plain torch, as JAX's einsum
    (``update=False`` attends without writing). On a mesh (``ctx``, the
    paged kernel only) the pools are this rank's in-page offsets, q and
    the new rows every head, and the ranks' partials are combined."""
    if page_table is None:
        rel, live = rows
        if update:
            _local_write(pool_k, k_new, rel)
            _local_write(pool_v, v_new, rel)
        k, v = pool_k, pool_v
    else:
        _check_paged_args(page_table, pos, update=update, window=window)
        msize, i = model_shard(ctx)
        _paged_write(pool_k, k_new, page_table, pos, i, msize, slot=slot)
        _paged_write(pool_v, v_new, page_table, pos, i, msize, slot=slot)
        if rows is None:
            B, hkv, grp, dh = q.shape
            ps_loc = pool_k.shape[1]
            o, m, l = paged_ops.paged_attend_gqa(
                q, pool_k, pool_v, page_table, pos, i * ps_loc,
                page_size=ps_loc * msize, scale=scale, softcap=softcap)
            out = _combine(o.reshape(B, hkv, grp, dh), m.reshape(B, hkv, grp),
                           l.reshape(B, hkv, grp), ctx)
            return out.to(q.dtype), pool_k, pool_v
        k, v = _gathered(pool_k, page_table), _gathered(pool_v, page_table)
        live = rows[1]
    out = _dense_attend(q, k, v, live, scale=scale, softcap=softcap)
    return out.to(q.dtype), pool_k, pool_v


def flash_decode_mla(q_eff, new_row, pool, pos, *, kv_lora: int,
                     scale: float, page_table=None, slot=None, rows=None):
    """q_eff (B,H,R); new_row (B,R); pos (B,) int32 → (out (B,H,kv_lora),
    cache), the cache written in place. Key = the cache row, value = its
    first kv_lora dims. With ``page_table`` (B,T) int32 the cache is the
    pool (N, ps, R), ``slot`` and ``rows`` (the gathered view's) as in
    :func:`flash_decode_gqa`; without, dense rows (B, S, R) and ``rows``
    their :func:`_dense_rows`."""
    if page_table is None:
        _local_write(pool, new_row, rows[0])
        ckv, live = pool, rows[1]
    else:
        _check_paged_args(page_table, pos)
        _paged_write(pool, new_row, page_table, pos, slot=slot)
        if rows is None:
            o, m, l = paged_ops.paged_attend_mla(
                q_eff, pool, page_table, pos, 0, page_size=pool.shape[1],
                kv_lora=kv_lora, scale=scale)
            return _combine(o, m, l).to(q_eff.dtype), pool
        ckv, live = _gathered(pool, page_table), rows[1]
    c = ckv[:, :, None, :]                                   # one kv head
    out = _dense_attend(q_eff[:, None], c, c[..., :kv_lora], live,
                        scale=scale)[:, 0]
    return out.to(q_eff.dtype), pool


# ------------------------------------------------------- per-step constants
class StepConsts(NamedTuple):
    """What every attention layer of one decode step shares: the rope
    tables of ``pos`` (cos, sin (B, width/2) f32, None without rope), the
    page and offset the new row goes to in the pools (:func:`_page_slot`;
    None without pooled layers), for each (rows, window) of the dense
    layers their :func:`_dense_rows`, and ``gathered``: None when the
    paged kernels read the pools, else (``paged_kernel=False``) the
    :func:`_dense_rows` of the pools' gathered views (T·ps rows a slot)."""
    rope: Optional[tuple]
    slot: Optional[tuple]
    dense: dict
    gathered: Optional[tuple] = None


def _uses_pool(bc: BlockCfg, page_table) -> bool:
    """Full-attention layers read the page pool when there is a table; ring
    layers always keep dense rings (``pt = None if bc.window``)."""
    return page_table is not None and not bc.window


def step_consts(cfg: ModelConfig, cache, pos, page_table,
                paged_kernel: bool = True,
                ctx=None) -> Optional[StepConsts]:
    """The per-step constants of a model's attention layers, or None when
    it has none (a pure Mamba stack): one rope width (MLA's rope dims, else the head
    dim), one page size (every pool is the engine's; on a mesh the slot is
    this rank's), and one :func:`_dense_rows` per shape of dense rows."""
    attn = [(bc, c) for bc, c in zip(block_cfgs(cfg), cache["layers"])
            if bc.mixer == "attn"]
    if not attn:
        return None
    rope = None
    if cfg.mla:
        rope = rope_tables(pos, cfg.mla.rope_dim, cfg.rope_theta)
    elif cfg.use_rope:
        rope = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    slot, dense, gathered = None, {}, None
    for bc, c in attn:
        n = next(iter(c.values())).shape[1]        # page size, or rows
        if _uses_pool(bc, page_table):
            if slot is None:
                msize, i = model_shard(ctx)
                slot = _page_slot(page_table, pos, n, i, msize)
                if not paged_kernel:
                    gathered = _dense_rows(pos, page_table.shape[1] * n, 0)
        elif (n, bc.window) not in dense:
            dense[(n, bc.window)] = _dense_rows(pos, n, bc.window)
    return StepConsts(rope, slot, dense, gathered)


# --------------------------------------------------------- per-block decode
def _gather_heads(q, k, v, ctx):
    """The ranks' heads of q (B,H/m,dh), k, v (B,Hkv/m,dh) made whole on
    every rank in one all-gather, heads in rank order."""
    B, Hl, dh = q.shape
    Hkvl = k.shape[1]
    qkv = all_gather(torch.cat([q, k, v], dim=1), 1, ctx)
    qkv = qkv.view(B, -1, Hl + 2 * Hkvl, dh)                # (B, m, ·, dh)
    q, k, v = qkv.split([Hl, Hkvl, Hkvl], dim=2)
    return (q.reshape(B, -1, dh), k.reshape(B, -1, dh),
            v.reshape(B, -1, dh))


def gqa_decode(cfg: ModelConfig, p, x, cache, pos, window: int,
               page_table, consts: StepConsts, ctx=None):
    """x (B,D) → (out (B,D), cache): the pools through ``page_table``, or
    the layer's dense rows (a ring with ``window``) without one. On a mesh
    the rank's heads are projected, gathered whole for the attention, and
    the rank's heads of its output out-projected (one all-reduce)."""
    B, D = x.shape
    H, Hkv, dh = p["wq"].shape[1], p["wk"].shape[1], cfg.head_dim
    q = (x @ p["wq"].reshape(D, -1)).view(B, H, dh)
    k = (x @ p["wk"].reshape(D, -1)).view(B, Hkv, dh)
    v = (x @ p["wv"].reshape(D, -1)).view(B, Hkv, dh)
    if cfg.use_rope:
        cos, sin = consts.rope                                  # (B, dh/2)
        q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k = apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
    msize, i = model_shard(ctx)
    if msize > 1:
        q, k, v = _gather_heads(q, k, v, ctx)
    qg = q.reshape(B, k.shape[1], -1, dh)
    rows = consts.gathered if page_table is not None else \
        consts.dense[(cache["k"].shape[1], window)]
    out, ck, cv = flash_decode_gqa(
        qg, k, v, cache["k"], cache["v"], pos, scale=dh ** -0.5,
        softcap=cfg.attn_softcap, page_table=page_table, window=window,
        slot=consts.slot, rows=rows, ctx=ctx)
    out = out.reshape(B, -1)
    if msize > 1:                          # this rank's heads of the output
        out = out[:, i * H * dh:(i + 1) * H * dh]
    return out_project(out, p["wo"], ctx), {"k": ck, "v": cv}


def mla_decode(cfg: ModelConfig, p, x, cache, pos, page_table,
               consts: StepConsts):
    """x (B,D) → (out (B,D), cache). Absorbed query ``q_c = qn · W_uk``
    in the latent space, the rope part beside it, the scale of the expanded
    form (nope + rope)^-0.5, and the un-absorb through ``W_uv``: plain
    matmuls around the paged MLA kernel."""
    m = cfg.mla
    B, D = x.shape
    H = cfg.n_heads
    cq = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"].reshape(m.q_lora, -1)).view(B, H,
                                                   m.nope_dim + m.rope_dim)
    qn, qr = q[..., :m.nope_dim], q[..., m.nope_dim:]
    cos, sin = consts.rope                                        # (B, r/2)
    qr = apply_rope(qr[:, None], cos[:, None], sin[:, None])[:, 0]
    wuk = p["wukv"][..., :m.nope_dim]                  # (kv_lora, H, nope)
    q_c = torch.einsum("bhn,rhn->bhr", qn, wuk)        # (B, H, kv_lora)
    q_eff = torch.cat([q_c, qr], dim=-1)
    ckv_t = rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    kr_t = x @ p["wkr"]
    kr_t = apply_rope(kr_t[:, None, None], cos[:, None], sin[:, None])[:, 0, 0]
    row = torch.cat([ckv_t, kr_t], dim=-1).to(cache["ckv"].dtype)
    rows = consts.gathered if page_table is not None else \
        consts.dense[(cache["ckv"].shape[1], 0)]
    o_c, ckv = flash_decode_mla(q_eff, row, cache["ckv"], pos,
                                kv_lora=m.kv_lora,
                                scale=(m.nope_dim + m.rope_dim) ** -0.5,
                                page_table=page_table, slot=consts.slot,
                                rows=rows)
    wuv = p["wukv"][..., m.nope_dim:]                  # (kv_lora, H, v)
    o = torch.einsum("bhr,rhv->bhv", o_c, wuv)
    o = o.reshape(B, H * m.v_dim) @ p["wo"].reshape(-1, D)
    return o, {"ckv": ckv}


def block_decode(cfg: ModelConfig, bc: BlockCfg, p, cache, h, pos,
                 page_table, consts: StepConsts, ctx=None):
    x = rmsnorm(h, p["norm1"], cfg.norm_eps)
    if bc.mixer == "mamba":
        y, new_cache = mamba_step(cfg, p["mamba"], x, cache)
    else:
        # only full-attention layers are paged; rings keep dense buffers
        pt = page_table if _uses_pool(bc, page_table) else None
        if cfg.mla:
            y, new_cache = mla_decode(cfg, p["attn"], x, cache, pos, pt,
                                      consts)
        else:
            y, new_cache = gqa_decode(cfg, p["attn"], x, cache, pos,
                                      bc.window, pt, consts, ctx)
    if cfg.use_post_norm:
        y = rmsnorm(y, p["post1"], cfg.norm_eps)
    h = h + y
    if bc.ffn != "none":
        x = rmsnorm(h, p["norm2"], cfg.norm_eps)
        y = moe_decode(cfg, p["moe"], x, ctx) if bc.ffn == "moe" else \
            mlp(cfg, p["mlp"], x, ctx)
        if cfg.use_post_norm:
            y = rmsnorm(y, p["post2"], cfg.norm_eps)
        h = h + y
    return h, new_cache


# ------------------------------------------------------------- decode step
def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                page_table=None, paged_kernel: bool = True, ctx=None):
    """tokens (B,), pos (B,) int32 → (logits (B,V) f32, cache). The page
    pools and dense rows of ``cache`` are updated in place; Mamba states
    are replaced. ``page_table`` (B,T) int32 addresses the pools of a paged
    cache (read by the paged kernels, or with ``paged_kernel=False`` as
    gathered views); None for the dense engine's. ``ctx``: the mesh, whose
    ranks hold their blocks of ``params`` and their offsets of the pools
    (the logits come out whole on every rank)."""
    if model_shard(ctx)[0] > 1 and (page_table is None or not paged_kernel):
        raise ValueError("a sharded decode reads page pools through the "
                         "paged kernel (page_table given, paged_kernel=True)")
    h = embed(cfg, params["embed"], tokens, ctx=ctx)
    consts = step_consts(cfg, cache, pos, page_table, paged_kernel, ctx)
    layers = []
    for bc, p, c in zip(block_cfgs(cfg), params["layers"], cache["layers"]):
        h, c = block_decode(cfg, bc, p, c, h, pos, page_table, consts, ctx)
        layers.append(c)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(cfg, params["embed"], params["unembed"], h, ctx)
    return logits, {"layers": layers}


# ---------------------------------------------------- whisper decode step
def whisper_decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """tokens (B,), pos (B,) int → (logits (B,V) f32, cache): one decoder
    step against each layer's self rows (written in place at ``pos``; a
    ``pos`` at or past ``max_decoder_len`` writes nothing and every row is
    live) and its prefilled cross K/V (every encoder row live, nothing
    written); ``dec_pos`` is read at ``pos`` clipped to its rows."""
    B = tokens.shape[0]
    H, Hkv, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    h = params["embed"]["table"][tokens].to(cfg.pdtype) + \
        params["dec_pos"][pos.long().clamp(0, cfg.max_decoder_len - 1)]
    first = cache["dec_layers"][0]
    S, Se = first["k"].shape[1], first["xk"].shape[1]
    consts = StepConsts(None, None, {(S, 0): _dense_rows(pos, S, 0)})
    cross_rows = (None, torch.ones((B, Se), dtype=torch.bool,
                                   device=h.device))
    layers = []
    for p, c in zip(params["dec_layers"], cache["dec_layers"]):
        x = rmsnorm(h, p["norm1"], cfg.norm_eps)
        o, sc = gqa_decode(cfg, p["self_attn"], x, c, pos, 0, None, consts)
        h = h + o
        x = rmsnorm(h, p["norm_x"], cfg.norm_eps)
        q = (x @ p["cross"]["wq"].reshape(D, -1)).view(B, Hkv, H // Hkv, dh)
        o, _, _ = flash_decode_gqa(q, None, None, c["xk"], c["xv"], pos,
                                   scale=dh ** -0.5, softcap=0.0,
                                   rows=cross_rows, update=False)
        h = h + o.reshape(B, -1) @ p["cross"]["wo"].reshape(-1, D)
        x = rmsnorm(h, p["norm2"], cfg.norm_eps)
        h = h + mlp(cfg, p["mlp"], x[:, None])[:, 0]
        layers.append({**sc, "xk": c["xk"], "xv": c["xv"]})
    h = rmsnorm(h, params["dec_norm"], cfg.norm_eps)
    logits = logits_fn(cfg, params["embed"], params["unembed"], h)
    return logits, {"dec_layers": layers}


def serve_step_fn(cfg: ModelConfig):
    """The decode entry of ``cfg``: ``step(params, cache, tokens, pos)`` →
    :func:`whisper_decode_step` for an encoder-decoder, else
    :func:`decode_step` on a dense cache."""
    fn = whisper_decode_step if cfg.enc_dec else decode_step

    def step(params, cache, tokens, pos):
        return fn(cfg, params, cache, tokens, pos)
    return step


# ------------------------------------------------------ fused decode loop
def _filter_logits(logits, *, temperature: float, top_k: int,
                   top_p: float = 0.0):
    """Temperature / top-k / nucleus (top-p) filtering → f32 logits with the
    truncated entries at NEG. ``temperature`` must be > 0 here."""
    lg = logits.to(F32) / temperature
    # NEG as a scalar: no host-to-device copy, which graph capture forbids
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, NEG, lg)
    if top_p and top_p < 1.0:
        probs = torch.softmax(lg, dim=-1)
        srt = torch.sort(probs, dim=-1, descending=True).values
        csum = torch.cumsum(srt, dim=-1)
        # smallest prefix whose mass reaches top_p; (csum - srt) is the mass
        # before each entry, so the count is always ≥ 1
        n_keep = torch.sum((csum - srt < top_p).to(torch.int64), dim=-1,
                           keepdim=True)
        thr = torch.gather(srt, -1, n_keep - 1)
        lg = torch.where(probs < thr, NEG, lg)
    return lg


def _sample_tokens(logits, generator, *, temperature: float, top_k: int,
                   top_p: float = 0.0):
    """Next token on the device: greedy argmax at ``temperature == 0``;
    otherwise a categorical over the filtered logits by the Gumbel-max rule
    (as ``jax.random.categorical``), noise drawn from ``generator``."""
    if not temperature:
        return torch.argmax(logits, -1).to(torch.int32)
    return _gumbel_argmax(_filter_logits(logits, temperature=temperature,
                                         top_k=top_k, top_p=top_p),
                          generator)


def _gumbel_argmax(lg, generator):
    """A categorical draw over the last axis of the f32 log-weights ``lg``
    by the Gumbel-max rule (as ``jax.random.categorical``): no host read,
    noise from ``generator`` (advanced alike in a graph's replay)."""
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(F32).tiny)))
    return torch.argmax(lg + gumbel, -1).to(torch.int32)


def decode_loop(cfg: ModelConfig, params, cache, tokens, pos, active,
                remaining, *, num_steps: int, eos_id: int, max_len: int,
                page_table, temperature: float = 0.0, top_k: int = 0,
                top_p: float = 0.0, generator=None,
                paged_kernel: bool = True, ctx=None):
    """A quantum of ``num_steps`` decode steps with on-device sampling and
    per-slot done masking; nothing is read back to the host
    (``paged_kernel`` and ``ctx`` as in :func:`decode_step`; on a mesh
    every rank samples from the same whole logits with a generator seeded
    alike, so every rank emits the same tokens).

    A slot emits while ``active``; it deactivates when its budget
    (``remaining``) drains, it samples ``eos_id``, or its write position
    reaches ``max_len - 1``. Inactive slots still run (fixed batch) but
    their emissions are masked and their state frozen.

    Returns ((cache, tokens, pos, active, remaining),
             emitted (num_steps, B) int32, emitted_mask (num_steps, B) bool).
    """
    toks, msks = [], []
    for _ in range(num_steps):
        logits, cache = decode_step(cfg, params, cache, tokens, pos,
                                    page_table, paged_kernel, ctx)
        nxt = _sample_tokens(logits, generator, temperature=temperature,
                             top_k=top_k, top_p=top_p)
        toks.append(torch.where(active, nxt, -1))
        msks.append(active)
        remaining = remaining - active.to(remaining.dtype)
        pos = pos + active.to(pos.dtype)
        still = active & (remaining > 0) & (nxt != eos_id) & \
            (pos < max_len - 1)
        tokens = torch.where(still, nxt, tokens)
        active = still
    carry = (cache, tokens, pos, active, remaining)
    return carry, torch.stack(toks), torch.stack(msks)


def _pack(active, toks, msks):
    """One (2·num_steps + 1, B) int32 array — emitted tokens, emission masks,
    then the post-quantum ``active`` — so a quantum costs one host read."""
    return torch.cat([toks.to(torch.int32), msks.to(torch.int32),
                      active[None].to(torch.int32)], dim=0)


def decode_quantum(cfg: ModelConfig, params, cache, tokens, pos, active,
                   remaining, page_table, packed, *, num_steps: int,
                   eos_id: int, max_len: int, temperature: float = 0.0,
                   top_k: int = 0, top_p: float = 0.0, generator=None,
                   paged_kernel: bool = True, ctx=None):
    """:func:`decode_loop` IN PLACE (on a mesh each rank's own blocks and
    offsets, ``ctx``): the carry goes back into ``tokens``,
    ``pos``, ``active`` and ``remaining``, each Mamba layer's new state
    into the state tensors of ``cache`` (the page pools are written in
    place as the loop runs), and the packed result (:func:`_pack`) into
    ``packed`` (2·num_steps + 1, B) int32. Every tensor it reads or writes
    is one it was given, so a CUDA graph of a call replays on the same
    storage; the values are decode_loop's, bit for bit."""
    carry, toks, msks = decode_loop(
        cfg, params, cache, tokens, pos, active, remaining,
        num_steps=num_steps, eos_id=eos_id, max_len=max_len,
        page_table=page_table, temperature=temperature, top_k=top_k,
        top_p=top_p, generator=generator, paged_kernel=paged_kernel,
        ctx=ctx)
    new_cache, new_tokens, new_pos, new_active, new_remaining = carry
    for layer, new in zip(cache["layers"], new_cache["layers"]):
        for name, t in new.items():
            if t is not layer[name]:           # Mamba state; pools alias
                layer[name].copy_(t)
    packed.copy_(_pack(new_active, toks, msks))
    for dst, src in ((tokens, new_tokens), (pos, new_pos),
                     (active, new_active), (remaining, new_remaining)):
        dst.copy_(src)


# ------------------------------------------------ speculative decode: verify
def _merge_partials(o1, m1, l1, o2, m2, l2):
    """Online-softmax merge of two unnormalized (o, m, l) partial triples
    (o = Σ e^{s-m}·v, l = Σ e^{s-m}); an empty one (m = NEG, l = 0, o = 0)
    adds nothing. :func:`_combine` normalizes the result."""
    m = torch.maximum(m1, m2)
    m_safe = torch.where(m <= NEG / 2, 0.0, m)
    c1 = torch.exp(torch.where(m1 <= NEG / 2, NEG, m1) - m_safe)
    c2 = torch.exp(torch.where(m2 <= NEG / 2, NEG, m2) - m_safe)
    return o1 * c1[..., None] + o2 * c2[..., None], m, l1 * c1 + l2 * c2


def _causal(K: int, device):
    """(Kq, Kk) bool: verify query j sees staged rows j' <= j."""
    return torch.ones((K, K), dtype=torch.bool, device=device).tril()


def _masked_partials(s, keep, v, eq: str):
    """(o, m, l) of scores ``s`` (…, keys) where ``keep`` (broadcast to
    ``s``), values ``v`` contracted by einsum ``eq``; all f32."""
    s = torch.where(keep, s, NEG)
    m = torch.amax(s, -1)
    m_safe = torch.where(m <= NEG / 2, 0.0, m)
    p = torch.where(keep, torch.exp(s - m_safe[..., None]), 0.0)
    return torch.einsum(eq, p, v), m, torch.sum(p, -1)


def _verify_rows(pos0, S: int, window: int, K: int):
    """(B, K, S) bool: the committed dense rows each verify query of a layer
    of S rows per slot sees. Full rows: positions < pos0. A ring (window)
    is anchored at the last committed position pos0 - 1: slot j holds
    ``p_j = (pos0-1) - ((pos0-1 - j) mod S)``, seen while ``p_j >= 0`` and
    inside query (pos0 + k)'s window; K <= window keeps every staged row
    inside every query's window."""
    gpos = torch.arange(S, device=pos0.device)
    p0 = pos0.long()[:, None]
    if window:
        anchor = p0 - 1
        p_j = anchor - torch.remainder(anchor - gpos[None], S)   # (B, S)
        qpos = p0 + torch.arange(K, device=pos0.device)[None]    # (B, K)
        return (p_j >= 0)[:, None, :] & \
            (p_j[:, None, :] > qpos[:, :, None] - window)
    return (gpos[None] < p0)[:, None, :].expand(-1, K, -1)


class VerifyConsts(NamedTuple):
    """What every attention layer of one verify pass shares: the rope tables
    of positions ``pos0 + j`` (cos, sin (B, K, width/2) f32, None without
    rope), for each (rows, window) of the dense layers their
    :func:`_verify_rows`, and ``gathered`` as in :class:`StepConsts`: None
    for the paged kernels, else the :func:`_verify_rows` of the pools'
    gathered views."""
    rope: Optional[tuple]
    dense: dict
    gathered: Optional[torch.Tensor] = None


def verify_consts(cfg: ModelConfig, cache, pos0, K: int, page_table,
                  paged_kernel: bool = True) -> Optional[VerifyConsts]:
    """The verify constants of a model's attention layers (None for a model
    without attention): :func:`step_consts` for K positions."""
    attn = [(bc, c) for bc, c in zip(block_cfgs(cfg), cache["layers"])
            if bc.mixer == "attn"]
    if not attn:
        return None
    qpos = pos0[:, None] + torch.arange(K, device=pos0.device)[None]
    rope = None
    if cfg.mla:
        rope = rope_tables(qpos, cfg.mla.rope_dim, cfg.rope_theta)
    elif cfg.use_rope:
        rope = rope_tables(qpos, cfg.head_dim, cfg.rope_theta)
    dense, gathered = {}, None
    for bc, c in attn:
        n = next(iter(c.values())).shape[1]
        if _uses_pool(bc, page_table):
            if not paged_kernel and gathered is None:
                gathered = _verify_rows(pos0, page_table.shape[1] * n, 0, K)
        elif (n, bc.window) not in dense:
            dense[(n, bc.window)] = _verify_rows(pos0, n, bc.window, K)
    return VerifyConsts(rope, dense, gathered)


def _repeat_rows(page_table, pos0, K: int):
    """The paged kernels' rows of a verify: each slot's table repeated K
    times and its last committed position ``pos0 - 1`` (kernel validity is
    ``gpos <= pos``: the committed history only). A slot never filled
    passes -1, which the kernels read as an empty row."""
    B, T = page_table.shape
    return (page_table[:, None].expand(B, K, T).reshape(B * K, T).contiguous(),
            (pos0 - 1)[:, None].expand(B, K).reshape(B * K).contiguous())


def flash_verify_gqa(q, k_new, v_new, ck, cv, pos0, *, window: int,
                     scale: float, softcap: float, page_table=None,
                     valid=None):
    """Batched K-token verify attention. q (B,K,Hkv,G,dh); k_new/v_new
    (B,K,Hkv,dh) the staged rows of positions pos0..pos0+K-1; ck/cv the
    cache as the last commit left it, READ-ONLY here; pos0 (B,) → out
    (B,K,Hkv,G,dh). Query j sees the committed history and the staged rows
    j' <= j, which is what the serial loop's write-then-attend sees.

    With ``page_table`` (B,T) int32 the cache is the pools and the history
    comes from the paged kernel on the (B·K, Hkv, G, dh) queries
    (:func:`_repeat_rows`), or, when ``valid`` is given (the gathered
    decode, :class:`VerifyConsts`), from the gathered pages
    (:func:`_gathered`, ``valid`` their rows ``< pos0``) in plain torch;
    without, from dense rows (a ring with ``window``) in plain
    torch, ``valid`` their :func:`_verify_rows`. The
    staged K×K block's partials come from a plain einsum (JAX's; no TPU
    kernel computes it) and are merged with the history's."""
    B, K, hkv, grp, dh = q.shape
    if window and K > window:
        raise ValueError(f"verify block K={K} exceeds window={window}")
    qf = q.to(F32) * scale
    s2 = torch.einsum("bkhgd,bjhd->bhgkj", qf, k_new.to(F32))
    if softcap:
        s2 = torch.tanh(s2 / softcap) * softcap
    staged = _masked_partials(s2, _causal(K, q.device), v_new.to(F32),
                              "bhgkj,bjhd->bhgkd")
    if page_table is not None:
        _check_paged_args(page_table, pos0, window=window)
        if valid is not None:         # gathered: the dense branch reads it
            ck, cv = _gathered(ck, page_table), _gathered(cv, page_table)
            page_table = None
    if page_table is not None:
        ptf, posf = _repeat_rows(page_table, pos0, K)
        o, m, l = paged_ops.paged_attend_gqa(
            q.reshape(B * K, hkv, grp, dh).contiguous(), ck, cv, ptf, posf,
            0, page_size=ck.shape[1], scale=scale, softcap=softcap)
        hist = (o.view(B, K, hkv, grp, dh).permute(0, 2, 3, 1, 4),
                m.view(B, K, hkv, grp).permute(0, 2, 3, 1),
                l.view(B, K, hkv, grp).permute(0, 2, 3, 1))
    else:
        s = torch.einsum("bkhgd,bshd->bhgks", qf, ck.to(F32))
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        hist = _masked_partials(s, valid[:, None, None], cv.to(F32),
                                "bhgks,bshd->bhgkd")
    out = _combine(*_merge_partials(*hist, *staged))      # (B,Hkv,G,K,dh)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def flash_verify_mla(q_eff, new_rows, ckv, pos0, *, kv_lora: int,
                     scale: float, page_table=None, valid=None):
    """MLA analogue of :func:`flash_verify_gqa`: q_eff (B,K,H,R); new_rows
    (B,K,R) the staged latent rows; ckv the (N,ps,R) pool with
    ``page_table`` (read by the paged kernel, or gathered when ``valid``
    is given), else dense rows (B,S,R) and ``valid`` their
    :func:`_verify_rows` → out (B,K,H,kv_lora). Read-only; full attention
    only."""
    B, K, H, R = q_eff.shape
    qf = q_eff.to(F32) * scale
    rows = new_rows.to(F32)
    s2 = torch.einsum("bkhr,bjr->bhkj", qf, rows)
    staged = _masked_partials(s2, _causal(K, q_eff.device),
                              rows[..., :kv_lora], "bhkj,bjr->bhkr")
    if page_table is not None:
        _check_paged_args(page_table, pos0)
        if valid is not None:         # gathered: the dense branch reads it
            ckv, page_table = _gathered(ckv, page_table), None
    if page_table is not None:
        ptf, posf = _repeat_rows(page_table, pos0, K)
        o, m, l = paged_ops.paged_attend_mla(
            q_eff.reshape(B * K, H, R).contiguous(), ckv, ptf, posf, 0,
            page_size=ckv.shape[1], kv_lora=kv_lora, scale=scale)
        hist = (o.view(B, K, H, kv_lora).permute(0, 2, 1, 3),
                m.view(B, K, H).permute(0, 2, 1),
                l.view(B, K, H).permute(0, 2, 1))
    else:
        s = torch.einsum("bkhr,bsr->bhks", qf, ckv.to(F32))
        hist = _masked_partials(s, valid[:, None], ckv[..., :kv_lora].to(F32),
                                "bhks,bsr->bhkr")
    out = _combine(*_merge_partials(*hist, *staged))      # (B,H,K,kv_lora)
    return out.permute(0, 2, 1, 3).to(q_eff.dtype)


def gqa_verify(cfg: ModelConfig, p, x, cache, pos0, window: int,
               page_table, consts: VerifyConsts):
    """x (B,K,D) → (out (B,K,D), staged {"k","v"} rows (B,K,Hkv,dh))."""
    B, K, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].reshape(D, -1)).view(B, K, H, dh)
    k = (x @ p["wk"].reshape(D, -1)).view(B, K, Hkv, dh)
    v = (x @ p["wv"].reshape(D, -1)).view(B, K, Hkv, dh)
    if cfg.use_rope:
        cos, sin = consts.rope                                # (B, K, dh/2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    valid = consts.gathered if page_table is not None else \
        consts.dense[(cache["k"].shape[1], window)]
    out = flash_verify_gqa(
        q.reshape(B, K, Hkv, H // Hkv, dh), k, v, cache["k"], cache["v"],
        pos0, window=window, scale=dh ** -0.5, softcap=cfg.attn_softcap,
        page_table=page_table, valid=valid)
    o = out.reshape(B, K, H * dh) @ p["wo"].reshape(-1, D)
    return o, {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}


def mla_verify(cfg: ModelConfig, p, x, cache, pos0, page_table,
               consts: VerifyConsts):
    """x (B,K,D) → (out (B,K,D), staged {"ckv"} latent rows (B,K,R)), the
    absorbed form of :func:`mla_decode` for K positions."""
    m = cfg.mla
    B, K, D = x.shape
    H = cfg.n_heads
    cq = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"].reshape(m.q_lora, -1)).view(B, K, H,
                                                   m.nope_dim + m.rope_dim)
    qn, qr = q[..., :m.nope_dim], q[..., m.nope_dim:]
    cos, sin = consts.rope                                     # (B, K, r/2)
    qr = apply_rope(qr, cos, sin)
    q_c = torch.einsum("bkhn,rhn->bkhr", qn, p["wukv"][..., :m.nope_dim])
    q_eff = torch.cat([q_c, qr], dim=-1)
    ckv_t = rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    kr_t = apply_rope((x @ p["wkr"])[:, :, None], cos, sin)[:, :, 0]
    rows = torch.cat([ckv_t, kr_t], dim=-1).to(cache["ckv"].dtype)
    valid = consts.gathered if page_table is not None else \
        consts.dense[(cache["ckv"].shape[1], 0)]
    o_c = flash_verify_mla(q_eff, rows, cache["ckv"], pos0,
                           kv_lora=m.kv_lora,
                           scale=(m.nope_dim + m.rope_dim) ** -0.5,
                           page_table=page_table, valid=valid)
    o = torch.einsum("bkhr,rhv->bkhv", o_c, p["wukv"][..., m.nope_dim:])
    o = o.reshape(B, K, H * m.v_dim) @ p["wo"].reshape(-1, D)
    return o, {"ckv": rows}


def block_verify(cfg: ModelConfig, bc: BlockCfg, p, cache, h, pos0,
                 page_table, consts: VerifyConsts):
    """h (B,K,D) → (h', staged). Attention layers stage their K new rows;
    a Mamba layer steps ``mamba_step`` over the K inputs in order (a state
    scan is serial: verify batches only the attention and FFN work) and
    stages the K states, leaves (K, B, …): Mamba-2's conv tails and SSM
    state, or Mamba-1's conv tail and its f32 (B, C, N) state."""
    x = rmsnorm(h, p["norm1"], cfg.norm_eps)
    if bc.mixer == "mamba":
        ys, states = [], []
        state = cache
        for j in range(x.shape[1]):
            y, state = mamba_step(cfg, p["mamba"], x[:, j], state)
            ys.append(y)
            states.append(state)
        staged = {name: torch.stack([s[name] for s in states])
                  for name in cache}
        y = torch.stack(ys, 1)
    else:
        pt = page_table if _uses_pool(bc, page_table) else None
        if cfg.mla:
            y, staged = mla_verify(cfg, p["attn"], x, cache, pos0, pt,
                                   consts)
        else:
            y, staged = gqa_verify(cfg, p["attn"], x, cache, pos0, bc.window,
                                   pt, consts)
    if cfg.use_post_norm:
        y = rmsnorm(y, p["post1"], cfg.norm_eps)
    h = h + y
    if bc.ffn != "none":
        x = rmsnorm(h, p["norm2"], cfg.norm_eps)
        if bc.ffn == "moe":
            B, K, D = x.shape
            y = moe_decode(cfg, p["moe"], x.reshape(B * K, D)).reshape(B, K,
                                                                      D)
        else:
            y = mlp(cfg, p["mlp"], x)
        if cfg.use_post_norm:
            y = rmsnorm(y, p["post2"], cfg.norm_eps)
        h = h + y
    return h, staged


def decode_verify(cfg: ModelConfig, params, cache, tokens, pos0,
                  page_table=None, paged_kernel: bool = True):
    """The verify pass of speculative decode. tokens (B,K) = [last committed
    token, proposals g_1..g_{K-1}]; pos0 (B,) int32 the write position of
    tokens[:, 0] → (logits (B,K,V) f32, staged {"layers": [...]}).
    logits[:, j] is the target's next-token distribution after
    tokens[:, :j+1]: what K serial :func:`decode_step`s give, in one
    batched pass. The cache is read-only; :func:`decode_commit` writes the
    accepted prefix. ``paged_kernel`` as in :func:`decode_step`."""
    h = embed(cfg, params["embed"], tokens)
    consts = verify_consts(cfg, cache, pos0, tokens.shape[1], page_table,
                           paged_kernel)
    staged = []
    for bc, p, c in zip(block_cfgs(cfg), params["layers"], cache["layers"]):
        h, s = block_verify(cfg, bc, p, c, h, pos0, page_table, consts)
        staged.append(s)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(cfg, params["embed"], params["unembed"], h)
    return logits, {"layers": staged}


# ------------------------------------------------ speculative decode: commit
def _commit_slot(page_table, pos0, n, K: int, ps: int):
    """(page, offset) int64 (K·B,), j-major, where staged row j of each slot
    lands in the pools: position pos0 + j for j < n, else the trash page 0
    (as a frozen slot's scribble, :func:`_page_slot`). Computed once per
    round for every pooled leaf."""
    B, T = page_table.shape
    j = torch.arange(K, device=pos0.device)[:, None]
    pos = torch.where(j < n[None], pos0[None] + j, T * ps)        # (K, B)
    return _page_slot(page_table[None].expand(K, B, T).reshape(K * B, T),
                      pos.reshape(K * B), ps)


def commit_rows(cache, rows, pos0, n, *, window: int = 0, page_table=None,
                slot=None):
    """Write the accepted prefix of staged ``rows`` (B,K,…) into one
    attention cache leaf IN PLACE: row j lands at position pos0 + j for
    j < n (B,). A paged leaf (``page_table`` (B,T)) takes the K rows of
    every slot in one ``index_put_`` at ``slot`` (:func:`_commit_slot`),
    a rejected row (j >= n) sent to the trash page 0: the K serial
    :func:`_paged_write`s of JAX's loop, in their order. Dense leaves take
    K :func:`_local_write`s (ring slot (pos0 + j) mod S with ``window``), a
    rejected row at ``rel = -1``, which writes nothing. Returns the leaf."""
    B, K = rows.shape[:2]
    if page_table is not None:
        _check_paged_args(page_table, pos0, window=window)
        if slot is None:
            slot = _commit_slot(page_table, pos0, n, K, cache.shape[1])
        cache.index_put_(slot, rows.transpose(0, 1).reshape(
            (K * B,) + tuple(rows.shape[2:])).to(cache.dtype))
        return cache
    S = cache.shape[1]
    for j in range(K):
        wpos = pos0 + j
        if window:
            wpos = torch.remainder(wpos, S)
        _local_write(cache, rows[:, j], torch.where(j < n, wpos, -1))
    return cache


def _commit_scan_state(cache, states, n):
    """A Mamba layer's leaves, IN PLACE (Mamba-2: ``conv_x``, ``conv_B``,
    ``conv_C``, ``ssm``; Mamba-1: ``conv_x``, ``ssm``): ``states`` (K,B,…)
    are the K states staged by :func:`block_verify`; each slot keeps state
    n-1 (n = 0: the state before the verify)."""
    b = torch.arange(n.shape[0], device=n.device)
    for name, c in cache.items():
        full = torch.cat([c[None], states[name].to(c.dtype)])
        c.copy_(full[n.long(), b])
    return cache


def block_commit(cfg: ModelConfig, bc: BlockCfg, cache, staged, pos0, n,
                 page_table=None, slot=None):
    if bc.mixer == "mamba":
        return _commit_scan_state(cache, staged, n)
    pt = page_table if _uses_pool(bc, page_table) else None
    return {name: commit_rows(cache[name], staged[name], pos0, n,
                              window=bc.window, page_table=pt,
                              slot=slot if pt is not None else None)
            for name in cache}


def decode_commit(cfg: ModelConfig, cache, staged, pos0, n,
                  page_table=None):
    """The commit half of the verify/commit split, IN PLACE: write the
    first n (B,) staged rows and states into the cache. Positions
    pos0..pos0+n-1 receive the K/V of the accepted verify *inputs*; the
    correction token is not written: it is the next round's tokens[:, 0],
    staged and committed by the next verify. The pools' (page, offset)
    of the K rows is computed once for every pooled layer."""
    slot = None
    for bc, c, s in zip(block_cfgs(cfg), cache["layers"], staged["layers"]):
        if _uses_pool(bc, page_table) and bc.mixer == "attn":
            leaf = next(iter(c.values()))
            slot = _commit_slot(page_table, pos0, n,
                                next(iter(s.values())).shape[1],
                                leaf.shape[1])
            break
    return {"layers": [
        block_commit(cfg, bc, c, s, pos0, n, page_table, slot)
        for bc, c, s in zip(block_cfgs(cfg), cache["layers"],
                            staged["layers"])]}


# --------------------------------------------------- acceptance / emission
def spec_candidates(proposals, corrections, accept, active, remaining,
                    pos0, *, eos_id: int, max_len: int):
    """The emission law of one speculative round, in int32 on the device.

    proposals (B,k): draft tokens g_1..g_k. corrections (B,k+1): the
    target's fallback token at each acceptance depth (argmax in greedy
    mode, residual or bonus draw otherwise; index k is the bonus). accept
    (B,k): the verdict on each proposal. active/remaining/pos0 (B,): the
    slot state entering the round.

    Returns (cand (B,K), emit (B,K) bool, n (B,), m (B,)) with K = k+1:
    m = the accepted prefix Σ cumprod(accept); cand[j] = g_{j+1} for j < m,
    else corrections[m]; emit marks the emitted prefix after the EOS,
    budget and max_len cuts: the tokens the serial loop would emit over
    its next n = Σ emit steps (its still-active law applied cumulatively),
    which makes greedy speculative decode token-identical to target-only
    decode."""
    i32 = torch.int32
    B, k = proposals.shape
    K = k + 1
    m = torch.cumprod(accept.to(i32), 1, dtype=i32).sum(1, dtype=i32)
    x = corrections.gather(1, m[:, None].long())[:, 0]
    g_pad = torch.cat([proposals, proposals.new_zeros((B, 1))], 1)
    jj = torch.arange(K, dtype=i32, device=proposals.device)[None]
    cand = torch.where(jj < m[:, None], g_pad, x[:, None]).to(i32)
    prev = torch.cat([torch.full((B, 1), -1, dtype=i32, device=cand.device),
                      cand[:, :-1]], 1)
    cond = (jj <= m[:, None]) & (prev != eos_id) & \
        (remaining[:, None] > jj) & (pos0[:, None] + jj < max_len - 1)
    # the first token is the serial loop's unconditional step: an active
    # slot always emits at least one token a round
    cond = torch.cat([torch.ones_like(cond[:, :1]), cond[:, 1:]], 1)
    emit = active[:, None] & (torch.cumprod(cond.to(i32), 1, dtype=i32) > 0)
    n = emit.sum(1, dtype=i32)
    return cand, emit, n, m


# ------------------------------------------------- the speculative quantum
def spec_decode_loop(cfg: ModelConfig, draft_cfg: ModelConfig, params,
                     draft_params, cache, draft_cache, tokens, pos, active,
                     remaining, *, spec_k: int, num_steps: int, eos_id: int,
                     max_len: int, page_table=None, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 0.0, generator=None,
                     paged_kernel: bool = True):
    """A speculative quantum of ``num_steps`` rounds, each ``spec_k`` serial
    draft steps and ONE batched target verify, emitting 1 to spec_k + 1
    tokens a slot; nothing is read back to the host.

    Greedy (temperature 0): a proposal is accepted iff it equals the
    target's argmax at its depth, and the corrections are the argmaxes, so
    the stream is token-identical to :func:`decode_loop`'s. Sampled:
    rejection sampling against the filtered (temperature, top-k, top-p)
    distributions p and q: accept g iff ``u·q(g) < p(g)``; on the first
    rejection at depth i draw from ``norm(max(p_i - q_i, 0))`` (p_i where
    p_i ≡ q_i); after k acceptances draw the bonus token from p_k. Every
    draw (Gumbel-max, and the uniforms u) comes from ``generator``, in one
    order, so a graph's replay draws as the eager run does.

    The draft writes its dense cache optimistically at pos..pos+k-1; a row
    past the accepted prefix is stale, but the draft is full attention on
    dense rows (validity ``gpos <= pos``), so the next round's step at that
    position overwrites it before any query sees it. The target's cache is
    read-only in the verify; :func:`decode_commit` writes exactly the
    accepted prefix. The pools, the dense rows and the Mamba states are all
    written in place. ``paged_kernel`` as in :func:`decode_step` (the
    draft reads no page table).

    Returns ((cache, draft_cache, tokens, pos, active, remaining), toks,
    msks, acc): toks/msks (num_steps, K, B) in emission order, acc
    (num_steps, B) the accepted proposals of each active round."""
    K = spec_k + 1
    fkw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    toks, msks, accs = [], [], []
    for _ in range(num_steps):
        dtok, dpos = tokens, pos
        gs, qs = [], []
        for _ in range(spec_k):
            dlogits, draft_cache = decode_step(draft_cfg, draft_params,
                                               draft_cache, dtok, dpos)
            if temperature:
                fl = _filter_logits(dlogits, **fkw)
                g = _gumbel_argmax(fl, generator)
                qs.append(torch.softmax(fl, -1))
            else:
                g = torch.argmax(dlogits, -1).to(torch.int32)
            gs.append(g)
            dtok, dpos = g, dpos + 1
        gT = torch.stack(gs, 1)                                 # (B, k)
        logits, staged = decode_verify(
            cfg, params, cache, torch.cat([tokens[:, None], gT], 1), pos,
            page_table, paged_kernel)
        if temperature:
            pp = torch.softmax(_filter_logits(logits, **fkw), -1)  # (B,K,V)
            qT = torch.stack(qs, 1)                             # (B, k, V)
            gi = gT.long()[..., None]
            p_at = pp[:, :spec_k].gather(-1, gi)[..., 0]
            q_at = qT.gather(-1, gi)[..., 0]
            u = torch.rand(gT.shape, generator=generator, device=gT.device)
            accept = u * q_at < p_at             # u < p/q without the divide
            r = torch.clamp(pp[:, :spec_k] - qT, min=0.0)
            r = torch.where(r.sum(-1, keepdim=True) > 0.0, r,
                            pp[:, :spec_k])               # p ≡ q → use p
            resid = torch.cat([r, pp[:, spec_k:]], 1)
            corrections = _gumbel_argmax(torch.log(resid + 1e-30), generator)
        else:
            corrections = torch.argmax(logits, -1).to(torch.int32)
            accept = gT == corrections[:, :spec_k]
        cand, emit, n, m = spec_candidates(gT, corrections, accept, active,
                                           remaining, pos, eos_id=eos_id,
                                           max_len=max_len)
        cache = decode_commit(cfg, cache, staged, pos, n, page_table)
        toks.append(torch.where(emit, cand, -1).T)
        msks.append(emit.T)
        accs.append(torch.where(active, m, 0))
        remaining = remaining - n.to(remaining.dtype)
        pos = pos + n.to(pos.dtype)
        last = cand.gather(1, torch.clamp(n - 1, min=0).long()[:, None])[:, 0]
        still = active & (remaining > 0) & (last != eos_id) & \
            (pos < max_len - 1)
        tokens = torch.where(still, last, tokens)
        active = still
    carry = (cache, draft_cache, tokens, pos, active, remaining)
    return carry, torch.stack(toks), torch.stack(msks), torch.stack(accs)


def _pack_spec(active, toks, msks, acc):
    """One (2·N·K + N + 1, B) int32 array — emitted tokens and emission
    masks (round-major, in emission order), the accepted proposals of each
    round, then the post-quantum ``active`` — so a speculative quantum
    costs one host read too."""
    NK = toks.shape[0] * toks.shape[1]
    B = active.shape[0]
    return torch.cat([toks.reshape(NK, B).to(torch.int32),
                      msks.reshape(NK, B).to(torch.int32),
                      acc.to(torch.int32), active[None].to(torch.int32)])


def spec_decode_quantum(cfg: ModelConfig, draft_cfg: ModelConfig, params,
                        draft_params, cache, draft_cache, tokens, pos, active,
                        remaining, page_table, packed, *, spec_k: int,
                        num_steps: int, eos_id: int, max_len: int,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 0.0, generator=None,
                        paged_kernel: bool = True):
    """:func:`spec_decode_loop` IN PLACE, as :func:`decode_quantum` is for
    :func:`decode_loop`: the carry goes back into ``tokens``, ``pos``,
    ``active`` and ``remaining``, and the packed result (:func:`_pack_spec`)
    into ``packed`` (2·num_steps·(spec_k+1) + num_steps + 1, B) int32. The
    pools, the target's and the draft's dense rows and the target's
    Mamba states are written in place as the loop runs, so a CUDA graph
    of a call replays on the same storage; the values are the loop's, bit
    for bit."""
    carry, toks, msks, acc = spec_decode_loop(
        cfg, draft_cfg, params, draft_params, cache, draft_cache, tokens,
        pos, active, remaining, spec_k=spec_k, num_steps=num_steps,
        eos_id=eos_id, max_len=max_len, page_table=page_table,
        temperature=temperature, top_k=top_k, top_p=top_p,
        generator=generator, paged_kernel=paged_kernel)
    _, _, new_tokens, new_pos, new_active, new_remaining = carry
    packed.copy_(_pack_spec(new_active, toks, msks, acc))
    for dst, src in ((tokens, new_tokens), (pos, new_pos),
                     (active, new_active), (remaining, new_remaining)):
        dst.copy_(src)


# --------------------------------------------------- resume-from-emitted
def plan_resume(prompt, out, max_new: int, eos_id: int = -1):
    """Retry law for a stream reclaimed from a failed tier
    (``repro/serve/decode.py::plan_resume``).

    Returns ``(resume_prompt, remaining_new)``, the prompt to re-prefill
    and the decode budget left, or ``None`` when the stream is already
    terminal (budget spent, or the last emitted token is EOS) and needs no
    retry.

    Greedy recovery is token-identical: the emitted prefix came from causal
    decoding, so the distribution of token ``len(out) + 1`` depends only on
    ``prompt + out``, exactly the context a fresh prefill of
    ``resume_prompt`` scores. The failed tier's cache is not trusted; the
    context is rebuilt from the tokens the host already holds. Sampled
    traffic resumes by the same law but not with the same draws.
    """
    emitted = len(out)
    if emitted >= max_new:
        return None                       # budget already spent
    if eos_id >= 0 and emitted and out[-1] == eos_id:
        return None                       # stream ended at EOS
    return list(prompt) + list(out), max_new - emitted
