"""Single-token decode and the fused decode quantum
(``repro/serve/decode.py``: GQA attention, full or sliding-window, or MLA,
with a dense or MoE FFN, pre- or post-norm, or Mamba-2 mixers, on one
device).

A full-attention layer of a paged engine writes the new token's K/V (GQA)
or latent row (MLA) into its page pools in place (``_paged_write``), then a
hand-written paged kernel (``kernels/paged_attention``) walks the page
table and returns the unnormalized ``(o, m, l)`` partials, which
``_combine`` normalizes. A layer with dense per-slot rows (every attention
layer of the dense engine, and the sliding-window rings of either engine)
writes its row in place at ``pos`` (a ring at ``pos mod Sc``,
``_local_write``) and attends over the rows in plain torch, as JAX does
with an einsum (no TPU kernel computes it): a ring slot j holds position
``p_j = pos - ((pos - j) mod Sc)``, live while ``p_j > pos - window``. MLA
decodes in the latent space with the absorbed weights: the cache row is
both key and value (MQA-style, dim kv_lora + rope). A Mamba-2 layer steps
its per-slot state (``mamba2_step``) for every slot, active or not, as JAX
does: a slot's state is overwritten by the admit that next fills it.

``decode_loop`` runs a quantum of ``num_steps`` tokens as a Python loop
whose state (tokens, positions, masks, cache) never leaves the device; it
is the functional reference. ``decode_quantum`` runs the same loop and
writes the carry, the Mamba-2 states and the packed result back into the
tensors it was given, so a CUDA graph of it (``serve/graphs.py``) reads
and writes the same storage at every replay; the engine reads the packed
result back once per quantum. Per-step constants (the rope tables, the
page and offset of ``pos``, the write row and live keys of each shape of
dense rows) are computed once per step for all layers. ``plan_resume`` is
the tier pool's retry law (``serve/multi_engine.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models.layers import (apply_rope, embed, logits_fn, mlp,
                                       rmsnorm, rope_tables)
from repro_torch.models.mamba import mamba2_step
from repro_torch.models.moe import moe_decode
from repro_torch.models.transformer import BlockCfg, block_cfgs

F32 = torch.float32
NEG = -1e30


# ------------------------------------------------------------ flash decode
def _combine(o, m, l):
    """Exact softmax from (o, m, l) partials. On one device there is one
    partial per row, so this is o / l; ``m`` stays in the contract for the
    cross-rank max/sum combine a sharded decode adds."""
    del m
    return o / torch.clamp(l, min=1e-30)[..., None]


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


def _page_slot(pt, pos, ps: int):
    """(page, offset) int64 (B,) where logical position ``pos`` (B,) lies
    through page table ``pt`` (B,T) of ``ps``-row pages: computed once per
    step for every layer's write."""
    T = pt.shape[1]
    idx = torch.clamp(pos // ps, max=T - 1).long()
    page = pt.gather(1, idx[:, None])[:, 0]
    # a slot frozen at pos == max_len still scribbles each step; route it
    # to the trash page, never a live one
    page = torch.where(pos < T * ps, page, torch.zeros_like(page))
    return page.long(), (pos % ps).long()


def _paged_write(pool, new_row, pt, pos, slot=None):
    """Write ``new_row`` (B,…) at logical position ``pos`` (B,) through page
    table ``pt`` (B,T) into ``pool`` (N, ps, …), IN PLACE (``index_put_``),
    at ``slot`` (:func:`_page_slot`) when the caller has it. Distinct live
    slots hold disjoint pages (allocator invariant), so only the trash page
    0 can receive duplicate writes."""
    if slot is None:
        slot = _page_slot(pt, pos, pool.shape[1])
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
                     slot=None, rows=None, update: bool = True):
    """q (B,Hkv,G,dh); k_new/v_new (B,Hkv,dh); pos (B,) int32 → (out
    (B,Hkv,G,dh), k, v), the cache written in place.

    With ``page_table`` (B,T) int32 the cache is the pools (N, ps, Hkv, dh)
    and ``slot`` the write's :func:`_page_slot`: the paged kernel. Without,
    it is dense rows (B, S, Hkv, dh), a ring of S slots with ``window``, and
    ``rows`` the layer's :func:`_dense_rows`: plain torch, as JAX's einsum
    (``update=False`` attends without writing)."""
    if page_table is None:
        rel, live = rows
        if update:
            _local_write(pool_k, k_new, rel)
            _local_write(pool_v, v_new, rel)
        out = _dense_attend(q, pool_k, pool_v, live, scale=scale,
                            softcap=softcap)
        return out.to(q.dtype), pool_k, pool_v
    _check_paged_args(page_table, pos, update=update, window=window)
    _paged_write(pool_k, k_new, page_table, pos, slot)
    _paged_write(pool_v, v_new, page_table, pos, slot)
    B, hkv, grp, dh = q.shape
    o, m, l = paged_ops.paged_attend_gqa(
        q, pool_k, pool_v, page_table, pos, 0, page_size=pool_k.shape[1],
        scale=scale, softcap=softcap)
    out = _combine(o.reshape(B, hkv, grp, dh), m.reshape(B, hkv, grp),
                   l.reshape(B, hkv, grp))
    return out.to(q.dtype), pool_k, pool_v


def flash_decode_mla(q_eff, new_row, pool, pos, *, kv_lora: int,
                     scale: float, page_table=None, slot=None, rows=None):
    """q_eff (B,H,R); new_row (B,R); pos (B,) int32 → (out (B,H,kv_lora),
    cache), the cache written in place. Key = the cache row, value = its
    first kv_lora dims. With ``page_table`` (B,T) int32 the cache is the
    pool (N, ps, R), ``slot`` as in :func:`flash_decode_gqa`; without, dense
    rows (B, S, R) and ``rows`` their :func:`_dense_rows`."""
    if page_table is None:
        rel, live = rows
        _local_write(pool, new_row, rel)
        ckv = pool[:, :, None, :]                            # one kv head
        out = _dense_attend(q_eff[:, None], ckv, ckv[..., :kv_lora], live,
                            scale=scale)[:, 0]
        return out.to(q_eff.dtype), pool
    _check_paged_args(page_table, pos)
    _paged_write(pool, new_row, page_table, pos, slot)
    o, m, l = paged_ops.paged_attend_mla(
        q_eff, pool, page_table, pos, 0, page_size=pool.shape[1],
        kv_lora=kv_lora, scale=scale)
    return _combine(o, m, l).to(q_eff.dtype), pool


# ------------------------------------------------------- per-step constants
class StepConsts(NamedTuple):
    """What every attention layer of one decode step shares: the rope
    tables of ``pos`` (cos, sin (B, width/2) f32, None without rope), the
    page and offset the new row goes to in the pools (:func:`_page_slot`;
    None without pooled layers), and for each (rows, window) of the dense
    layers their :func:`_dense_rows`."""
    rope: Optional[tuple]
    slot: Optional[tuple]
    dense: dict


def _uses_pool(bc: BlockCfg, page_table) -> bool:
    """Full-attention layers read the page pool when there is a table; ring
    layers always keep dense rings (``pt = None if bc.window``)."""
    return page_table is not None and not bc.window


def step_consts(cfg: ModelConfig, cache, pos,
                page_table) -> Optional[StepConsts]:
    """The per-step constants of a model's attention layers, or None when
    it has none (Mamba-2): one rope width (MLA's rope dims, else the head
    dim), one page size (every pool is the engine's), and one
    :func:`_dense_rows` per shape of dense rows."""
    attn = [(bc, c) for bc, c in zip(block_cfgs(cfg), cache["layers"])
            if bc.mixer == "attn"]
    if not attn:
        return None
    rope = None
    if cfg.mla:
        rope = rope_tables(pos, cfg.mla.rope_dim, cfg.rope_theta)
    elif cfg.use_rope:
        rope = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    slot, dense = None, {}
    for bc, c in attn:
        n = next(iter(c.values())).shape[1]        # page size, or rows
        if _uses_pool(bc, page_table):
            if slot is None:
                slot = _page_slot(page_table, pos, n)
        elif (n, bc.window) not in dense:
            dense[(n, bc.window)] = _dense_rows(pos, n, bc.window)
    return StepConsts(rope, slot, dense)


# --------------------------------------------------------- per-block decode
def gqa_decode(cfg: ModelConfig, p, x, cache, pos, window: int,
               page_table, consts: StepConsts):
    """x (B,D) → (out (B,D), cache): the pools through ``page_table``, or
    the layer's dense rows (a ring with ``window``) without one."""
    B, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].reshape(D, -1)).view(B, H, dh)
    k = (x @ p["wk"].reshape(D, -1)).view(B, Hkv, dh)
    v = (x @ p["wv"].reshape(D, -1)).view(B, Hkv, dh)
    if cfg.use_rope:
        cos, sin = consts.rope                                  # (B, dh/2)
        q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k = apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
    qg = q.reshape(B, Hkv, H // Hkv, dh)
    rows = None if page_table is not None else \
        consts.dense[(cache["k"].shape[1], window)]
    out, ck, cv = flash_decode_gqa(
        qg, k, v, cache["k"], cache["v"], pos, scale=dh ** -0.5,
        softcap=cfg.attn_softcap, page_table=page_table, window=window,
        slot=consts.slot, rows=rows)
    o = out.reshape(B, H * dh) @ p["wo"].reshape(-1, D)
    return o, {"k": ck, "v": cv}


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
    rows = None if page_table is not None else \
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
                 page_table, consts: StepConsts):
    x = rmsnorm(h, p["norm1"], cfg.norm_eps)
    if bc.mixer == "mamba":
        y, new_state = mamba2_step(cfg, p["mamba"], x, cache)
        return h + y, new_state                # Mamba-2 blocks have no FFN
    # only full-attention layers are paged; rings keep dense buffers
    pt = page_table if _uses_pool(bc, page_table) else None
    if cfg.mla:
        y, new_cache = mla_decode(cfg, p["attn"], x, cache, pos, pt, consts)
    else:
        y, new_cache = gqa_decode(cfg, p["attn"], x, cache, pos, bc.window,
                                  pt, consts)
    if cfg.use_post_norm:
        y = rmsnorm(y, p["post1"], cfg.norm_eps)
    h = h + y
    x = rmsnorm(h, p["norm2"], cfg.norm_eps)
    y = moe_decode(cfg, p["moe"], x) if bc.ffn == "moe" else \
        mlp(cfg, p["mlp"], x)
    if cfg.use_post_norm:
        y = rmsnorm(y, p["post2"], cfg.norm_eps)
    return h + y, new_cache


# ------------------------------------------------------------- decode step
def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                page_table=None):
    """tokens (B,), pos (B,) int32 → (logits (B,V) f32, cache). The page
    pools and dense rows of ``cache`` are updated in place; Mamba-2 states
    are replaced. ``page_table`` (B,T) int32 addresses the pools of a paged
    cache; None for the dense engine's."""
    h = embed(cfg, params["embed"], tokens)
    consts = step_consts(cfg, cache, pos, page_table)
    layers = []
    for bc, p, c in zip(block_cfgs(cfg), params["layers"], cache["layers"]):
        h, c = block_decode(cfg, bc, p, c, h, pos, page_table, consts)
        layers.append(c)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(cfg, params["embed"], params["unembed"], h)
    return logits, {"layers": layers}


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
    lg = _filter_logits(logits, temperature=temperature, top_k=top_k,
                        top_p=top_p)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(F32).tiny)))
    return torch.argmax(lg + gumbel, -1).to(torch.int32)


def decode_loop(cfg: ModelConfig, params, cache, tokens, pos, active,
                remaining, *, num_steps: int, eos_id: int, max_len: int,
                page_table, temperature: float = 0.0, top_k: int = 0,
                top_p: float = 0.0, generator=None):
    """A quantum of ``num_steps`` decode steps with on-device sampling and
    per-slot done masking; nothing is read back to the host.

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
                                    page_table)
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
                   top_k: int = 0, top_p: float = 0.0, generator=None):
    """:func:`decode_loop` IN PLACE: the carry goes back into ``tokens``,
    ``pos``, ``active`` and ``remaining``, each Mamba-2 layer's new state
    into the state tensors of ``cache`` (the page pools are written in
    place as the loop runs), and the packed result (:func:`_pack`) into
    ``packed`` (2·num_steps + 1, B) int32. Every tensor it reads or writes
    is one it was given, so a CUDA graph of a call replays on the same
    storage; the values are decode_loop's, bit for bit."""
    carry, toks, msks = decode_loop(
        cfg, params, cache, tokens, pos, active, remaining,
        num_steps=num_steps, eos_id=eos_id, max_len=max_len,
        page_table=page_table, temperature=temperature, top_k=top_k,
        top_p=top_p, generator=generator)
    new_cache, new_tokens, new_pos, new_active, new_remaining = carry
    for layer, new in zip(cache["layers"], new_cache["layers"]):
        for name, t in new.items():
            if t is not layer[name]:           # Mamba-2 state; pools alias
                layer[name].copy_(t)
    packed.copy_(_pack(new_active, toks, msks))
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
