"""Prefill: full forward pass that also builds the cache rows
(``repro/serve/prefill.py``: GQA attention, full or sliding-window, or MLA,
with a dense or MoE FFN, pre- or post-norm, or Mamba-1 or Mamba-2 mixers,
with or without an FFN after them, alone or interleaved with attention).

Bucketed serving path: prompts are right-padded to a power-of-2 length
bucket and prefilled batched with an explicit per-row ``prompt_len``.
Causality keeps real rows from attending pad keys, and the last-token
logits are gathered at ``prompt_len - 1`` per row. Full-attention rows
come out ``(B, max_len, Hkv, dh)`` for the dense engine, or page-aligned
with ``page_size``, ``(B, ceil(S / page_size) · page_size, Hkv, dh)`` for
GQA, ``(B, …, kv_lora + rope)`` for MLA, ready for the paged engine's
admit scatter into its pools. A sliding-window layer's rows are its ring,
``attn_cache_len(window, max_len)`` slots with position p at slot p mod
Sc, packed per row so that pad positions never enter it (``_ring_pack_pl``).
A Mamba layer returns its decode state instead
(``mamba_mixer(return_state=True)``: the SSD kernel for Mamba-2, the
selective scan kernel for Mamba-1); its scan would absorb pad tokens, so
the engine prefills such models in exact-length groups.

On a mesh of m ranks on ``model`` (``ctx``: GQA with a dense or MoE FFN,
page pools) each rank attends over its H/m heads (the out-projection, the
MLP and the MoE each end in one all-reduce), the K and V rows are gathered
whole over the heads, and a rank keeps its in-page offsets [i·ps/m,
(i+1)·ps/m) of each page for the admit scatter into its pools.

A front end (internvl2): ``prefill(frontend_embed=)`` replaces the first F
positions of every row with the projected patch embeddings, whatever its
``prompt_len``; a prompt shorter than F is refused. An encoder-decoder
(whisper): ``whisper_prefill`` encodes the frames and computes every
decoder layer's cross K/V once, beside zero self rows.
``prefill_step_fn`` dispatches between the two, as JAX's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attend, cross_kv, gqa_project,
                                         mla_qkv, out_project)
from repro_torch.models.layers import embed, logits_fn, mlp, rmsnorm
from repro_torch.models.mamba import mamba_mixer
from repro_torch.models.moe import moe_block
from repro_torch.models.transformer import BlockCfg, block_cfgs
from repro_torch.models.whisper import encode
from repro_torch.serve.kv_cache import attn_cache_len
from repro_torch.sharding.axes import model_shard
from repro_torch.sharding.collectives import all_gather


def _pad_to(k: torch.Tensor, Sc: int) -> torch.Tensor:
    S = k.shape[1]
    if S >= Sc:
        return k[:, :Sc]
    pad = k.new_zeros((k.shape[0], Sc - S) + tuple(k.shape[2:]))
    return torch.cat([k, pad], dim=1)


def _ring_pack_pl(k: torch.Tensor, Sc: int,
                  prompt_len: torch.Tensor) -> torch.Tensor:
    """Per-row ring pack: (B,S,…) + prompt_len (B,) → (B,Sc,…), ring slot j
    holding the last real position p ≤ prompt_len - 1 with p ≡ j (mod Sc),
    zeros where no position is. Pad positions (≥ prompt_len) never enter
    the ring: a tail roll would let them displace real tokens whenever the
    padded bucket is longer than the window."""
    S = k.shape[1]
    j = torch.arange(Sc, device=k.device)
    last = prompt_len.long()[:, None] - 1                      # (B, 1)
    p_j = last - torch.remainder(last - j[None, :], Sc)        # (B, Sc)
    tail = (1,) * (k.dim() - 2)
    idx = p_j.clamp(0, S - 1).reshape(p_j.shape + tail)
    g = torch.take_along_dim(k, idx, dim=1)
    valid = (p_j >= 0).reshape(p_j.shape + tail)
    return torch.where(valid, g, torch.zeros((), dtype=k.dtype,
                                             device=k.device))


def bucket_len(n: int, *, min_bucket: int = 16,
               max_bucket: int | None = None) -> int:
    """Smallest power-of-2 length bucket holding an n-token prompt.

    Bounded below by `min_bucket` and above by `max_bucket` (the engine's
    max_len); n must fit the cap.
    """
    b = max(min_bucket, 1 << (max(int(n), 1) - 1).bit_length())
    if max_bucket is not None:
        b = min(b, max_bucket)
    if b < n:   # typed, not assert: Engine.submit surfaces this upstream
        raise ValueError(
            f"prompt of {n} tokens exceeds the {max_bucket}-token cap")
    return b


def gqa_prefill(cfg: ModelConfig, p, x, *, window: int, positions,
                seq_len_cache: int, prompt_len=None, ctx=None):
    """Attention + cache build. x (B,S,D) → (out, {"k", "v"}). Full
    attention: the rows padded to ``seq_len_cache``; pad rows land at
    positions ≥ prompt_len, which decode never attends before overwriting.
    A window: the ring of ``seq_len_cache`` slots, packed per row up to
    ``prompt_len`` (B,) (S for every row when not given). On a mesh the
    rank's heads attend and the rows come out with every KV head."""
    B, S = x.shape[:2]
    q, k, v = gqa_project(cfg, p, x, positions)
    out = attend(q, k, v, scale=cfg.head_dim ** -0.5, causal=True,
                 window=window, softcap=cfg.attn_softcap)
    o = out_project(out.reshape(B, S, -1), p["wo"], ctx)
    if model_shard(ctx)[0] > 1:             # the rows of every KV head
        k, v = all_gather(torch.stack([k, v]), 3, ctx).unbind(0)
    if window:
        if prompt_len is None:                  # every row is S real tokens
            prompt_len = torch.full((B,), S, device=x.device)
        ck = _ring_pack_pl(k, seq_len_cache, prompt_len)
        cv = _ring_pack_pl(v, seq_len_cache, prompt_len)
    else:
        ck, cv = _pad_to(k, seq_len_cache), _pad_to(v, seq_len_cache)
    return o, {"k": ck, "v": cv}


def mla_prefill(cfg: ModelConfig, p, x, *, positions, seq_len_cache: int):
    """MLA attention in the expanded form (latents up-projected to 128
    full heads, q/k dim nope + rope, v dim v_dim) + the cache rows
    ``ckv = concat(c_kv, k_rope)`` (B, seq_len_cache, kv_lora + rope) in the
    parameter dtype."""
    m = cfg.mla
    B, S, _ = x.shape
    q, k, v, c_kv, k_r = mla_qkv(cfg, p, x, positions)
    out = attend(q, k, v, scale=(m.nope_dim + m.rope_dim) ** -0.5,
                 causal=True)
    o = out.reshape(B, S, cfg.n_heads * m.v_dim) @ \
        p["wo"].reshape(-1, cfg.d_model)
    ckv = torch.cat([c_kv, k_r[:, :, 0, :]], dim=-1)
    return o, {"ckv": _pad_to(ckv, seq_len_cache).to(cfg.pdtype)}


def _rank_offsets(rows: torch.Tensor, page_size: int, ctx) -> torch.Tensor:
    """Page-aligned rows (B, T·ps, …) → this rank's in-page offsets of each
    page, (B, T·ps/m, …), the rows its pool pages take at admit."""
    m, i = model_shard(ctx)
    ps_loc = page_size // m
    B, n = rows.shape[:2]
    tail = tuple(rows.shape[2:])
    paged = rows.reshape((B, n // page_size, page_size) + tail)
    return paged[:, :, i * ps_loc:(i + 1) * ps_loc].reshape(
        (B, -1) + tail)


def block_prefill(cfg: ModelConfig, bc: BlockCfg, p, h, positions,
                  seq_len: int, max_len: int | None = None,
                  prompt_len=None, page_size: int | None = None, ctx=None):
    x = rmsnorm(h, p["norm1"], cfg.norm_eps)
    if bc.mixer == "mamba":
        y, cache = mamba_mixer(cfg, p["mamba"], x, return_state=True)
    else:
        if page_size and not bc.window:
            # paged engine: full-attention rows sized by the bucket, rounded
            # up to whole pages (the admit copies them into pool pages)
            Sc = -(-seq_len // page_size) * page_size
        else:
            Sc = attn_cache_len(bc.window, max_len or seq_len)
        if cfg.mla:
            y, cache = mla_prefill(cfg, p["attn"], x, positions=positions,
                                   seq_len_cache=Sc)
        else:
            y, cache = gqa_prefill(cfg, p["attn"], x, window=bc.window,
                                   positions=positions, seq_len_cache=Sc,
                                   prompt_len=prompt_len, ctx=ctx)
            if model_shard(ctx)[0] > 1:
                cache = {n: _rank_offsets(r, page_size, ctx)
                         for n, r in cache.items()}
    if cfg.use_post_norm:
        y = rmsnorm(y, p["post1"], cfg.norm_eps)
    h = h + y
    if bc.ffn != "none":
        x = rmsnorm(h, p["norm2"], cfg.norm_eps)
        if bc.ffn == "moe":
            y, _ = moe_block(cfg, p["moe"], x, ctx)
        else:
            y = mlp(cfg, p["mlp"], x, ctx)
        if cfg.use_post_norm:
            y = rmsnorm(y, p["post2"], cfg.norm_eps)
        h = h + y
    return h, cache


def _check_frontend(frontend_embed, S: int, prompt_len) -> None:
    """A front end's F patch positions must lie inside the prompt. Shorter
    tokens (S < F) raise the TypeError JAX's prefill raises there (its
    shapes do not broadcast); with ``prompt_len`` a row shorter than F
    raises a ValueError (JAX computes it, its logits gathered at a patch
    position)."""
    F = frontend_embed.shape[1]
    if S < F:
        raise TypeError(f"{S} tokens cannot hold the {F} front-end "
                        "positions")
    if prompt_len is not None and bool((prompt_len < F).any()):
        raise ValueError(f"prompt_len {prompt_len.tolist()} below the {F} "
                         "front-end positions")


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            max_len: int | None = None, prompt_len: torch.Tensor | None = None,
            page_size: int | None = None,
            frontend_embed: torch.Tensor | None = None, ctx=None):
    """tokens (B,S) → (last-token logits (B,V) f32, {"layers": [{"k","v"},
    {"ckv"} or the Mamba state ({"conv_x", "conv_B", "conv_C", "ssm"} for
    Mamba-2, {"conv_x", "ssm"} for Mamba-1)]}).

    ``prompt_len`` (B,) marks right-padded rows: logits are gathered at
    prompt_len-1 per row, and ring caches are packed per row. ``max_len``
    (default S) sizes full-attention rows and the rings; ``page_size``
    sizes full-attention rows by the bucket (page-aligned) instead.
    ``frontend_embed`` (B,F,frontend_dim) replaces the first F positions
    of every row (:func:`_check_frontend`). ``ctx``: the mesh (the paged
    layout only: ``page_size`` must be given), whose ranks hold their
    blocks of ``params``; every rank returns the whole logits and its
    offsets of the rows.
    """
    S = tokens.shape[1]
    if model_shard(ctx)[0] > 1 and not page_size:
        raise ValueError("a sharded prefill builds page-aligned rows: "
                         "give page_size")
    if frontend_embed is not None:
        _check_frontend(frontend_embed, S, prompt_len)
    h = embed(cfg, params["embed"], tokens, frontend_embed, ctx)
    positions = torch.arange(S, device=tokens.device)
    caches = []
    for bc, p in zip(block_cfgs(cfg), params["layers"]):
        h, c = block_prefill(cfg, bc, p, h, positions, S, max_len,
                             prompt_len=prompt_len, page_size=page_size,
                             ctx=ctx)
        caches.append(c)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if prompt_len is None:
        last = h[:, -1, :]
    else:
        idx = torch.clamp(prompt_len.long() - 1, 0, S - 1)
        last = h[torch.arange(h.shape[0], device=h.device), idx]
    logits = logits_fn(cfg, params["embed"], params["unembed"], last, ctx)
    return logits, {"layers": caches}


def whisper_prefill(cfg: ModelConfig, params, frames: torch.Tensor):
    """Encode ``frames`` (B, Se, D) and build the decoder's cache →
    (enc_out (B, Se, D), {"dec_layers": [{"k", "v": zero self rows (B,
    max_decoder_len, Hkv, dh), "xk", "xv": the layer's cross K/V (B, Se,
    Hkv, dh)}, ...]}): the cross K/V of every decoder layer computed once."""
    enc_out = encode(cfg, params, frames)
    B = frames.shape[0]
    layers = []
    for p in params["dec_layers"]:
        xk, xv = cross_kv(cfg, p["cross"], enc_out)
        rows = xk.new_zeros((B, cfg.max_decoder_len, cfg.n_kv_heads,
                             cfg.head_dim))
        layers.append({"k": rows, "v": torch.zeros_like(rows), "xk": xk,
                       "xv": xv})
    return enc_out, {"dec_layers": layers}


def prefill_step_fn(cfg: ModelConfig):
    """The prefill entry of ``cfg``: ``step(params, frames)`` →
    :func:`whisper_prefill` for an encoder-decoder, else ``step(params,
    tokens, frontend_embed=None)`` → :func:`prefill`."""
    if cfg.enc_dec:
        def step(params, frames):
            return whisper_prefill(cfg, params, frames)
        return step

    def step(params, tokens, frontend_embed=None):
        return prefill(cfg, params, tokens, frontend_embed=frontend_embed)
    return step
