"""Per-layer block schedule and the training stack
(``repro/models/transformer.py``).

The JAX stack compresses the layer list into repeating :class:`Segment`s
and scans over stacked parameters. The port runs layers in a Python loop
over an unstacked list; ``layer_schedule`` stays so that a JAX parameter
tree can be unstacked in layer order (``params.params_from_numpy``). The
training stack (``block_apply`` … ``lm_loss``) checkpoints every layer, as
the JAX scan body's ``jax.checkpoint``, and sums the MoE router stats of
the layers into the load-balancing loss.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention
from repro_torch.models.layers import (chunked_ce_loss, embed,
                                       mlp, rmsnorm)
from repro_torch.models.mamba import mamba_mixer
from repro_torch.models.moe import aux_loss_from_stats, moe_block
from repro_torch.sharding.axes import model_shard

F32 = torch.float32


@dataclass(frozen=True)
class BlockCfg:
    mixer: str          # "attn" | "mamba"
    window: int         # 0 = full attention
    ffn: str            # "dense" | "moe" | "none"
    d_ff: int


@dataclass(frozen=True)
class Segment:
    pattern: tuple[BlockCfg, ...]
    repeat: int


def block_cfg_for_layer(cfg: ModelConfig, i: int) -> BlockCfg:
    mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
    window = cfg.window_for_layer(i) if mixer == "attn" else 0
    if cfg.d_ff == 0 and cfg.moe is None:
        ffn, d_ff = "none", 0
    elif cfg.is_moe_layer(i):
        ffn, d_ff = "moe", cfg.moe.d_expert
    elif cfg.moe is not None and i < cfg.moe.first_dense:
        ffn, d_ff = "dense", cfg.moe.dense_d_ff or cfg.d_ff
    else:
        ffn, d_ff = "dense", cfg.d_ff
    return BlockCfg(mixer, window, ffn, d_ff)


def block_cfgs(cfg: ModelConfig) -> list[BlockCfg]:
    """One :class:`BlockCfg` per layer, in layer order."""
    return [block_cfg_for_layer(cfg, i) for i in range(cfg.n_layers)]


def layer_schedule(cfg: ModelConfig) -> tuple[Segment, ...]:
    """Compress the per-layer block list into maximal repeating segments
    (the JAX parameter tree's ``blocks`` structure)."""
    blocks = block_cfgs(cfg)
    segs: list[Segment] = []
    i = 0
    while i < len(blocks):
        best_plen, best_reps = 1, 1
        for plen in range(1, min(16, len(blocks) - i) + 1):
            pat = blocks[i:i + plen]
            reps = 1
            while blocks[i + reps * plen:i + (reps + 1) * plen] == pat:
                reps += 1
            if reps > 1 and reps * plen > best_plen * best_reps:
                best_plen, best_reps = plen, reps
        segs.append(Segment(tuple(blocks[i:i + best_plen]), best_reps))
        i += best_plen * best_reps
    assert sum(s.repeat * len(s.pattern) for s in segs) == len(blocks)
    return tuple(segs)


def check_params(cfg: ModelConfig) -> None:
    """The families whose parameters the port lays out: every block the
    JAX stack builds on one device. A decoder's layers are GQA or MLA
    attention or a Mamba mixer (Mamba-2 SSD or Mamba-1 selective scan),
    alone or interleaved (jamba), each followed by a dense FFN (gated
    swiglu or geglu, or non-gated relu2 or gelu), an MoE FFN (gated or
    not) or no FFN, pre-norm or sandwich post-norm (``post1`` after the
    mixer, ``post2`` after the FFN); a decoder may have a stub front end
    (internvl2: projected patch embeddings); and the whisper
    encoder-decoder (whisper, ``params.param_specs``)."""
    if cfg.ssm is not None and cfg.ssm.version not in (1, 2):
        raise NotImplementedError(
            f"{cfg.name}: SSM version {cfg.ssm.version} is not ported "
            "(Mamba-1 and Mamba-2 are)")
    if any(bc.ffn != "none" for bc in block_cfgs(cfg)) and \
            cfg.act not in ("swiglu", "geglu", "relu2", "gelu"):
        raise NotImplementedError(
            f"{cfg.name}: activation {cfg.act!r} is not ported (swiglu, "
            "geglu, relu2, gelu)")


# The JAX package serves windowed MLA wrongly, so the port does not serve
# it: ``repro/serve/prefill.py::mla_prefill`` attends over the whole prompt
# and cuts the latents to a ring of ``window`` rows, and
# ``repro/serve/decode.py::flash_decode_mla`` writes row ``pos``, which its
# ``_local_write`` drops once ``pos >= window``; neither applies the window.
WINDOWED_MLA_SERVING = (
    "sliding-window MLA is trained but not served: the JAX reference's "
    "mla_prefill ignores the window and its flash_decode_mla stops "
    "writing rows past it (repro/serve/prefill.py, repro/serve/decode.py)")


def check_supported(cfg: ModelConfig) -> None:
    """The decoder serving path (prefill, decode and the engine) takes the
    decoders of :func:`check_params`, a front end's as text (its
    ``prefill`` takes the front-end embeddings); full-attention layers keep
    their K/V in the page pool (or dense rows), sliding-window layers in
    per-slot rings (GQA only: windowed MLA is refused,
    :data:`WINDOWED_MLA_SERVING`), Mamba layers their state per slot. An
    encoder-decoder serves through ``serve/prefill.py::whisper_prefill``
    and ``serve/decode.py::whisper_decode_step`` instead (JAX's engine
    asserts the same)."""
    check_params(cfg)
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: enc-dec serving uses whisper_decode_step "
            "(with whisper_prefill), not the decoder engine")
    if cfg.mla is not None and any(bc.window for bc in block_cfgs(cfg)):
        raise NotImplementedError(f"{cfg.name}: {WINDOWED_MLA_SERVING}")


# The port trains every family :func:`check_params` lays out, windowed MLA
# included (training keeps no cache); only its serving is refused.
check_trainable = check_params

# What JAX runs where a head count does not divide the model axis
CP_GQA = ("repro/models/attention.py::cp_gqa_attention (context-parallel "
          "GQA, which the port does not have yet)")


def check_sharded(cfg: ModelConfig, ctx) -> None:
    """The models the port runs on a mesh of m > 1 ranks on ``model``: GQA
    decoders with a dense or MoE FFN and full attention, every cut dim
    divisible by m (heads, KV heads, vocab, FFN width, experts). JAX's
    sharding law would keep a dim that does not divide whole, or take
    :data:`CP_GQA` for heads; the port refuses those, and the families
    whose sharding waits (MLA, Mamba, whisper, a VLM front end,
    sliding-window rings). A ``data`` axis above 1 is refused too. Nothing
    to check on one rank."""
    if ctx is None or math.prod(ctx.sizes.values()) == 1:
        return
    m = model_shard(ctx)[0]
    if ctx.axis_size("data") * ctx.axis_size("pod") > 1:
        raise ValueError(f"a data axis of {ctx.sizes} is not sharded yet: "
                         "the port takes data = 1")
    blocks = block_cfgs(cfg)
    waits = [("whisper (encoder-decoder)", cfg.enc_dec),
             ("MLA", cfg.mla is not None),
             ("Mamba", any(bc.mixer == "mamba" for bc in blocks)),
             ("a VLM front end", cfg.frontend != "none"),
             ("sliding-window rings", any(bc.window for bc in blocks))]
    for what, hit in waits:
        if hit:
            raise ValueError(f"{cfg.name}: {what} is not sharded over the "
                             f"model axis yet")
    if cfg.n_heads % m or cfg.n_kv_heads % m:
        raise ValueError(
            f"{cfg.name}: {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads "
            f"do not divide a model axis of {m}; JAX takes {CP_GQA}")
    dims = {"vocab": cfg.vocab}
    for i, bc in enumerate(blocks):
        if bc.ffn == "dense":
            dims[f"layer {i} FFN width"] = bc.d_ff
        elif bc.ffn == "moe":
            dims["experts"] = cfg.moe.n_experts
            dims["shared-expert width"] = cfg.moe.n_shared * cfg.moe.d_expert
    for what, n in dims.items():
        if n % m:
            raise ValueError(f"{cfg.name}: {what} {n} does not divide a "
                             f"model axis of {m}")


# ---------------------------------------------------------------- training
def block_apply(cfg: ModelConfig, bc: BlockCfg, p, h: torch.Tensor,
                positions, ctx=None):
    """One block, h (B,S,D) → (h', MoE router stats (2, E) f32 or None), in
    JAX ``block_apply``'s order: pre-norm, the mixer (GQA or MLA attention,
    or Mamba-1 or -2), the FFN (dense or MoE, where the block has one), and
    with ``use_post_norm`` each branch's output normed again (``post1``,
    ``post2``) before its residual add. ``ctx``: the mesh, whose ranks hold
    their blocks of ``p``."""
    x = rmsnorm(h, p["norm1"], cfg.norm_eps)
    if bc.mixer == "attn":
        y = attention(cfg, p["attn"], x, window=bc.window,
                      positions=positions, ctx=ctx)
    else:
        y = mamba_mixer(cfg, p["mamba"], x)
    if cfg.use_post_norm:
        y = rmsnorm(y, p["post1"], cfg.norm_eps)
    h = h + y
    stats = None
    if bc.ffn != "none":
        x = rmsnorm(h, p["norm2"], cfg.norm_eps)
        if bc.ffn == "moe":
            y, stats = moe_block(cfg, p["moe"], x, ctx)
        else:
            y = mlp(cfg, p["mlp"], x, ctx)
        if cfg.use_post_norm:
            y = rmsnorm(y, p["post2"], cfg.norm_eps)
        h = h + y
    return h, stats


def _check_forward(cfg: ModelConfig, ctx) -> None:
    """A mesh runs :func:`check_sharded`'s models forward only."""
    if model_shard(ctx)[0] > 1:
        check_sharded(cfg, ctx)
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "training on a mesh is not ported yet; run the sharded "
                "stack under torch.no_grad()")


def apply_stack(cfg: ModelConfig, layers, h: torch.Tensor, positions,
                ctx=None):
    """Every layer in order, each under activation checkpointing when a
    gradient is wanted (only the layer inputs stay alive; the recompute
    routes as the forward did). → (h, the MoE stats summed over the layers,
    a dense layer of an MoE model adding zeros, as JAX's scan; None without
    MoE). On a mesh (``ctx``, forward only: training across cards waits for
    a later slice, :func:`lm_hidden` checks) each rank runs its blocks of
    every layer."""
    total = None
    for bc, p in zip(block_cfgs(cfg), layers):
        if torch.is_grad_enabled():
            h, stats = checkpoint(block_apply, cfg, bc, p, h, positions,
                                  use_reentrant=False)
        else:
            h, stats = block_apply(cfg, bc, p, h, positions, ctx)
        if stats is not None:
            total = stats if total is None else total + stats
    if total is None and cfg.moe is not None:
        total = torch.zeros((2, cfg.moe.n_experts), dtype=F32,
                            device=h.device)
    return h, total


def lm_hidden(cfg: ModelConfig, params, tokens: torch.Tensor,
              frontend_embed: torch.Tensor | None = None, ctx=None):
    """tokens (B,S) → (final hidden states (B,S,D), summed MoE stats or
    None). ``frontend_embed`` (B,F,frontend_dim) replaces the first F
    positions (``layers.embed``); ``ctx`` the mesh (:func:`apply_stack`)."""
    _check_forward(cfg, ctx)
    h = embed(cfg, params["embed"], tokens, frontend_embed, ctx)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, stats = apply_stack(cfg, params["layers"], h, positions, ctx)
    return rmsnorm(h, params["final_norm"], cfg.norm_eps), stats


def lm_loss(cfg: ModelConfig, params, batch):
    """batch: tokens/targets (B,S) int, mask (B,S) f32 (and a front end's
    ``frontend_embed`` (B,F,frontend_dim)) → (loss, metrics) with ``ce``,
    ``tokens``, ``loss`` and for MoE models ``moe_aux`` (0-d f32 tensors):
    loss = ce + the load-balancing loss of the stats averaged over the MoE
    layers (JAX ``lm_loss``)."""
    h, stats = lm_hidden(cfg, params, batch["tokens"],
                         batch.get("frontend_embed"))
    sum_l, sum_c = chunked_ce_loss(cfg, params["embed"], params["unembed"],
                                   h, batch["targets"], batch["mask"])
    ce = sum_l / torch.clamp(sum_c, min=1.0)
    metrics = {"ce": ce, "tokens": sum_c}
    loss = ce
    if cfg.moe is not None:
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        aux = aux_loss_from_stats(cfg, stats / max(n_moe, 1))
        metrics["moe_aux"] = aux
        loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics
