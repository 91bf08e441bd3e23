"""Parameter tree of the port (``repro/sharding/params.py`` +
``repro/models/model.py::model_defs``).

The tree keeps the JAX layouts leaf by leaf — ``wq`` (D,H,dh), ``wk``/``wv``
(D,Hkv,dh), ``wo`` (H,dh,D), ``w_up``/``w_gate`` (D,F; no ``w_gate`` when the
FFN is not gated), ``w_down`` (F,D), the post-norm weights ``post1``/``post2``
of a sandwich-norm model (gemma2; ``post2`` only where the block has an
FFN),
the MLA projections (``wdq`` (D,q_lora) … ``wukv`` (kv_lora,H,nope+v)),
the expert stacks (``w_up`` (E,D,F) …; ``w_gate`` and ``ws_gate`` only
when gated), the embedding (V,D), the
unembedding (D,V), f32 norm weights and router — but holds the blocks as a
plain list ``layers`` in layer order instead of stacked scan segments:

    {"embed": {"table"}, "layers": [{"norm1", "attn" or "mamba": {...},
     ["post1",] ["norm2", "mlp" or "moe": {...}, ["post2"]]}, ...],
     "final_norm", "unembed": {"w"} (empty with tied embeddings)}
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import is_gated
from repro_torch.models.transformer import (block_cfgs, check_params,
                                            layer_schedule)

F32 = torch.float32


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype
    init: str = "normal"          # normal | ones | zeros
    scale: float = 0.02
    # logical axis of each dim (``sharding/axes.py``), as JAX's
    # ``ParamDef.axes`` without the stacked ``layers`` axis; None for a
    # buffer that is never sharded (the decode caches)
    axes: Optional[tuple[Optional[str], ...]] = None

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not match shape "
                             f"{self.shape}")


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (nested dicts and lists), with the
    matching leaves of the trees in ``rest`` as further arguments. A node
    for which ``is_leaf`` is true is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *vs, is_leaf=is_leaf)
                for vs in zip(tree, *rest)]
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> list:
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def param_specs(cfg: ModelConfig):
    """The shape tree, with the JAX init scales: normal·0.02, out-projections
    normal·0.02/sqrt(2L), ones for the norms, the MoE router in f32. Each
    layer follows its :class:`BlockCfg`: GQA (``attention.py::gqa_defs``)
    or MLA attention (``mla_defs``), a dense MLP of the block's width
    (``layers.py::mlp_defs``: ``w_gate`` only when gated) or the MoE tree
    (``moe.py::moe_defs``: ``w_gate``/``ws_gate`` only when gated), the
    post-norms of a post-norm model (``transformer.py::block_defs``:
    ``post1`` after the mixer, ``post2`` after an FFN), or a Mamba mixer
    followed by the block's FFN, if it has one: Mamba-2
    (``mamba.py::mamba2_defs``) or
    Mamba-1 (``mamba1_defs``: the x/z projections, the conv, ``w_bcdt``
    (C, dt_rank + 2N) and ``w_dt`` (dt_rank, C) with dt_rank = ceil(d/16),
    A_log (C, N)); A_log, D_skip and dt_bias in f32, zeros for A_log,
    dt_bias and the conv biases, ones for D_skip, conv weights at 0.1.
    A front end adds ``embed.frontend_proj`` (``layers.py::embed_defs``);
    an encoder-decoder has whisper's tree (the module docstring)."""
    check_params(cfg)
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pdt = cfg.pdtype
    out_scale = 0.02 / max(1.0, (2 * max(cfg.n_layers, 1)) ** 0.5)

    def w(shape, axes, dtype=pdt, init="normal", scale=0.02):
        return ParamSpec(tuple(shape), dtype, init, scale, tuple(axes))

    def norm(n):
        return w((n,), (None,), F32, "ones")

    def attn():
        if cfg.mla is None:
            return {"wq": w((D, H, dh), ("embed", "heads", "qk")),
                    "wk": w((D, Hkv, dh), ("embed", "kv_heads", "qk")),
                    "wv": w((D, Hkv, dh), ("embed", "kv_heads", "qk")),
                    "wo": w((H, dh, D), ("heads", "qk", "embed"),
                            scale=out_scale)}
        m = cfg.mla
        return {"wdq": w((D, m.q_lora), ("embed", "lora")),
                "q_norm": norm(m.q_lora),
                "wuq": w((m.q_lora, H, m.nope_dim + m.rope_dim),
                         ("lora", "heads", "qk")),
                "wdkv": w((D, m.kv_lora), ("embed", "lora")),
                "kv_norm": norm(m.kv_lora),
                "wukv": w((m.kv_lora, H, m.nope_dim + m.v_dim),
                          ("lora", "heads", "qk")),
                "wkr": w((D, m.rope_dim), ("embed", "qk")),
                "wo": w((H, m.v_dim, D), ("heads", "v", "embed"),
                        scale=out_scale)}

    def moe():
        m = cfg.moe
        E, Fe = m.n_experts, m.d_expert
        d = {"router": w((D, E), ("embed", None), F32),
             "w_up": w((E, D, Fe), ("experts", "embed", None)),
             "w_down": w((E, Fe, D), ("experts", None, "embed"),
                         scale=out_scale)}
        if is_gated(cfg.act):
            d["w_gate"] = w((E, D, Fe), ("experts", "embed", None))
        if m.n_shared:
            Fs = m.n_shared * Fe
            d.update({"ws_up": w((D, Fs), ("embed", "mlp")),
                      "ws_down": w((Fs, D), ("mlp", "embed"),
                                   scale=out_scale)})
            if is_gated(cfg.act):
                d["ws_gate"] = w((D, Fs), ("embed", "mlp"))
        return d

    def mamba():
        s = cfg.ssm
        C, N, K = cfg.d_inner, s.d_state, s.d_conv
        if s.version == 1:
            r = max(1, -(-D // 16))                 # dt_rank = ceil(d / 16)
            return {"wz": w((D, C), ("embed", "d_inner")),
                    "wx": w((D, C), ("embed", "d_inner")),
                    "conv_x": w((K, C), ("conv", "d_inner"), scale=0.1),
                    "conv_x_b": w((C,), ("d_inner",), init="zeros"),
                    "w_bcdt": w((C, r + 2 * N), ("d_inner", None)),
                    "w_dt": w((r, C), (None, "d_inner")),
                    "dt_bias": w((C,), ("d_inner",), F32, "zeros"),
                    "A_log": w((C, N), ("d_inner", "ssm_state"), F32,
                               "zeros"),
                    "D_skip": w((C,), ("d_inner",), F32, "ones"),
                    "wo": w((C, D), ("d_inner", "embed"), scale=out_scale)}
        H = C // s.head_dim
        return {"wz": w((D, C), ("embed", "d_inner")),
                "wx": w((D, C), ("embed", "d_inner")),
                "wB": w((D, N), ("embed", "ssm_state")),
                "wC": w((D, N), ("embed", "ssm_state")),
                "wdt": w((D, H), ("embed", "ssm_heads")),
                "conv_x": w((K, C), ("conv", "d_inner"), scale=0.1),
                "conv_x_b": w((C,), ("d_inner",), init="zeros"),
                "conv_B": w((K, N), ("conv", "ssm_state"), scale=0.1),
                "conv_B_b": w((N,), ("ssm_state",), init="zeros"),
                "conv_C": w((K, N), ("conv", "ssm_state"), scale=0.1),
                "conv_C_b": w((N,), ("ssm_state",), init="zeros"),
                "A_log": w((H,), ("ssm_heads",), F32, "zeros"),
                "D_skip": w((H,), ("ssm_heads",), F32, "ones"),
                "dt_bias": w((H,), ("ssm_heads",), F32, "zeros"),
                "gn": norm(C),
                "wo": w((C, D), ("d_inner", "embed"), scale=out_scale)}

    def mlp(d_ff):
        d = {"w_up": w((D, d_ff), ("embed", "mlp")),
             "w_down": w((d_ff, D), ("mlp", "embed"), scale=out_scale)}
        if is_gated(cfg.act):
            d["w_gate"] = w((D, d_ff), ("embed", "mlp"))
        return d

    def layer(bc):
        d = {"norm1": norm(D)}
        d.update({"mamba": mamba()} if bc.mixer == "mamba" else
                 {"attn": attn()})
        if cfg.use_post_norm:
            d["post1"] = norm(D)
        if bc.ffn != "none":
            d["norm2"] = norm(D)
            d.update({"moe": moe()} if bc.ffn == "moe" else
                     {"mlp": mlp(bc.d_ff)})
            if cfg.use_post_norm:
                d["post2"] = norm(D)
        return d

    table = w((cfg.vocab, D), ("vocab", "embed"))
    if cfg.enc_dec:
        # whisper.py::encdec_defs: the decoder positions at scale 0.01, the
        # cross attention with GQA's shapes and scales, the unembedding tied
        enc = {"norm1": norm(D), "attn": attn(), "norm2": norm(D),
               "mlp": mlp(cfg.d_ff)}
        dec = {"norm1": norm(D), "self_attn": attn(), "norm_x": norm(D),
               "cross": attn(), "norm2": norm(D), "mlp": mlp(cfg.d_ff)}
        return {"embed": {"table": table},
                "dec_pos": w((cfg.max_decoder_len, D), (None, "embed"),
                             scale=0.01),
                "enc_layers": [enc] * cfg.n_enc_layers, "enc_norm": norm(D),
                "dec_layers": [dec] * cfg.n_layers, "dec_norm": norm(D),
                "unembed": {}}
    emb = {"table": table}
    if cfg.frontend != "none" and cfg.frontend_dim:
        emb["frontend_proj"] = w((cfg.frontend_dim, D), ("frontend", "embed"))
    return {
        "embed": emb,
        "layers": [layer(bc) for bc in block_cfgs(cfg)],
        "final_norm": norm(D),
        "unembed": ({} if cfg.tie_embeddings
                    else {"w": w((D, cfg.vocab), ("embed", "vocab"))}),
    }


def n_params(cfg: ModelConfig) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(param_specs(cfg)))


def init_params(cfg: ModelConfig, seed: int = 0, device=None, ctx=None):
    """Seeded random weights made on ``device`` (the card unless
    ``device="cpu"``). Same scales as the JAX init, not the same numbers.

    With a sharded ``ctx`` (``sharding/axes.py::ShardCtx``) each leaf is
    drawn whole from the same generator, this rank's block is kept and the
    rest freed, one leaf at a time: a rank's block is the slice of the
    one-device init."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sharded = ctx is not None and math.prod(ctx.sizes.values()) > 1

    def leaf(spec: ParamSpec) -> torch.Tensor:
        if spec.init in ("ones", "zeros"):
            shape = (ctx.local_shape(spec.axes, spec.shape) if sharded
                     else spec.shape)
            fill = torch.ones if spec.init == "ones" else torch.zeros
            return fill(shape, dtype=spec.dtype, device=device)
        x = torch.randn(spec.shape, generator=gen, dtype=F32, device=device)
        if sharded:
            x = ctx.block(x, spec.axes).clone()
        return x.mul_(spec.scale).to(spec.dtype)

    return tree_map(leaf, param_specs(cfg))


def _from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                    # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is opaque to torch.from_numpy: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _unstack(stacked, n: int) -> list:
    """A subtree whose leaves carry a leading axis of ``n`` → ``n`` subtrees
    of one entry each."""
    return [tree_map(lambda a, r=r: np.asarray(a)[r], stacked)
            for r in range(n)]


def params_from_numpy(tree, cfg: ModelConfig, device=None, ctx=None):
    """Carry a JAX parameter tree (``materialize(model_defs(cfg), key)``,
    leaves as numpy or array-likes) across. Its ``blocks`` — one entry per
    scan segment (jamba: one 8-slot pattern of Mamba-1 and attention
    mixers, dense and MoE FFNs), leaves with a leading repeat axis — are
    unstacked into ``layers`` in layer order; an encoder-decoder's stacked
    ``enc_blocks`` and ``dec_blocks`` into ``enc_layers`` and
    ``dec_layers``. With a sharded ``ctx`` only this rank's block of each
    leaf is carried to ``device``."""
    device = resolve_device(device)
    specs = param_specs(cfg)
    if cfg.enc_dec:
        flat = {k: tree[k] for k in ("embed", "dec_pos", "enc_norm",
                                     "dec_norm", "unembed")}
        flat["enc_layers"] = _unstack(tree["enc_blocks"], cfg.n_enc_layers)
        flat["dec_layers"] = _unstack(tree["dec_blocks"], cfg.n_layers)
    else:
        layers = []
        for seg, seg_tree in zip(layer_schedule(cfg), tree["blocks"]):
            slots = [_unstack(seg_tree[f"s{j}"], seg.repeat)
                     for j in range(len(seg.pattern))]
            layers += [s[r] for r in range(seg.repeat) for s in slots]
        flat = {"embed": tree["embed"], "layers": layers,
                "final_norm": tree["final_norm"], "unembed": tree["unembed"]}
    out = tree_map(lambda a: _from_numpy(a, "cpu"), flat)
    got = tree_map(lambda t: (tuple(t.shape), t.dtype), out)
    want = tree_map(lambda s: (s.shape, s.dtype), specs)
    if got != want:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"got {got}, want {want}")
    if ctx is not None:
        out = tree_map(lambda t, s: ctx.block(t, s.axes).clone(), out, specs)
    return tree_map(lambda t: t.to(device), out)
