"""AdamW (decoupled weight decay), global-norm clip and the warmup-cosine
schedule (``repro/train/optimizer.py``), as plain functions over the state
tree (no ``torch.optim``).

Moments are f32 whatever the parameter dtype, or int8 ``m`` (absmax per
last axis) with bf16 ``v``; the update math runs in f32 and is cast back to
the parameter dtype. Decay applies to leaves with ndim >= 2; eps is added
outside the square root. Unlike the JAX functions, these update the
parameters and moments in place (where that keeps the operation order),
rows of a leaf at a time, so a step holds a few f32 temporaries of at most
~``UPDATE_CHUNK`` elements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.params import tree_leaves, tree_map

F32 = torch.float32


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # "float32" | "int8": m is absmax-int8 per last axis, v is bf16 (linear
    # int8 for v crushes small entries to 0 and diverges)
    moments_dtype: str = "float32"


_Q_MIN_SIZE = 4096      # leaves smaller than this stay f32 (norms, biases)


def is_quantized(st) -> bool:
    return isinstance(st, dict) and "q" in st


def _quantize_moment(x32):
    s = x32.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-30
    return {"q": torch.round(x32 / s).to(torch.int8), "s": s}


def encode_moment(x32, like_param, ocfg: OptConfig, kind: str = "m"):
    if (ocfg.moments_dtype == "int8" and like_param.dim() >= 2
            and like_param.numel() >= _Q_MIN_SIZE):
        if kind == "m":
            return _quantize_moment(x32)
        return x32.to(torch.bfloat16)            # v: bf16, never int8
    return x32


def decode_moment(st):
    """The f32 value of a moment leaf: a copy for int8 or bf16 moments, the
    stored tensor itself for f32 ones."""
    if is_quantized(st):
        return st["q"].to(F32) * st["s"]
    return st if st.dtype == F32 else st.to(F32)


def schedule(ocfg: OptConfig, step: int) -> float:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio·lr``
    at ``decay_steps``."""
    warm = step / max(ocfg.warmup_steps, 1)
    prog = min(max((step - ocfg.warmup_steps)
                   / max(ocfg.decay_steps - ocfg.warmup_steps, 1), 0.0), 1.0)
    cos = ocfg.min_lr_ratio + (1 - ocfg.min_lr_ratio) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return ocfg.lr * (warm if step < ocfg.warmup_steps else cos)


def init_moments(params, ocfg: OptConfig | None = None):
    ocfg = ocfg or OptConfig()

    def zero(kind):
        return lambda p: encode_moment(
            torch.zeros(p.shape, dtype=F32, device=p.device), p, ocfg, kind)

    return {"m": tree_map(zero("m"), params),
            "v": tree_map(zero("v"), params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scales every leaf in place by min(1, max_norm / norm) (computed in
    f32, rounded to the leaf's dtype). → (grads, norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, gn


# rows of a leaf that one pass of the update covers: its f32 temporaries
# (the gradient, both moments, the update) stay near 2^26 elements, 256 MB
# each, however large the leaf (deepseek-v2's expert stacks: 1.26 G)
UPDATE_CHUNK = 1 << 26


def _rows(st, sl):
    """The rows ``sl`` of a moment leaf, int8 (q and its row scales) or
    not: views, so stores into them update the leaf."""
    if is_quantized(st):
        return {"q": st["q"][sl], "s": st["s"][sl]}
    return st[sl]


def _store(st, x32) -> None:
    """Write the f32 moment ``x32`` into its leaf (rows) as encoded: int8
    with fresh per-row scales, bf16, or nothing for f32 (``x32`` is the
    leaf, updated in place by :func:`decode_moment`'s caller)."""
    if is_quantized(st):
        q = _quantize_moment(x32)
        st["q"].copy_(q["q"])
        st["s"].copy_(q["s"])
    elif st.dtype != F32:
        st.copy_(x32)


@torch.no_grad()
def adamw_update(params, grads, m, v, step: int, ocfg: OptConfig):
    """One AdamW step; ``step`` is the previous count (0-based). Updates
    ``params`` and the moments in place, a leaf's rows (dim 0) at a time in
    passes of at most ~``UPDATE_CHUNK`` elements (the update is elementwise
    and int8 scales are per row, so the passes change no value).
    → (params, m, v, lr)."""
    lr = schedule(ocfg, step)
    t = step + 1
    bc1 = 1 - ocfg.b1 ** t
    bc2 = 1 - ocfg.b2 ** t

    def upd(p, g, m_st, v_st, decay: bool):
        g32 = g.to(F32)
        m_n = decode_moment(m_st).mul_(ocfg.b1).add_(g32, alpha=1 - ocfg.b1)
        v_n = decode_moment(v_st).mul_(ocfg.b2).add_(
            torch.square(g32).mul_(1 - ocfg.b2))
        del g32
        denom = torch.div(v_n, bc2).sqrt_().add_(ocfg.eps)
        u = torch.div(m_n, bc1).div_(denom)
        del denom
        if decay:                        # decoupled decay on matrices only
            u.add_(p.to(F32) * ocfg.weight_decay)
        if p.dtype == F32:
            p.sub_(u.mul_(lr))
        else:
            p.copy_(p.to(F32).sub_(u.mul_(lr)))
        _store(m_st, m_n)
        _store(v_st, v_n)

    flat_m = tree_leaves(m, is_leaf=is_quantized)
    flat_v = tree_leaves(v, is_leaf=is_quantized)
    for p, g, m_, v_ in zip(tree_leaves(params), tree_leaves(grads), flat_m,
                            flat_v):
        rows = max(1, UPDATE_CHUNK // p[0].numel())
        for r0 in range(0, p.shape[0], rows):
            sl = slice(r0, r0 + rows)
            upd(p[sl], g[sl], _rows(m_, sl), _rows(v_, sl), p.dim() >= 2)
    return params, m, v, lr
