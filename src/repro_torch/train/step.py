"""The training step: forward + backward → clip → (compress) → AdamW
(``repro/train/step.py``).

State is a plain dict: params / m / v / step (+ ef), with ``step`` a Python
int. ``make_train_step``'s function updates the state's tensors in place
and returns the same dict with the new step. The JAX package's mesh
arguments (``ctx``, ``mctx`` for ZeRO-2) and ``abstract_state`` wait for
the multi-GPU port.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.models.transformer import check_trainable
from repro_torch.params import init_params, tree_leaves, tree_map
from repro_torch.train.compression import (CompressionConfig,
                                           compress_decompress,
                                           init_residuals)
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         clip_by_global_norm, init_moments)

F32 = torch.float32


def make_state(params, ocfg: OptConfig | None = None,
               ccfg: CompressionConfig | None = None):
    """A step-0 state around ``params``: float leaves are marked to want a
    gradient, moments and (when compressing) residuals are zeros."""
    for p in tree_leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    mom = init_moments(params, ocfg)
    state = {"params": params, "m": mom["m"], "v": mom["v"], "step": 0}
    if ccfg and ccfg.kind != "none":
        state["ef"] = init_residuals(params)
    return state


def init_state(cfg: ModelConfig, seed: int = 0,
               ccfg: CompressionConfig | None = None,
               ocfg: OptConfig | None = None, device=None):
    """Seeded parameters made on ``device`` (the card unless
    ``device="cpu"``) and their step-0 state."""
    check_trainable(cfg)
    return make_state(init_params(cfg, seed, device), ocfg, ccfg)


def make_train_step(cfg: ModelConfig, ocfg: OptConfig,
                    ccfg: CompressionConfig | None = None,
                    microbatches: int = 1, accum_dtype=F32):
    """``microbatches > 1`` accumulates the gradient over equal slices of
    the batch in ``accum_dtype`` (activations shrink ~linearly) and divides
    by their count; the metrics are the slices' means."""
    check_trainable(cfg)
    ccfg = ccfg or CompressionConfig()

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        loss, metrics = loss_fn(cfg, params, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
        return tree_map(lambda _: next(grads), params), \
            {k: v.detach() for k, v in metrics.items()}

    def accumulate(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"batch of {n} does not split into "
                             f"{microbatches} microbatches")
        size = n // microbatches
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                             device=p.device), params)
        ms = []
        for i in range(microbatches):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            g, metrics = grads_of(params, mb)
            for a, x in zip(tree_leaves(acc), tree_leaves(g)):
                a.add_(x)
            ms.append(metrics)
            del g
        grads = tree_map(lambda a, p: (a / microbatches).to(p.dtype), acc,
                         params)
        return grads, {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}

    def train_step(state, batch):
        grads, metrics = accumulate(state["params"], batch)
        grads, gn = clip_by_global_norm(grads, ocfg.clip_norm)
        if ccfg.kind != "none":
            grads, state["ef"] = compress_decompress(grads, state["ef"],
                                                     ccfg)
        p, m, v, lr = adamw_update(state["params"], grads, state["m"],
                                   state["v"], state["step"], ocfg)
        state.update(params=p, m=m, v=v, step=state["step"] + 1)
        return state, dict(metrics, grad_norm=gn, lr=lr)

    return train_step
