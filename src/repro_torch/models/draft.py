"""Big/little draft models for speculative decoding
(``repro/models/draft.py``).

Speculative decoding needs a *draft* model that shares the target's vocab,
costs far less per step, and agrees with the target often enough that
verification accepts long prefixes. Layer truncation gives such a pair
without training: the draft is the target's first ``n_layers`` layers plus
the target's own embed, final norm and unembed.

The port keeps its layers as a list (``params["layers"]``), so
``draft_from_target`` takes the list's first ``n_layers`` entries and
shares their tensors (JAX slices its stacked leaves). ``soften_deep_layers``
damps the residual contributions of the deep layers (what the draft lacks)
by scaling their output projections, which raises draft/target agreement
to a high-but-imperfect rate. Both need a uniform layer stack (one block
kind at every depth): truncating a periodic or hybrid schedule would change
which block sits at each depth, so they refuse.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import layer_schedule


def _uniform_stack(cfg: ModelConfig):
    """The single segment of a uniform decoder, or raise."""
    if cfg.enc_dec:
        raise ValueError(f"{cfg.name}: draft truncation is decoder-only")
    segs = layer_schedule(cfg)
    if len(segs) != 1 or len(segs[0].pattern) != 1:
        raise ValueError(
            f"{cfg.name}: draft truncation needs a uniform layer stack "
            f"(got {len(segs)} segments); build the draft params explicitly "
            "for periodic/hybrid schedules")
    return segs[0]


def draft_from_target(cfg: ModelConfig, params, n_layers: int,
                      *, name: str | None = None):
    """(draft_cfg, draft_params): the target's first ``n_layers`` layers.

    The draft shares the target's tensors (its layers, embed table, final
    norm and unembed are the same tensors, not copies), so the pair is
    vocab-aligned by construction, as ``Engine(draft_cfg=...)`` requires.
    """
    seg = _uniform_stack(cfg)
    if not 1 <= n_layers < cfg.n_layers:
        raise ValueError(f"draft n_layers {n_layers} must be in "
                         f"[1, {cfg.n_layers})")
    draft_cfg = dataclasses.replace(
        cfg, name=name or f"{cfg.name}-draft{n_layers}", n_layers=n_layers)
    dsegs = layer_schedule(draft_cfg)
    if len(dsegs) != 1 or dsegs[0].pattern != seg.pattern:
        raise ValueError(f"{cfg.name}: truncated schedule is not a prefix "
                         "of the target schedule")
    dparams = {"embed": params["embed"],
               "layers": list(params["layers"][:n_layers]),
               "final_norm": params["final_norm"],
               "unembed": params["unembed"]}
    return draft_cfg, dparams


def soften_deep_layers(cfg: ModelConfig, params, n_keep: int,
                       alpha: float = 0.25):
    """Scale the residual output projections of layers >= ``n_keep``.

    Every block writes into the residual stream through two projections,
    the attention output ``wo`` and the MLP ``w_down``; scaling those by
    ``alpha`` damps the deep layers' contribution without touching their
    inputs. Returns a new parameter tree that shares every other tensor;
    the scaled ones are new (rounded through f32, as JAX's), and the input
    is unchanged.
    """
    _uniform_stack(cfg)
    if not 0 < n_keep <= cfg.n_layers:
        raise ValueError(f"n_keep {n_keep} out of range")

    def scale(tree):
        out = {}
        for key, x in tree.items():
            if isinstance(x, dict):
                out[key] = scale(x)
            elif key in ("wo", "w_down"):
                out[key] = (x.to(torch.float32) * alpha).to(x.dtype)
            else:
                out[key] = x
        return out

    layers = [layer if i < n_keep else scale(layer)
              for i, layer in enumerate(params["layers"])]
    return {**params, "layers": layers}
