"""Model facade for training (``repro/models/model.py``).

``loss_fn(cfg, params, batch)`` → (loss, metrics)
``synth_batch(cfg, batch, seq, generator)`` → a random batch (smoke, tests)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer, whisper


def loss_fn(cfg: ModelConfig, params, batch):
    """Mean next-token cross-entropy over the batch's mask (plus an MoE
    model's load-balancing loss), and metrics (``ce``, ``tokens``,
    ``loss``, and ``moe_aux`` for MoE): the enc-dec loss for an
    encoder-decoder, the LM loss otherwise. Only trainable families
    (:func:`transformer.check_trainable`)."""
    transformer.check_trainable(cfg)
    if cfg.enc_dec:
        return whisper.encdec_loss(cfg, params, batch)
    return transformer.lm_loss(cfg, params, batch)


def synth_batch(cfg: ModelConfig, batch: int, seq: int,
                generator: torch.Generator):
    """A random batch of ``loss_fn``'s structure on the generator's device
    (JAX ``synth_batch``'s shapes; other numbers): uniform tokens/targets
    int64 shifted by one and a mask of ones (f32). An encoder-decoder takes
    ``seq`` stub frames (batch, seq, d_model) of N(0, 0.1²) and
    ``min(max_decoder_len, 32)`` decoder tokens; a front end adds
    ``min(frontend_tokens, seq // 2)`` embeddings (batch, ft, frontend_dim)
    of N(0, 0.1²) and zeroes the mask on those positions."""
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    n = min(cfg.max_decoder_len, 32) if cfg.enc_dec else seq
    tokens = torch.randint(0, cfg.vocab, (batch, n + 1),
                           generator=generator, device=dev)
    out = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
           "mask": torch.ones((batch, n), **f32)}
    if cfg.enc_dec:
        out["frames"] = torch.randn((batch, seq, cfg.d_model),
                                    generator=generator, **f32) * 0.1
    elif cfg.frontend != "none":
        ft = min(cfg.frontend_tokens, seq // 2)
        out["frontend_embed"] = torch.randn(
            (batch, ft, cfg.frontend_dim), generator=generator, **f32) * 0.1
        out["mask"][:, :ft] = 0.0           # no loss on patch positions
    return out
