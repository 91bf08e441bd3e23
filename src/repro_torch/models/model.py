"""Model facade for training (``repro/models/model.py``).

``loss_fn(cfg, params, batch)`` → (loss, metrics)
``synth_batch(cfg, batch, seq, generator)`` → a random batch (smoke, tests)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def loss_fn(cfg: ModelConfig, params, batch):
    """Mean next-token cross-entropy over the batch's mask (plus an MoE
    model's load-balancing loss), and metrics (``ce``, ``tokens``,
    ``loss``, and ``moe_aux`` for MoE). Only trainable families
    (:func:`transformer.check_trainable`)."""
    transformer.check_trainable(cfg)
    return transformer.lm_loss(cfg, params, batch)


def synth_batch(cfg: ModelConfig, batch: int, seq: int,
                generator: torch.Generator):
    """Uniform random tokens on the generator's device: tokens/targets
    (batch, seq) int64 shifted by one, mask of ones (f32)."""
    dev = generator.device
    tokens = torch.randint(0, cfg.vocab, (batch, seq + 1),
                           generator=generator, device=dev)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
            "mask": torch.ones((batch, seq), dtype=torch.float32,
                               device=dev)}
