"""Whisper-style encoder-decoder (``repro/models/whisper.py``), on one
device.

The conv/mel front end is a stub, as in the JAX package: the batch carries
post-conv frame embeddings (B, frames, d_model). The encoder adds fixed
sinusoids and runs non-causal self attention (the flash forward at
``causal=False`` on the card); the decoder adds learned positions
(``dec_pos``) and runs causal self attention, cross attention over the
encoder states (K/V projected per layer, ``attention.cross_kv``) and the
MLP. Norms are RMSNorm, as JAX's. The parameter tree is
``params.param_specs``. ``encdec_loss`` trains it: when a gradient is
wanted each encoder and each decoder layer runs under activation
checkpointing (JAX checkpoints both scan bodies), and the attention
backward is the flash backward (non-causal in the encoder and the cross
attention, whose dK/dV flow back through ``cross_kv`` into the encoder
states).
"""
from __future__ import annotations

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention, cross_attention, cross_kv
from repro_torch.models.layers import chunked_ce_loss, mlp, rmsnorm

F32 = torch.float32


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal positions (length, channels) in f32: sin
    then cos of t · exp(-log(10000) / (channels/2 - 1) · i)."""
    inc = -torch.log(torch.tensor(10000.0, dtype=F32, device=device)) / \
        (channels // 2 - 1)                      # in f32, as JAX's
    scale = torch.exp(inc * torch.arange(channels // 2, dtype=F32,
                                         device=device))
    t = torch.arange(length, dtype=F32, device=device)[:, None] * scale[None]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, Se, D) stub embeddings → encoder states (B, Se, D) in the
    parameter dtype. The frames are cast to it before the sinusoids (cast
    too) are added, in JAX's order."""
    Se = frames.shape[1]
    h = frames.to(cfg.pdtype) + \
        sinusoids(Se, cfg.d_model, frames.device).to(cfg.pdtype)[None]
    positions = torch.arange(Se, device=frames.device)
    for p in params["enc_layers"]:
        h = _layer(_enc_layer, cfg, p, h, positions)
    return rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _layer(fn, cfg, p, h, *args):
    """``fn(cfg, p, h, *args)``, under activation checkpointing when a
    gradient is wanted (non-reentrant, as ``transformer.apply_stack``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, cfg, p, h, *args, use_reentrant=False)
    return fn(cfg, p, h, *args)


def _enc_layer(cfg, p, h, positions):
    x = rmsnorm(h, p["norm1"], cfg.norm_eps)
    h = h + attention(cfg, p["attn"], x, window=0, positions=positions,
                      causal=False)
    x = rmsnorm(h, p["norm2"], cfg.norm_eps)
    return h + mlp(cfg, p["mlp"], x)


def _dec_layer(cfg, p, h, enc_out, positions):
    x = rmsnorm(h, p["norm1"], cfg.norm_eps)
    h = h + attention(cfg, p["self_attn"], x, window=0, positions=positions,
                      causal=True)
    x = rmsnorm(h, p["norm_x"], cfg.norm_eps)
    k, v = cross_kv(cfg, p["cross"], enc_out)
    h = h + cross_attention(cfg, p["cross"], x, k, v)
    x = rmsnorm(h, p["norm2"], cfg.norm_eps)
    return h + mlp(cfg, p["mlp"], x)


def decode_hidden(cfg: ModelConfig, params, tokens: torch.Tensor,
                  enc_out: torch.Tensor) -> torch.Tensor:
    """tokens (B, Td) and encoder states (B, Se, D) → the decoder's final
    hidden states (B, Td, D): the whole decoder sequence at once (the
    forward that ``whisper_decode_step`` is held against)."""
    Td = tokens.shape[1]
    h = params["embed"]["table"][tokens].to(cfg.pdtype) + \
        params["dec_pos"][None, :Td]
    positions = torch.arange(Td, device=tokens.device)
    for p in params["dec_layers"]:
        h = _layer(_dec_layer, cfg, p, h, enc_out, positions)
    return rmsnorm(h, params["dec_norm"], cfg.norm_eps)


def encdec_loss(cfg: ModelConfig, params, batch):
    """batch: frames (B, Se, D), tokens/targets/mask (B, Td) → (loss,
    metrics ``ce``, ``loss``, ``tokens``): the decoder's mean next-token
    cross-entropy over the mask, in chunks of min(512, Td) (JAX
    ``encdec_loss``)."""
    enc_out = encode(cfg, params, batch["frames"])
    h = decode_hidden(cfg, params, batch["tokens"], enc_out)
    sum_l, sum_c = chunked_ce_loss(cfg, params["embed"], params["unembed"],
                                   h, batch["targets"], batch["mask"],
                                   chunk=min(512, batch["tokens"].shape[1]))
    ce = sum_l / torch.clamp(sum_c, min=1.0)
    return ce, {"ce": ce, "loss": ce, "tokens": sum_c}
