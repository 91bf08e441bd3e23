"""Nemotron-4 15B (arXiv:2402.16819).

GQA (48 q / 8 kv heads), squared-ReLU MLP (no gating), vocab 256k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab=256_000,
    act="relu2",
    rope_theta=10_000.0,
    source="arXiv:2402.16819; unverified",
))
