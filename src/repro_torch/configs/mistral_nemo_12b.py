"""Mistral-NeMo 12B (hf:mistralai/Mistral-Nemo-Base-2407).

128k context (rope theta 1e6), head_dim 128 (explicit, ≠ d_model/n_heads).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab=131_072,
    act="swiglu",
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407; hf",
))
