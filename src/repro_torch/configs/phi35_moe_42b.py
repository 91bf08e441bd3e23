"""Phi-3.5-MoE 42B (A6.6B) — hf:microsoft/Phi-3.5-MoE-instruct.

16 experts, top-2 routing, GQA with 8 KV heads, expert hidden 6400.
"""
from repro_torch.configs.base import MoECfg, ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32_064,
    act="swiglu",
    rope_theta=10_000.0,
    moe=MoECfg(n_experts=16, top_k=2, d_expert=6400, n_shared=0,
               period=1, offset=0, capacity_factor=1.25, aux_weight=1e-2),
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
))
