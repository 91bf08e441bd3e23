"""Jamba v0.1 52B (arXiv:2403.19887; hf ai21labs/Jamba-v0.1; copy of
``repro/configs/jamba_v01_52b.py``).

Hybrid Mamba-1 + attention, 1:7 attn:mamba interleave (attention at slot 4
of each 8-layer block), MoE (16 experts, top-2) on every 2nd layer (odd
slots), no positional embeddings (attention relies on mamba for position).
"""
from repro_torch.configs.base import MoECfg, ModelConfig, SSMCfg, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab=65_536,
    act="swiglu",
    use_rope=False,
    moe=MoECfg(n_experts=16, top_k=2, d_expert=14_336, n_shared=0,
               period=2, offset=1, capacity_factor=1.25, aux_weight=1e-2),
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, version=1,
               attn_period=8, attn_offset=4),
    source="arXiv:2403.19887; hf",
))
