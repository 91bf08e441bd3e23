"""Mamba2 130M (arXiv:2405.21060 — state-space duality / SSD; copy of
``repro/configs/mamba2_130m.py``).

Attention-free: 24 pure SSD mixer blocks (no FFN, d_ff=0), d_inner=1536
(expand 2), ssm_state=128, head_dim 64 → 24 SSD heads, conv kernel 4.
"""
from repro_torch.configs.base import ModelConfig, SSMCfg, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50_280,
    use_rope=False,
    ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, version=2),
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
))
