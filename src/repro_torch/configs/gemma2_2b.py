"""Gemma 2 2B (arXiv:2408.00118; hf google/gemma-2-2b).

Alternating local (window 4096) / global attention, GeGLU, attention logit
softcap 50, final logit softcap 30, sandwich (pre+post) RMSNorms, tied
embeddings scaled by sqrt(d_model), head_dim 256.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256_000,
    act="geglu",
    use_post_norm=True,
    rope_theta=10_000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_period=2,
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2408.00118; hf",
))
