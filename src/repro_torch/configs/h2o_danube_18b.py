"""H2O-Danube 1.8B (arXiv:2401.16818; hf h2oai/h2o-danube-1.8b-base).

Llama architecture + Mistral-style sliding-window attention (4096) on every
layer → bounded KV ⇒ eligible for the long_500k decode cell.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32_000,
    act="swiglu",
    rope_theta=10_000.0,
    sliding_window=4096,
    source="arXiv:2401.16818; hf",
))
