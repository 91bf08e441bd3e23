"""InternVL2 26B (arXiv:2404.16821; hf OpenGVLab/InternVL2-26B; copy of
``repro/configs/internvl2_26b.py``).

InternLM2-20B language backbone (48L / d 6144 / 48H GQA kv 8 / ffn 16384 /
vocab 92553). The InternViT-6B vision frontend is a STUB per the assignment:
``input_specs()`` provides 256 precomputed patch embeddings per image
(post pixel-shuffle, pre-MLP-projector, dim 3200) that the model projects
and prepends to the text tokens.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab=92_553,
    act="swiglu",
    rope_theta=10_000.0,
    frontend="vision",
    frontend_tokens=256,
    frontend_dim=3200,
    source="arXiv:2404.16821; hf",
))
