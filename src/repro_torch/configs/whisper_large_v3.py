"""Whisper large-v3 (arXiv:2212.04356; hf openai/whisper-large-v3; copy of
``repro/configs/whisper_large_v3.py``).

Encoder-decoder, 32+32 layers, d 1280, 20 MHA heads, ffn 5120, vocab 51866,
GELU, learned/sinusoidal positions (no rope). The conv1d mel frontend is a
STUB per the assignment: ``input_specs()`` provides post-conv frame
embeddings (B, frames, 1280). Shape semantics (DESIGN.md §4): seq_len is the
encoder frame count; decode cells run one decoder step against a cross-KV of
that length with a self-KV of max_decoder_len=448.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,            # decoder layers
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51_866,
    act="gelu",
    use_rope=False,
    enc_dec=True,
    tie_embeddings=True,
    frontend="audio",
    frontend_dim=1280,
    max_decoder_len=448,
    source="arXiv:2212.04356; unverified",
))
