"""DeepSeek-V2 236B (arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2).

MoE with Multi-head Latent Attention: kv_lora_rank=512, q_lora_rank=1536,
decoupled rope dim 64, nope dim 128, v dim 128. 160 routed experts (top-6)
+ 2 shared experts, expert hidden 1536; the first layer uses a dense FFN of
hidden 12288 (per the paper / HF config `first_k_dense_replace=1`).
"""
from repro_torch.configs.base import MLACfg, MoECfg, ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: latent KV shared; logical heads = 128
    head_dim=192,            # nope 128 + rope 64 (qk); v_dim 128
    d_ff=1536,               # routed-expert hidden (assignment spec)
    vocab=102_400,
    act="swiglu",
    rope_theta=10_000.0,
    moe=MoECfg(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
               period=1, offset=0, first_dense=1, dense_d_ff=12_288,
               capacity_factor=1.25, aux_weight=3e-3),
    mla=MLACfg(kv_lora=512, q_lora=1536, rope_dim=64, nope_dim=128, v_dim=128),
    source="arXiv:2405.04434; hf",
))
