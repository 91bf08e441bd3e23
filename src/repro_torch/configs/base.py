"""Model configuration (copy of ``repro/configs/base.py`` without JAX).

One :class:`ModelConfig` describes an architecture; ``smoke_config`` is the
family-preserving reduction the CPU tests run. ``param_dtype`` names a torch
dtype through :attr:`ModelConfig.pdtype`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert ffn hidden size
    n_shared: int = 0             # shared (always-on) experts, DeepSeek-style
    period: int = 1               # MoE layer every `period` layers …
    offset: int = 0               # … at slot `offset` within the period
    first_dense: int = 0          # first N layers use a dense FFN instead
    dense_d_ff: int = 0           # hidden size of those dense layers
    capacity_factor: float = 1.25
    aux_weight: float = 1e-3


@dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    q_lora: int = 1536
    rope_dim: int = 64            # decoupled rope key dim (shared across heads)
    nope_dim: int = 128           # per-head no-pos dims
    v_dim: int = 128


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # mamba2 only
    version: int = 2              # 1 (selective scan) | 2 (SSD)
    attn_period: int = 0          # hybrid: one attention layer every N
    attn_offset: int = 0          # slot of the attention layer within the period
    chunk: int = 256              # SSD / selective-scan chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"           # swiglu | geglu | relu2 | gelu
    norm_eps: float = 1e-5
    use_post_norm: bool = False   # gemma2 sandwich norms
    rope_theta: float = 10_000.0
    use_rope: bool = True         # jamba/whisper: no rope
    attn_softcap: float = 0.0     # gemma2: 50
    final_softcap: float = 0.0    # gemma2: 30
    sliding_window: int = 0       # 0 = full attention
    local_global_period: int = 0  # gemma2: 2 → alternate sliding/full
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str = "none"        # none | vision | audio  (stub embeddings)
    frontend_tokens: int = 0      # vlm: patch tokens prepended to the text
    frontend_dim: int = 0         # stub embedding dim (pre-projection)
    max_decoder_len: int = 448    # whisper decoder context
    tie_embeddings: bool = False
    embed_scale: bool = False     # gemma: multiply embeddings by sqrt(d)
    attn_chunk: int = 512         # online-softmax KV/Q chunk (XLA path)
    param_dtype: str = "bfloat16"
    source: str = ""              # provenance note

    # -- derived ---------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def is_attn_layer(self, i: int) -> bool:
        if self.ssm is None:
            return True
        if self.ssm.attn_period == 0:
            return False                      # pure SSM
        return i % self.ssm.attn_period == self.ssm.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.first_dense:
            return False
        return i % self.moe.period == self.moe.offset

    def window_for_layer(self, i: int) -> int:
        """0 = full attention; >0 = sliding window size."""
        if self.sliding_window and self.local_global_period:
            return self.sliding_window if i % self.local_global_period == 0 else 0
        return self.sliding_window


# ---------------------------------------------------------------- registry
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    import repro_torch.configs  # noqa: F401
    return dict(_REGISTRY)


# ---------------------------------------------------------- smoke reduction
def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduction that runs a real CPU step in <~seconds."""
    period = 1
    if cfg.local_global_period:
        period = max(period, cfg.local_global_period)
    if cfg.ssm and cfg.ssm.attn_period:
        period = max(period, cfg.ssm.attn_period)
    if cfg.moe:
        period = max(period, cfg.moe.period)
        period = max(period, cfg.moe.first_dense + cfg.moe.period)
    n_layers = max(2, period)

    moe = None
    if cfg.moe:
        moe = replace(cfg.moe, n_experts=min(8, cfg.moe.n_experts),
                      top_k=min(2, cfg.moe.top_k), d_expert=64,
                      n_shared=min(1, cfg.moe.n_shared),
                      dense_d_ff=128 if cfg.moe.dense_d_ff else 0)
    mla = None
    if cfg.mla:
        mla = MLACfg(kv_lora=32, q_lora=48, rope_dim=8, nope_dim=16, v_dim=16)
    ssm = None
    if cfg.ssm:
        ssm = replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)

    n_heads = 4
    n_kv = max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads < cfg.n_heads else n_heads
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        n_enc_layers=2 if cfg.enc_dec else 0,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        moe=moe, mla=mla, ssm=ssm,
        sliding_window=32 if cfg.sliding_window else 0,
        frontend_tokens=8 if cfg.frontend_tokens else 0,
        frontend_dim=32 if cfg.frontend_dim else 0,
        max_decoder_len=16 if cfg.enc_dec else cfg.max_decoder_len,
        attn_chunk=16,
    )
