"""Config registry: importing this package registers the ported archs."""
from repro_torch.configs.base import (  # noqa: F401
    MLACfg, MoECfg, ModelConfig, SSMCfg, all_configs, get_config, register,
    smoke_config,
)

from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    gemma2_2b,
    h2o_danube_18b,
    internvl2_26b,
    jamba_v01_52b,
    mamba2_130m,
    mistral_nemo_12b,
    nemotron4_15b,
    phi35_moe_42b,
    whisper_large_v3,
)
