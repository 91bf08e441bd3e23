"""Config registry: importing this package registers the ported archs."""
from repro_torch.configs.base import (  # noqa: F401
    MLACfg, MoECfg, ModelConfig, SSMCfg, all_configs, get_config, register,
    smoke_config,
)

from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    mamba2_130m,
    mistral_nemo_12b,
    phi35_moe_42b,
)
