"""Config registry: importing this package registers the ported archs."""
from repro_torch.configs.base import (  # noqa: F401
    MLACfg, MoECfg, ModelConfig, SSMCfg, all_configs, get_config, register,
    smoke_config,
)

from repro_torch.configs import mistral_nemo_12b  # noqa: F401
