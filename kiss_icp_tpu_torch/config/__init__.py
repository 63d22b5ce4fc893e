from kiss_icp_tpu_torch.config.parser import load_config, write_config
from kiss_icp_tpu_torch.config.schema import (
    AdaptiveThresholdConfig,
    DataConfig,
    EngineConfig,
    KISSConfig,
    MappingConfig,
    RegistrationConfig,
    config_from_dict,
    config_to_dict,
)

__all__ = [
    "AdaptiveThresholdConfig",
    "DataConfig",
    "EngineConfig",
    "KISSConfig",
    "MappingConfig",
    "RegistrationConfig",
    "config_from_dict",
    "config_to_dict",
    "load_config",
    "write_config",
]
