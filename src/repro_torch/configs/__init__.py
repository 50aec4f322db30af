"""Architecture configs (one module per assigned arch) + registry."""
from repro_torch.configs.registry import ALIASES, ARCH_IDS, all_configs, get_config, smoke_config

__all__ = ["ALIASES", "ARCH_IDS", "all_configs", "get_config", "smoke_config"]
